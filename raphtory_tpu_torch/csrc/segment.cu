// K7 — the masked segment combine of the generic superstep engine.
//
// Replaces raphtory_tpu/ops/segment.py:35 `segment_combine` on the route
// the superstep runner takes off the TPU (engine/bsp.py:145,152,154: the
// per-window degrees and the message combine at each destination or, for
// the reverse direction, each source). For k windows laid out flat
// (window-major, window w's edges at w*m .. w*m+m-1):
//
//     out[w, r, f] = op over e in the CSR run of r of
//                    (mask[w*m + e] ? x[(w*m + e), f] : neutral)
//
// with op in {sum, min, max} and neutral 0 / the type's max (+inf) / the
// type's min (-inf), for float32, int32 and int64 payloads (int64: the
// taint times of TaintTracking, min-combined, INT64_MAX the neutral).
// Empty and fully masked runs give the neutral value, as the reference's
// masked segment ops do.
//
// The reference scatters each edge's payload into its segment. Here the
// edges of a row are found through a CSR over the REAL edges: the
// destination direction walks `indptr` over the (dst, src)-sorted edges
// (perm = null, the edge itself), the source direction walks the source-
// ordered index (`perm[j]` = engine position of the j-th edge in source
// order). Pad edges lie outside both CSRs; they are masked in every window
// anyway.
//
// K7-P `rtpu_partition_reduce` — the destination-binned (PCPM) combine,
// raphtory_tpu/ops/segment.py:116 `partition_segment_reduce` as the
// superstep runner calls it (engine/bsp.py:127-141): each window's
// per-edge payload is read through the layout permutation and its mask
// through perm & valid, and every destination partition reduces into its
// own dense n_per-row block (rows p*n_per .. (p+1)*n_per-1), the blocks
// sliced to the first n rows:
//
//     out[w, r, f] = op over j in [indptr[r], indptr[r+1]) of
//                    (valid[s] && mask[w*m + perm[s]] ?
//                     x[(w*m + perm[s]), f] : neutral),   s = order[j]
//
// `indptr`/`order` is the layout's destination walk (each row's real slots
// in source order); perm null: slot s is payload row s; valid null: every
// slot real. K7 is the same walk with order = its CSR's perm (or the entry
// itself), so one kernel serves both (`combine_kernel`).
//
// What bounds them on the H100: bytes — the walk (indptr, order, perm,
// valid) read once, the mask and payload of every real entry once per
// window, the output written once; one operation per masked entry.
//   Design. (1) Windows: the grid's y index is (window group, feature), no
// 64-bit division anywhere; past 65,535 grid rows the C entry launches
// again for each further group of 65,535 rows (a y offset the kernel adds
// to blockIdx.y), so a call of any F * k returns one output and a call
// under the limit is one launch. Where k <= 3 and the k * n (window, row) pairs reach
// 2^20 (the taint shape's 3 x 2^21), one walk serves all k windows, a
// thread keeping k accumulators; below that (the 32,768-row GAB and
// Bitcoin tables) a thread takes one window, since there the card is short
// of threads, not of bytes (on the H100 one walk for 3 windows was the
// slower there and the faster at the taint shape). (2) Short rows (runs of
// at most 32 entries): a thread a row, neighbouring threads on
// neighbouring rows (whose runs lie next to each other in the walk), 8
// entries in flight (2 for a walk of 3 windows), each stage (walk, mask,
// payload) issued for all of them before the next; the destination CSR is
// its own instantiation (the DIRECT walk, entry j payload row j). (3) Long rows (more than 32
// entries, listed once per walk by the wrapper, longest first: Bitcoin's
// Pareto senders run to 4,119) take the launch's first blocks, a block a
// row, 1,024 entries at a time, 4 a thread in flight, neighbouring threads
// on neighbouring entries. (4) Order: every row combines in walk order
// with __fadd_rn for floats — a short row in its thread; a long row's
// float values are staged in shared memory and thread w combines window
// w's in order — so f32 sums are bitwise a sequential walk's (the CPU
// twins and the reference add in that order) and a min or max of +0 and
// -0 keeps the first, as the sequential walk does. Integer sums (two's
// complement, wrapping), mins and maxes are exact in any order: a long
// row's integers combine in registers, then across the block. Empty and
// fully masked rows give the neutral value; no atomics, so the result is
// deterministic.

// K7-mode `rtpu_segment_mode` — raphtory_tpu/ops/segment.py:155
// `segment_mode`, the custom-combiner exchange of LabelPropagation: for each
// (window w, row r) the most frequent value among
//
//     { x[w*m + e] : e in the CSR run of r, mask[w*m + e], x >= 0 }
//
// ties to the smallest value, `dflt` where the set is empty. The reference
// sorts packed (segment << 31 | value) keys over all k*m rows; here each
// inbox is already one CSR run (the destination direction walks `indptr`,
// the source direction `perm`), so no global sort is needed. The window is
// blockIdx.y plus the launch's y offset (no division; past 65,535 windows
// the C entry launches once a group of 65,535). The blocks along x come in
// two kinds, in one launch:
//   * the first `nl` blocks take the long rows (runs of more than 32
//     entries), one a block, from the list `long_rows` the wrapper builds
//     once per CSR: the run's valid values (invalid ones as -1) are copied
//     into shared memory (runs of <= kSmemRows) or into their disjoint
//     slice of the global `scratch` (w*m + indptr[r] .., longer runs;
//     allocated only when the list holds one), sorted with an all-ascending
//     bitonic network (a partner past the run's end is a virtual +inf and is
//     skipped), and each run start of the sorted values finds its run's end
//     by binary search; a block max of (count << 32 | 2^31-1 - value) picks
//     the largest count, then the smallest value;
//   * the rest take the short rows, a warp kTileRows consecutive rows: the
//     rows' runs (a long row counts as empty; an empty row gets `dflt` at
//     once) are packed end to end over the warp's 32 lanes, a lane an entry,
//     so a row's lane group is exactly as wide as its inbox and one warp
//     carries several rows; a round takes the rows that fit, each lane
//     finds its row by a binary search over the running sums (shuffles),
//     __match_any_sync over the full warp ANDed with the row's lane mask
//     counts its value inside its own group, and a segmented shuffle max of
//     the same key leaves the pick in the group's first lane. Runs of one
//     round lie next to each other in the CSR, so (perm null) a round reads
//     neighbouring values. No short row waits on a sort.
// Every candidate is an integer and the pick does not depend on the order
// of the rows, so the result is exact and equals the reference's bit for
// bit; nothing is truncated, whatever the run's length. Bound: bytes — the
// values and mask of every real row once per window, the CSR once, the
// output once; a long run costs O(L log^2 L) compare-exchanges in one
// block (the GAB and LDBC inboxes are short: median 8, at most a few above
// 32).
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/segment.py).
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Lim;
template <> struct Lim<float> {
    __device__ static float hi() { return __int_as_float(0x7f800000); }
    __device__ static float lo() { return __int_as_float(0xff800000); }
    __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Lim<int32_t> {
    __device__ static int32_t hi() { return INT32_MAX; }
    __device__ static int32_t lo() { return INT32_MIN; }
    __device__ static int32_t add(int32_t a, int32_t b) {
        return (int32_t)((uint32_t)a + (uint32_t)b);
    }
};
// TaintTracking's exchange: int64 taint times, IMAX = INT64_MAX the
// "clean" value. The sum wraps as two's complement, as torch's does.
template <> struct Lim<int64_t> {
    __device__ static int64_t hi() { return INT64_MAX; }
    __device__ static int64_t lo() { return INT64_MIN; }
    __device__ static int64_t add(int64_t a, int64_t b) {
        return (int64_t)((uint64_t)a + (uint64_t)b);
    }
};

template <typename T, int OP>
__device__ __forceinline__ T neutral() {
    if (OP == kSum) return T(0);
    if (OP == kMin) return Lim<T>::hi();
    return Lim<T>::lo();
}

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
    if (OP == kSum) return Lim<T>::add(a, b);
    if (OP == kMin) return b < a ? b : a;
    return b > a ? b : a;
}

// floats keep the walk order in every op (a sum is not associative, and
// a min or max of +0 and -0 keeps the first); integers combine in any order
template <typename T> struct InOrder { static constexpr bool v = false; };
template <> struct InOrder<float> { static constexpr bool v = true; };

constexpr int kMaxWin = 3;         // most windows one walk serves
constexpr int kShortRun = 32;      // longest run the short-row path takes
constexpr int kLongBatch = 4;      // entries a long-row thread keeps in flight
constexpr int kLongChunk = kThreads * kLongBatch;   // entries a block stages
// (window, row) pairs from which one walk serves all k windows: below it a
// thread takes one window, so that the card has threads enough
constexpr int64_t kWalkOnceRows = int64_t(1) << 20;
// entries a short-row thread keeps in flight: 8, 2 where it serves 3
// windows (their values in registers; at the taint shape 2 in flight ran
// faster than 4 or 8)
template <int KW> struct ShortBatch {
    static constexpr int v = KW == 3 ? 2 : 8;
};

// Where walk entry j's payload lies: slot s = order[j] (order null: j),
// counted only where valid[s] (valid null: every slot), payload row
// perm[s] (perm null: s). K7 is the walk with order = its CSR's perm; the
// destination CSR (all three null) is the DIRECT walk, entry j payload row
// j, which the kernels take as its own instantiation: its addresses are a
// base and small offsets, so every load of a batch issues before any use.
struct Walk {
    const int64_t* indptr;
    const int32_t* order;
    const int32_t* perm;
    const uint8_t* valid;
};

// Entries q0 + q*stride (q < N) of a run of L entries from j0, read in
// stages, each issued for all N before the next: in[q] whether the entry
// counts (inside the run, its slot real), e[q] its payload row; then the
// masks on[w][q] of windows w0 .. w0+KW-1 (mk = mask + w0*m), then the
// payloads v[w][q] where the mask is set (xw = x + w0*m*F + f; F == 1, the
// programs' scalar messages, takes its own loads, a base and an offset).
template <typename T, int KW, bool DIRECT, int N>
__device__ __forceinline__ void load_entries(
        const Walk& wk, int64_t j0, int64_t L, int64_t q0, int stride,
        int64_t m, int64_t F, const uint8_t* __restrict__ mk,
        const T* __restrict__ xw, uint8_t (*on)[N], T (*v)[N]) {
    bool in[N];
    int64_t e[N];
#pragma unroll
    for (int q = 0; q < N; ++q) {
        in[q] = q0 + q * stride < L;
        e[q] = j0 + q0 + q * stride;
    }
    if constexpr (!DIRECT) {
        if (wk.order) {
#pragma unroll
            for (int q = 0; q < N; ++q)
                e[q] = in[q] ? (int64_t)wk.order[e[q]] : 0;
        }
        if (wk.valid) {
#pragma unroll
            for (int q = 0; q < N; ++q)
                in[q] = in[q] && wk.valid[e[q]];
        }
        if (wk.perm) {
#pragma unroll
            for (int q = 0; q < N; ++q)
                e[q] = in[q] ? (int64_t)wk.perm[e[q]] : 0;
        }
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) {
#pragma unroll
        for (int q = 0; q < N; ++q)
            on[w][q] = in[q] ? mk[w * m + e[q]] : 0;
    }
    if (F == 1) {
#pragma unroll
        for (int w = 0; w < KW; ++w) {
#pragma unroll
            for (int q = 0; q < N; ++q)
                v[w][q] = on[w][q] ? xw[w * m + e[q]] : T(0);
        }
    } else {
#pragma unroll
        for (int w = 0; w < KW; ++w) {
#pragma unroll
            for (int q = 0; q < N; ++q)
                v[w][q] = on[w][q] ? xw[(w * m + e[q]) * F] : T(0);
        }
    }
}

// A short row r (at most kShortRun entries) of feature f, windows w0 ..
// w0+KW-1, by one thread: its run read N entries at a time and combined
// into the KW accumulators in walk order, whatever the op and type.
// Neighbouring threads take neighbouring rows, whose runs lie next to
// each other in the walk. A long row is left to its block.
template <typename T, int OP, int KW, bool DIRECT>
__device__ void combine_short(int64_t r, int64_t n, int64_t m,
                              int64_t F, int64_t f, int64_t w0,
                              const Walk& wk, const T* __restrict__ x,
                              const uint8_t* __restrict__ mask,
                              T* __restrict__ out) {
    constexpr int N = ShortBatch<KW>::v;
    const int64_t j0 = wk.indptr[r], L = wk.indptr[r + 1] - j0;
    if (L > kShortRun) return;
    const uint8_t* mk = mask + w0 * m;
    const T* xw = x + w0 * m * F + f;
    T acc[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) acc[w] = neutral<T, OP>();
    for (int64_t c = 0; c < L; c += N) {
        uint8_t on[KW][N];
        T v[KW][N];
        load_entries<T, KW, DIRECT, N>(wk, j0, L, c, 1, m, F, mk, xw, on, v);
#pragma unroll
        for (int q = 0; q < N; ++q) {
#pragma unroll
            for (int w = 0; w < KW; ++w)
                if (on[w][q]) acc[w] = combine<T, OP>(acc[w], v[w][q]);
        }
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) out[((w0 + w) * n + r) * F + f] = acc[w];
}

// A long row r (more than kShortRun entries) of feature f, windows w0 ..
// w0+KW-1, by the whole block, kLongChunk entries at a time: thread t
// takes entries t, t + 256, .. of the chunk (neighbouring threads on
// neighbouring entries), kLongBatch of them in flight. Integers combine in
// registers and across the block in any order (exact). Floats stage the
// chunk's values and mask bytes in shared memory and thread w then
// combines window w's in walk order.
template <typename T, int OP, int KW, bool DIRECT>
__device__ void combine_long(int64_t r, int64_t n, int64_t m,
                             int64_t F, int64_t f, int64_t w0,
                             const Walk& wk, const T* __restrict__ x,
                             const uint8_t* __restrict__ mask,
                             T* __restrict__ out, T* s_v, uint8_t* s_on,
                             T* s_part) {
    constexpr int N = kLongBatch;
    const int t = threadIdx.x;
    const int64_t j0 = wk.indptr[r], L = wk.indptr[r + 1] - j0;
    const uint8_t* mk = mask + w0 * m;
    const T* xw = x + w0 * m * F + f;
    T acc[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) acc[w] = neutral<T, OP>();
    for (int64_t c0 = 0; c0 < L; c0 += kLongChunk) {
        uint8_t on[KW][N];
        T v[KW][N];
        load_entries<T, KW, DIRECT, N>(wk, j0, L, c0 + t, kThreads, m, F,
                                       mk, xw, on, v);
        if constexpr (InOrder<T>::v) {
#pragma unroll
            for (int w = 0; w < KW; ++w) {
#pragma unroll
                for (int q = 0; q < N; ++q) {
                    s_on[w * kLongChunk + t + kThreads * q] = on[w][q];
                    s_v[w * kLongChunk + t + kThreads * q] = v[w][q];
                }
            }
            __syncthreads();
            if (t < KW) {
                const int cl = L - c0 < kLongChunk ? (int)(L - c0)
                                                   : kLongChunk;
                const uint8_t* so = s_on + t * kLongChunk;
                const T* sv = s_v + t * kLongChunk;
#pragma unroll 8
                for (int q = 0; q < cl; ++q)
                    if (so[q]) acc[0] = combine<T, OP>(acc[0], sv[q]);
            }
            __syncthreads();
        } else {
#pragma unroll
            for (int w = 0; w < KW; ++w) {
#pragma unroll
                for (int q = 0; q < N; ++q)
                    if (on[w][q]) acc[w] = combine<T, OP>(acc[w], v[w][q]);
            }
        }
    }
    if constexpr (InOrder<T>::v) {
        if (t < KW) out[((w0 + t) * n + r) * F + f] = acc[0];
    } else {
        const int warp = t >> 5, lane = t & 31;
#pragma unroll
        for (int w = 0; w < KW; ++w) {
            for (int o = 16; o > 0; o >>= 1)
                acc[w] = combine<T, OP>(acc[w],
                                       __shfl_xor_sync(kAll, acc[w], o));
            if (lane == 0) s_part[warp * KW + w] = acc[w];
        }
        __syncthreads();
        if (t < KW) {
            T b = neutral<T, OP>();
            for (int i = 0; i < kThreads / 32; ++i)
                b = combine<T, OP>(b, s_part[i * KW + t]);
            out[((w0 + t) * n + r) * F + f] = b;
        }
    }
}

// K7 and K7-P: grid row y = blockIdx.y + y0 is (window group, feature) —
// group g serves windows g*KW .. g*KW+KW-1, KW dividing k — so no 64-bit
// division; along
// x the first `nl` blocks take the long rows (longest first, from the
// plan), the rest kThreads consecutive rows each, a thread a row.
template <typename T, int OP, int KW, bool DIRECT>
__global__ void __launch_bounds__(kThreads) combine_kernel(
        int64_t n, int64_t m, int64_t F, int64_t nl, unsigned y0, Walk wk,
        const int32_t* __restrict__ long_rows, const T* __restrict__ x,
        const uint8_t* __restrict__ mask, T* __restrict__ out) {
    constexpr int kStage = InOrder<T>::v ? KW * kLongChunk : 1;
    __shared__ T s_v[kStage];
    __shared__ uint8_t s_on[kStage];
    __shared__ T s_part[kThreads / 32 * KW];
    const unsigned Fu = (unsigned)F, y = blockIdx.y + y0;
    const int64_t f = y % Fu;
    const int64_t w0 = (int64_t)(y / Fu) * KW;
    if (blockIdx.x < nl) {                      // block-uniform
        combine_long<T, OP, KW, DIRECT>(long_rows[blockIdx.x], n, m, F, f,
                                        w0, wk, x, mask, out, s_v, s_on,
                                        s_part);
        return;
    }
    const int64_t r = (int64_t)(blockIdx.x - nl) * kThreads + threadIdx.x;
    if (r < n)
        combine_short<T, OP, KW, DIRECT>(r, n, m, F, f, w0, wk, x, mask,
                                         out);
}

template <typename T, int OP, int KW>
void launch_op(dim3 grid, int64_t n, int64_t m, int64_t F, int64_t nl,
               unsigned y0, const Walk& wk, const int32_t* long_rows,
               const T* x, const uint8_t* mask, T* out, cudaStream_t s) {
    if (!wk.order && !wk.perm && !wk.valid)
        combine_kernel<T, OP, KW, true><<<grid, kThreads, 0, s>>>(
            n, m, F, nl, y0, wk, long_rows, x, mask, out);
    else
        combine_kernel<T, OP, KW, false><<<grid, kThreads, 0, s>>>(
            n, m, F, nl, y0, wk, long_rows, x, mask, out);
}

template <typename T, int KW>
void launch_kw(int op, dim3 grid, int64_t n, int64_t m, int64_t F,
               int64_t nl, unsigned y0, const Walk& wk,
               const int32_t* long_rows, const T* x, const uint8_t* mask,
               T* out, cudaStream_t s) {
    if (op == kSum)
        launch_op<T, kSum, KW>(grid, n, m, F, nl, y0, wk, long_rows, x, mask,
                               out, s);
    else if (op == kMin)
        launch_op<T, kMin, KW>(grid, n, m, F, nl, y0, wk, long_rows, x, mask,
                               out, s);
    else
        launch_op<T, kMax, KW>(grid, n, m, F, nl, y0, wk, long_rows, x, mask,
                               out, s);
}

// most grid rows of one launch (gridDim.y)
constexpr int64_t kGridRows = 65535;

// One walk serves all k windows (KW = k) where k <= 3 and the k*n (window,
// row) pairs are many enough to fill the card; else a thread a window. The
// F * k / KW grid rows go in launches of at most kGridRows, each with its
// y offset; *launched counts them.
template <typename T>
int launch_combine(int op, int64_t k, int64_t n, int64_t m, int64_t F,
                   int64_t nl, const Walk& wk, const int32_t* long_rows,
                   const void* x, const uint8_t* mask, void* out,
                   cudaStream_t s, int64_t* launched) {
    const int KW = k <= kMaxWin && k * n >= kWalkOnceRows ? (int)k : 1;
    const int64_t gy = F * (k / KW);
    const int64_t gx = nl + (n + kThreads - 1) / kThreads;
    if (gy >= (int64_t(1) << 32) || gx >= (int64_t(1) << 31))
        return (int)cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    for (int64_t y0 = 0; y0 < gy; y0 += kGridRows) {
        const int64_t rows = gy - y0 < kGridRows ? gy - y0 : kGridRows;
        const dim3 grid((unsigned)gx, (unsigned)rows);
        const unsigned yo = (unsigned)y0;
        if (KW == 1)
            launch_kw<T, 1>(op, grid, n, m, F, nl, yo, wk, long_rows, xt,
                            mask, ot, s);
        else if (KW == 2)
            launch_kw<T, 2>(op, grid, n, m, F, nl, yo, wk, long_rows, xt,
                            mask, ot, s);
        else
            launch_kw<T, 3>(op, grid, n, m, F, nl, yo, wk, long_rows, xt,
                            mask, ot, s);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        ++*launched;
    }
    return (int)cudaSuccess;
}

int combine_entry(int64_t k, int64_t n, int64_t m, int64_t F, int64_t op,
                  int64_t dtype, int64_t nl, const Walk& wk,
                  const void* long_rows, const void* x, const void* mask,
                  void* out, void* stream, int64_t* launched) {
    *launched = 0;
    if (k * n * F == 0) return (int)cudaGetLastError();
    if (op < 0 || op > 2 || dtype < 0 || dtype > 2 || nl < 0 || nl > n)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* lr = static_cast<const int32_t*>(long_rows);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    if (dtype == 0)
        return launch_combine<float>((int)op, k, n, m, F, nl, wk, lr, x, mk,
                                     out, s, launched);
    if (dtype == 1)
        return launch_combine<int32_t>((int)op, k, n, m, F, nl, wk, lr, x,
                                       mk, out, s, launched);
    return launch_combine<int64_t>((int)op, k, n, m, F, nl, wk, lr, x, mk,
                                   out, s, launched);
}

constexpr int kModeThreads = 256;      // a block: 8 warps
constexpr int kTileRows = 16;          // short rows a warp takes
constexpr int kSmemRows = 4096;        // longest run sorted in shared memory

__device__ inline unsigned long long mode_key(int v, int count) {
    // largest count first, then the smallest value; 0 = no candidate
    return v < 0 ? 0ull
                 : ((unsigned long long)count << 32)
                       | (unsigned long long)(0x7fffffff - v);
}

__device__ inline int mode_value(unsigned long long key, int dflt) {
    return key ? 0x7fffffff - (int)(key & 0xffffffffull) : dflt;
}

__device__ inline unsigned long long warp_max(unsigned long long x) {
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long y = __shfl_xor_sync(kAll, x, o);
        x = y > x ? y : x;
    }
    return x;
}

// All-ascending bitonic sort of a[0..L) by the block (virtual +inf past L).
__device__ void block_sort(int* a, int64_t L) {
    int64_t Lp = 1;
    while (Lp < L) Lp <<= 1;
    const int64_t half = Lp >> 1;
    for (int64_t kk = 2; kk <= Lp; kk <<= 1) {
        for (int64_t jj = kk >> 1; jj > 0; jj >>= 1) {
            for (int64_t t = threadIdx.x; t < half; t += blockDim.x) {
                int64_t i, j;
                if (jj == (kk >> 1)) {          // the flip of each stage
                    const int64_t h = kk >> 1, b = t / h, o = t % h;
                    i = b * kk + o;
                    j = b * kk + kk - 1 - o;
                } else {
                    i = (t / jj) * 2 * jj + (t % jj);
                    j = i + jj;
                }
                if (j < L && a[j] < a[i]) {
                    const int x = a[i];
                    a[i] = a[j];
                    a[j] = x;
                }
            }
            __syncthreads();
        }
    }
}

// entry j of a run in window offset xw: its value, or -1 where it is
// masked off or negative (both loads issued before either is tested)
__device__ __forceinline__ int mode_entry(int64_t xw, int64_t j,
                                          const int32_t* __restrict__ perm,
                                          const int32_t* __restrict__ x,
                                          const uint8_t* __restrict__ mask) {
    const int64_t e = xw + (perm ? (int64_t)perm[j] : j);
    const int v = x[e];
    const bool on = mask ? mask[e] != 0 : true;
    return on && v >= 0 ? v : -1;
}

// a long row r of window w (xw = w*m), by the whole block
__device__ void mode_long_row(int64_t r, int64_t xw, int dflt,
                              const int64_t* __restrict__ indptr,
                              const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ x,
                              const uint8_t* __restrict__ mask,
                              int32_t* scratch, int* sv,
                              unsigned long long* wbest, int32_t* out) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t j0 = indptr[r], L = indptr[r + 1] - j0;
    int* a = L <= kSmemRows ? sv : scratch + xw + j0;
    for (int64_t t = threadIdx.x; t < L; t += blockDim.x)
        a[t] = mode_entry(xw, j0 + t, perm, x, mask);
    __syncthreads();
    block_sort(a, L);
    unsigned long long best = 0;
    for (int64_t t = threadIdx.x; t < L; t += blockDim.x) {
        const int v = a[t];
        if (v < 0 || (t > 0 && a[t - 1] == v)) continue;
        int64_t lo = t + 1, hi = L;          // first index > v
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (a[mid] <= v) lo = mid + 1; else hi = mid;
        }
        const unsigned long long key = mode_key(v, (int)(lo - t));
        best = key > best ? key : best;
    }
    best = warp_max(best);
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long b = 0;
        for (int i = 0; i < kModeThreads / 32; ++i)
            b = wbest[i] > b ? wbest[i] : b;
        out[r] = mode_value(b, dflt);
    }
}

// the short rows [r0, r0 + kTileRows) of window offset xw, by one warp
__device__ void mode_short_rows(int64_t r0, int64_t n, int64_t xw, int dflt,
                                const int64_t* __restrict__ indptr,
                                const int32_t* __restrict__ perm,
                                const int32_t* __restrict__ x,
                                const uint8_t* __restrict__ mask,
                                int32_t* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    long long a = 0;
    int eff = 0;                                // lanes the row takes
    if (lane < kTileRows && r0 + lane < n) {
        a = indptr[r0 + lane];
        const int64_t L = indptr[r0 + lane + 1] - a;
        if (L == 0) out[r0 + lane] = dflt;
        eff = L <= 32 ? (int)L : 0;             // long rows: their blocks
    }
    int P = eff;                                // running sum, inclusive
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, P, o);
        if (lane >= o) P += y;
    }
    const int total = __shfl_sync(kAll, P, 31);
    const int Pk = lane < kTileRows ? P : 0x7fffffff;
    int base = 0;                               // entries done
    while (base < total) {                      // warp-uniform
        const int q = base + lane;              // this lane's entry
        int i = 0;                              // its row: first P > q
        for (int s = 16; s > 0; s >>= 1) {
            if (__shfl_sync(kAll, Pk, i + s - 1) <= q) i += s;
        }
        const int Pi = __shfl_sync(kAll, Pk, i);
        const int Li = __shfl_sync(kAll, eff, i);
        const long long ai = __shfl_sync(kAll, a, i);
        const bool in = q < total && Pi <= base + 32;
        int start = lane, end = lane + 1;       // the row's lanes
        int v = -1;
        if (in) {
            start = Pi - Li - base;
            end = Pi - base;
            v = mode_entry(xw, ai + (q - (Pi - Li)), perm, x, mask);
        }
        const unsigned seg = (end >= 32 ? kAll : (1u << end) - 1u)
                             & ~((1u << start) - 1u);
        unsigned long long key =
            mode_key(v, __popc(__match_any_sync(kAll, v) & seg));
        for (int o = 1; o < 32; o <<= 1) {      // max over [lane, end)
            const unsigned long long y = __shfl_down_sync(kAll, key, o);
            if (lane + o < end) key = y > key ? y : key;
        }
        if (in && lane == start) out[r0 + i] = mode_value(key, dflt);
        base = (int)__reduce_max_sync(
            kAll, lane < kTileRows && P <= base + 32 ? (unsigned)P : 0u);
    }
}

__global__ void __launch_bounds__(kModeThreads) segment_mode_kernel(
        int64_t n, int64_t m, int dflt, int64_t nl, unsigned y0,
        const int64_t* __restrict__ indptr, const int32_t* __restrict__ perm,
        const int32_t* __restrict__ x, const uint8_t* __restrict__ mask,
        const int32_t* __restrict__ long_rows, int32_t* scratch,
        int32_t* __restrict__ out) {
    __shared__ int sv[kSmemRows];
    __shared__ unsigned long long wbest[kModeThreads / 32];
    const int64_t w = (int64_t)blockIdx.y + y0;
    const int64_t xw = w * m;
    int32_t* ow = out + w * n;
    if (blockIdx.x < nl) {                      // block-uniform
        mode_long_row(long_rows[blockIdx.x], xw, dflt, indptr, perm, x, mask,
                      scratch, sv, wbest, ow);
        return;
    }
    const int64_t r0 = ((int64_t)(blockIdx.x - nl) * (kModeThreads / 32)
                        + (threadIdx.x >> 5)) * kTileRows;
    if (r0 < n)                                 // warp-uniform
        mode_short_rows(r0, n, xw, dflt, indptr, perm, x, mask, ow);
}

}  // namespace

extern "C" {

// K7. op: 0 sum, 1 min, 2 max; dtype: 0 float32, 1 int32, 2 int64. k
// windows, n rows, m payload rows per window, F features, nl long rows |
// indptr [n+1] int64, perm int32 or null (the destination direction: the
// CSR runs are the edges themselves), long_rows [nl] int32 (the rows whose
// runs exceed 32 entries, longest first), x [k*m, F], mask [k*m] bool |
// out [k*n, F] | launched: the launches made, one a group of 65,535 grid
// rows (F * k rows, or F where one walk serves all k windows).
int rtpu_segment_combine(int64_t k, int64_t n, int64_t m, int64_t F,
                         int64_t op, int64_t dtype, int64_t nl,
                         const void* indptr, const void* perm,
                         const void* long_rows, const void* x,
                         const void* mask, void* out, void* stream,
                         int64_t* launched) {
    const Walk wk{static_cast<const int64_t*>(indptr),
                  static_cast<const int32_t*>(perm), nullptr, nullptr};
    return combine_entry(k, n, m, F, op, dtype, nl, wk, long_rows, x, mask,
                         out, stream, launched);
}

// K7-P. As rtpu_segment_combine, the walk through indptr [n+1] int64,
// order int32 (the destination walk), perm [B] int32 or null, valid [B]
// bool or null.
int rtpu_partition_reduce(int64_t k, int64_t n, int64_t m, int64_t F,
                          int64_t op, int64_t dtype, int64_t nl,
                          const void* indptr, const void* order,
                          const void* perm, const void* valid,
                          const void* long_rows, const void* x,
                          const void* mask, void* out, void* stream,
                          int64_t* launched) {
    const Walk wk{static_cast<const int64_t*>(indptr),
                  static_cast<const int32_t*>(order),
                  static_cast<const int32_t*>(perm),
                  static_cast<const uint8_t*>(valid)};
    return combine_entry(k, n, m, F, op, dtype, nl, wk, long_rows, x, mask,
                         out, stream, launched);
}

// K7-mode. k windows, n rows, m payload rows per window, nl long rows |
// indptr [n+1] int64, perm [m_real] int32 or null, x [k*m] int32, mask
// [k*m] bool or null (every row), long_rows [nl] int32 (the rows whose runs
// exceed 32 entries), scratch [k*m] int32 or null (needed only where a long
// row exceeds kSmemRows) | out [k*n] int32 | launched: one launch a group
// of 65,535 windows.
int rtpu_segment_mode(int64_t k, int64_t n, int64_t m, int64_t dflt,
                      int64_t nl, const void* indptr, const void* perm,
                      const void* x, const void* mask, const void* long_rows,
                      void* scratch, void* out, void* stream,
                      int64_t* launched) {
    *launched = 0;
    if (k * n == 0) return (int)cudaGetLastError();
    if (k >= (int64_t(1) << 32) || nl < 0 || nl > n)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t rows_a_block = (int64_t)(kModeThreads / 32) * kTileRows;
    const unsigned gx = (unsigned)(nl + (n + rows_a_block - 1) / rows_a_block);
    for (int64_t y0 = 0; y0 < k; y0 += kGridRows) {
        const int64_t rows = k - y0 < kGridRows ? k - y0 : kGridRows;
        segment_mode_kernel<<<dim3(gx, (unsigned)rows), kModeThreads, 0, s>>>(
            n, m, (int)dflt, nl, (unsigned)y0,
            static_cast<const int64_t*>(indptr),
            static_cast<const int32_t*>(perm), static_cast<const int32_t*>(x),
            static_cast<const uint8_t*>(mask),
            static_cast<const int32_t*>(long_rows),
            static_cast<int32_t*>(scratch), static_cast<int32_t*>(out));
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        ++*launched;
    }
    return (int)cudaSuccess;
}

}  // extern "C"
