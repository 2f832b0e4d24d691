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
// anyway. One thread owns one (window, row, feature) and walks its run in
// CSR order, so there are no atomics and the sum order is fixed: the
// result is deterministic and, in the destination direction, adds in the
// same order as a sequential scatter over the sorted edges. Floats add
// with __fadd_rn so no contraction can move them.
//
// What bounds it on the H100: bytes — the mask and the payload of every
// edge read once per window, the CSR once, the output written once; one
// operation per masked edge. A row's thread walks its whole run, so a
// very high degree (Bitcoin's Pareto senders in the source direction)
// serialises that thread; a row split is an open item.
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
// in source order, built once on the host), so a block of neighbouring
// threads covers neighbouring rows of one partition's block. perm null:
// slot s is payload row s (the [P, cap] payload of the reference's
// signature); valid null: every slot real. One thread per (window, row,
// feature), fixed order, no atomics: the sums add in the order K7 adds the
// same edges, min/max are order-exact. Bound: bytes — the payload and mask
// of every real edge once per window through perm, the walk once, the
// output written once.
//
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
// blockIdx.y (no division). The blocks along x come in two kinds, in one
// launch:
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
    __device__ static int32_t add(int32_t a, int32_t b) { return a + b; }
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
__device__ inline T neutral() {
    if (OP == kSum) return T(0);
    if (OP == kMin) return Lim<T>::hi();
    return Lim<T>::lo();
}

template <typename T, int OP>
__device__ inline T combine(T a, T b) {
    if (OP == kSum) return Lim<T>::add(a, b);
    if (OP == kMin) return b < a ? b : a;
    return b > a ? b : a;
}

template <typename T, int OP>
__global__ void segment_combine_kernel(int64_t k, int64_t n, int64_t m,
                                       int64_t F,
                                       const int64_t* __restrict__ indptr,
                                       const int32_t* __restrict__ perm,
                                       const T* __restrict__ x,
                                       const uint8_t* __restrict__ mask,
                                       T* __restrict__ out) {
    const int64_t total = k * n * F;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t f = t % F;
        const int64_t r = (t / F) % n;
        const int64_t w = t / (F * n);
        const int64_t base = w * m;
        T acc = neutral<T, OP>();
        const int64_t j1 = indptr[r + 1];
        for (int64_t j = indptr[r]; j < j1; ++j) {
            const int64_t e = base + (perm ? (int64_t)perm[j] : j);
            if (mask[e]) acc = combine<T, OP>(acc, x[e * F + f]);
        }
        out[t] = acc;
    }
}

template <typename T, int OP>
__global__ void partition_reduce_kernel(int64_t k, int64_t n, int64_t m,
                                        int64_t F,
                                        const int64_t* __restrict__ indptr,
                                        const int32_t* __restrict__ order,
                                        const int32_t* __restrict__ perm,
                                        const uint8_t* __restrict__ valid,
                                        const T* __restrict__ x,
                                        const uint8_t* __restrict__ mask,
                                        T* __restrict__ out) {
    const int64_t total = k * n * F;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t f = t % F;
        const int64_t r = (t / F) % n;
        const int64_t w = t / (F * n);
        const int64_t base = w * m;
        T acc = neutral<T, OP>();
        const int64_t j1 = indptr[r + 1];
        for (int64_t j = indptr[r]; j < j1; ++j) {
            const int64_t s = order[j];
            if (valid && !valid[s]) continue;
            const int64_t e = base + (perm ? (int64_t)perm[s] : s);
            if (mask[e]) acc = combine<T, OP>(acc, x[e * F + f]);
        }
        out[t] = acc;
    }
}

template <typename T>
void launch_partition(int op, int64_t k, int64_t n, int64_t m, int64_t F,
                      const int64_t* indptr, const int32_t* order,
                      const int32_t* perm, const uint8_t* valid,
                      const void* x, const uint8_t* mask, void* out,
                      cudaStream_t s) {
    const int64_t total = k * n * F;
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    if (blocks < 1) blocks = 1;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (op == kSum)
        partition_reduce_kernel<T, kSum><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, order, perm, valid, xt, mask, ot);
    else if (op == kMin)
        partition_reduce_kernel<T, kMin><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, order, perm, valid, xt, mask, ot);
    else
        partition_reduce_kernel<T, kMax><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, order, perm, valid, xt, mask, ot);
}

template <typename T>
void launch(int op, int64_t k, int64_t n, int64_t m, int64_t F,
            const int64_t* indptr, const int32_t* perm, const void* x,
            const uint8_t* mask, void* out, cudaStream_t s) {
    const int64_t total = k * n * F;
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    if (blocks < 1) blocks = 1;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (op == kSum)
        segment_combine_kernel<T, kSum><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, perm, xt, mask, ot);
    else if (op == kMin)
        segment_combine_kernel<T, kMin><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, perm, xt, mask, ot);
    else
        segment_combine_kernel<T, kMax><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, perm, xt, mask, ot);
}

constexpr int kModeThreads = 256;      // a block: 8 warps
constexpr int kTileRows = 16;          // short rows a warp takes
constexpr int kSmemRows = 4096;        // longest run sorted in shared memory
constexpr unsigned kAll = 0xffffffffu;

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
        int64_t n, int64_t m, int dflt, int64_t nl,
        const int64_t* __restrict__ indptr, const int32_t* __restrict__ perm,
        const int32_t* __restrict__ x, const uint8_t* __restrict__ mask,
        const int32_t* __restrict__ long_rows, int32_t* scratch,
        int32_t* __restrict__ out) {
    __shared__ int sv[kSmemRows];
    __shared__ unsigned long long wbest[kModeThreads / 32];
    const int64_t xw = (int64_t)blockIdx.y * m;
    int32_t* ow = out + (int64_t)blockIdx.y * n;
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

// op: 0 sum, 1 min, 2 max; dtype: 0 float32, 1 int32, 2 int64. perm may
// be null (the destination direction: the CSR runs are the edges
// themselves).
int rtpu_segment_combine(int64_t k, int64_t n, int64_t m, int64_t F,
                         int64_t op, int64_t dtype, const void* indptr,
                         const void* perm, const void* x, const void* mask,
                         void* out, void* stream) {
    if (k * n * F == 0) return (int)cudaGetLastError();
    if (op < 0 || op > 2 || dtype < 0 || dtype > 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t* ip = static_cast<const int64_t*>(indptr);
    const int32_t* pp = static_cast<const int32_t*>(perm);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    if (dtype == 0)
        launch<float>((int)op, k, n, m, F, ip, pp, x, mk, out, s);
    else if (dtype == 1)
        launch<int32_t>((int)op, k, n, m, F, ip, pp, x, mk, out, s);
    else
        launch<int64_t>((int)op, k, n, m, F, ip, pp, x, mk, out, s);
    return (int)cudaGetLastError();
}

// K7-P. k windows, n rows, m payload rows per window, F features; op and
// dtype as rtpu_segment_combine | indptr [n+1] int64, order int32 (the
// destination walk), perm [B] int32 or null, valid [B] bool or null,
// x [k*m, F], mask [k*m] | out [k*n, F].
int rtpu_partition_reduce(int64_t k, int64_t n, int64_t m, int64_t F,
                          int64_t op, int64_t dtype, const void* indptr,
                          const void* order, const void* perm,
                          const void* valid, const void* x, const void* mask,
                          void* out, void* stream) {
    if (k * n * F == 0) return (int)cudaGetLastError();
    if (op < 0 || op > 2 || dtype < 0 || dtype > 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t* ip = static_cast<const int64_t*>(indptr);
    const int32_t* od = static_cast<const int32_t*>(order);
    const int32_t* pp = static_cast<const int32_t*>(perm);
    const uint8_t* vd = static_cast<const uint8_t*>(valid);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    if (dtype == 0)
        launch_partition<float>((int)op, k, n, m, F, ip, od, pp, vd, x, mk,
                                out, s);
    else if (dtype == 1)
        launch_partition<int32_t>((int)op, k, n, m, F, ip, od, pp, vd, x, mk,
                                  out, s);
    else
        launch_partition<int64_t>((int)op, k, n, m, F, ip, od, pp, vd, x, mk,
                                  out, s);
    return (int)cudaGetLastError();
}

// K7-mode. k windows (at most 65,535), n rows, m payload rows per
// window, nl long rows | indptr [n+1] int64, perm [m_real] int32 or null,
// x [k*m] int32, mask [k*m] bool or null (every row), long_rows [nl] int32
// (the rows whose runs exceed 32 entries), scratch [k*m] int32 or null
// (needed only where a long row exceeds kSmemRows) | out [k*n] int32. One
// launch.
int rtpu_segment_mode(int64_t k, int64_t n, int64_t m, int64_t dflt,
                      int64_t nl, const void* indptr, const void* perm,
                      const void* x, const void* mask, const void* long_rows,
                      void* scratch, void* out, void* stream) {
    if (k * n == 0) return (int)cudaGetLastError();
    if (k > 65535 || nl < 0 || nl > n) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t rows_a_block = (int64_t)(kModeThreads / 32) * kTileRows;
    const dim3 grid((unsigned)(nl + (n + rows_a_block - 1) / rows_a_block),
                    (unsigned)k);
    segment_mode_kernel<<<grid, kModeThreads, 0, s>>>(
        n, m, (int)dflt, nl, static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(perm), static_cast<const int32_t*>(x),
        static_cast<const uint8_t*>(mask),
        static_cast<const int32_t*>(long_rows),
        static_cast<int32_t*>(scratch), static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
