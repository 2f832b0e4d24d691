// K5/K6 — one superstep of the column-batched min-combine traversals.
//
// Replaces the loop bodies of raphtory_tpu/engine/hopbatch.py:538
// `_cc_columns` (K5, min-label propagation, int32) and :620 `_bfs_columns`
// (K6, min-plus relaxation, f32, unit or weighted) on the unbinned,
// untiled route: the second half of the jitted `_compiled_delta` program
// for kinds "cc" and "bfs". C = H*W views run as columns of one pass;
// masks are bool [m_pad, C] / [n_pad, C], state is [n_pad, C], row-major.
// One template serves both: per (v, c)
//     agg  = min over in-edges e of v  (me[e, c] ? pay(src[e], e, c) : MAX)
//     agg  = min(agg, the same over out-edges e of v with pay(dst[e], e, c))
//            -- CC always, BFS/SSSP only when undirected
//     new  = mv[v, c] ? min(cur, agg) : MAX
//     busy[c] |= (new != cur)                   (the column's halting test)
//     next = halted[c] ? cur : new               (freeze halted columns)
// with pay = cur[u, c] for CC and __fadd_rn(cur[u, c], w) for BFS/SSSP
// (w = 1 unit, or ew[e, c / W] weighted). MAX is INT32_MAX / +inf; inf + w
// stays inf and INT32_MAX is never added to. Min is exact and the add is
// one correctly rounded f32 operation, so the result is bitwise the
// reference's whatever order the edges are visited in.
//
// Synchronous (Jacobi) semantics: every row reads the previous superstep's
// state `cur` and writes `next`, a second buffer; the wrapper swaps the two
// on the host. An in-place update would reach the same fixed point in a
// different number of supersteps, and the step count is part of the result.
//
// The forward pull walks the destination CSR over the (dst, src)-sorted
// table (walk entry j is edge j, far end e_src[j]). The reverse pull
// (reference: an unsorted segment-min keyed by source,
// `pull(e_dst, e_src, False)`) walks a source CSR over the same edges
// (`out_indptr`, `out_perm[k]` = engine position of the k-th edge in
// (src, dst) order, far end e_dst), so both directions are gathers with no
// atomics and one code path serves int32 and f32 (there is no native f32
// atomic min, and the int-reinterpretation trick breaks on negative
// weights). The pad edges lie outside both CSRs.
//
// Weights: the reference concatenates the per-hop weight state into a
// hop-major [m_pad, C] block; every hop's W columns share one weight, so
// the kernel reads a [m_pad, H] block at ew[e * H + c / W] — the same
// numbers with W times fewer bytes.
//
// Halting: `busy` is computed over ALL rows before the freeze, then
// halted |= !busy (hopbatch.py:585-587, :667-669): a frozen column keeps
// its state and may still report done. The column reduction crosses
// blocks as in K2c (pagerank_columns.cu): every block writes one partial
// per column, the last block to take an atomic ticket (after a fence)
// ORs the partials, sets halted and the all-halted flag the host reads,
// and resets the ticket.
//
// Layout (K2b-P's, pagerank_columns.cu): a group of G lanes owns one row
// (G = ceil(C/4) up to 32; wider C tiles the columns over blockIdx.y, 128
// a tile), each lane 4 adjacent columns, 256 / G rows a block, the rows
// strided over minplus.superstep_grid(n, C) blocks. A lane walks a row's
// edges kMinBatch (8) walk entries at a time, each stage issued for all 8
// before the next: the edge ids, then their 32-bit mask words and far-end
// rows, then (for the entries whose mask word is not 0) their 16-byte
// state segments, then the mins in walk order. So up to 8 gathers a lane
// are in flight where the parent kernel (one thread a (row, column), one
// edge at a time) had one behind four dependent loads. The vertex mask,
// the old state and the next state are one 32-bit / 16-byte access a lane.
// C % 4 != 0 or an unaligned tensor takes the same walk per element.
//
// What bounds it on the H100: bytes. Per superstep it streams the mask
// (m * C bytes, per direction), the edge ids and CSRs, reads the state by
// gather (n_pad * C * 4 bytes, L2-resident at the slice's shapes) and
// writes the next state once; one compare (and one add) per edge and
// column. A row's group walks its whole edge run, so a very high degree
// serialises that group.
//
// K5-P / K6-P — the same superstep on the destination-binned (PCPM) route
// (hopbatch.py:572-583 `_cc_columns`, :653-664 `_bfs_columns` with
// `pcpm`): edges are binned slots (ops/partition.py), me is [B, C] and the
// weights [B, H]. The in-direction walks the layout's destination walk
// (each destination's real slots, in_order) and reads cur[b_src[s]]; the
// reverse walks the layout's source walk and reads cur[b_dst[s]]. The
// reference first gathers one state row per (partition, source) bucket
// when the layout pre-aggregates; for a min that is only a copy (min is
// exact in any order), so the kernel reads each slot's source row
// straight from the state, one launch a superstep on every layout
// (ops/columns.py `check_bucket_sources` holds b_src[s] to the bucket's
// u_src[slot[s]] once per layout). Labels and distances are bitwise the
// unbinned route's and the reference's. The cap-pad slots are in neither
// walk.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/minplus.py).
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinTile = 128;     // columns of a lane group: 32 lanes x 4
constexpr int kMinBatch = 8;      // walk entries a lane keeps in flight

// lanes a row (its group) for C columns; the wrapper sizes the busy
// partials from the same rule (minplus.superstep_grid)
__host__ __device__ inline int min_group(int64_t C) {
    const int64_t q = (C + 3) / 4;
    return q < 32 ? static_cast<int>(q) : 32;
}

// payload of the edge e whose far end holds `x`, its hop h
struct CcPay {
    __device__ static int32_t max() { return INT32_MAX; }
    __device__ int32_t operator()(int32_t x, int64_t, int64_t) const {
        return x;
    }
};

struct UnitPay {
    __device__ static float max() { return __int_as_float(0x7f800000); }
    __device__ float operator()(float x, int64_t, int64_t) const {
        return __fadd_rn(x, 1.0f);
    }
};

struct WeightPay {
    const float* ew;   // [m_pad, H] (binned: [B, H])
    int64_t H;
    __device__ static float max() { return __int_as_float(0x7f800000); }
    __device__ float operator()(float x, int64_t e, int64_t h) const {
        return __fadd_rn(x, __ldg(ew + e * H + h));
    }
};

template <typename T>
__device__ inline T tmin(T a, T b) { return b < a ? b : a; }

// a state value from / to its 32 bits
template <typename T> __device__ inline T from_bits(int x);
template <> __device__ inline int32_t from_bits<int32_t>(int x) { return x; }
template <> __device__ inline float from_bits<float>(int x) {
    return __int_as_float(x);
}
__device__ inline int to_bits(int32_t x) { return x; }
__device__ inline int to_bits(float x) { return __float_as_int(x); }

// the mask bytes of columns [c, c + 4) of row s as one word (byte b set
// where column c + b is), columns past C 0
template <bool VEC>
__device__ __forceinline__ uint32_t mask_word(const uint8_t* __restrict__ m,
                                              int64_t s, int64_t C,
                                              int64_t c) {
    const uint8_t* p = m + s * C + c;
    if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(p));
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (c + b < C && p[b]) w |= 1u << (8 * b);
    return w;
}

// columns [c, c + 4) of row i of a 4-byte state (columns past C unread)
template <typename T, bool VEC>
__device__ __forceinline__ void load_quad(T (&x)[4], const T* __restrict__ a,
                                          int64_t i, int64_t C, int64_t c) {
    const T* p = a + i * C + c;
    if (VEC) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p));
        x[0] = from_bits<T>(v.x);
        x[1] = from_bits<T>(v.y);
        x[2] = from_bits<T>(v.z);
        x[3] = from_bits<T>(v.w);
    } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
            if (c + b < C) x[b] = p[b];
    }
}

// agg[b] = min(agg[b], pay(src[row(e), c + b])) over the walk entries
// [j0, j1): entry j is edge e = order[j] (order null: e = j), its far end
// rows[e]; masked-out columns (and entries with an all-0 mask word, which
// read no state) leave agg as it was. The mins run in walk order.
template <typename T, typename Pay, bool VEC>
__device__ __forceinline__ void min_walk(T (&agg)[4], int64_t j0, int64_t j1,
                                         const int32_t* __restrict__ order,
                                         const int32_t* __restrict__ rows,
                                         const uint8_t* __restrict__ me,
                                         const T* __restrict__ src,
                                         int64_t C, int64_t c,
                                         const Pay& pay,
                                         const int64_t (&hop)[4]) {
    for (int64_t j = j0; j < j1; j += kMinBatch) {
        const int64_t cnt = j1 - j;
        int32_t e[kMinBatch];
#pragma unroll
        for (int k = 0; k < kMinBatch; ++k)
            e[k] = k < cnt ? (order ? __ldg(order + j + k)
                                    : static_cast<int32_t>(j + k))
                           : 0;
        uint32_t w[kMinBatch];
        int32_t r[kMinBatch];
#pragma unroll
        for (int k = 0; k < kMinBatch; ++k) {
            w[k] = k < cnt ? mask_word<VEC>(me, e[k], C, c) : 0u;
            r[k] = k < cnt ? __ldg(rows + e[k]) : 0;
        }
        T v[kMinBatch][4];
#pragma unroll
        for (int k = 0; k < kMinBatch; ++k)
            if (w[k]) load_quad<T, VEC>(v[k], src, r[k], C, c);
#pragma unroll
        for (int k = 0; k < kMinBatch; ++k) {
#pragma unroll
            for (int b = 0; b < 4; ++b)
                if ((w[k] >> (8 * b)) & 0xffu)
                    agg[b] = tmin(agg[b], pay(v[k][b], e[k], hop[b]));
        }
    }
}

// One superstep. In-edges of row i: walk entries [in_indptr[i],
// in_indptr[i+1]) of (in_order, in_rows); out-edges (when `both`): those of
// (out_indptr, out_order, out_rows).
template <typename T, typename Pay, bool VEC>
__global__ void __launch_bounds__(kThreads) min_superstep(
        int64_t n, int64_t C, int64_t W, int G, int both, Pay pay,
        const int64_t* __restrict__ in_indptr,
        const int32_t* __restrict__ in_order,
        const int32_t* __restrict__ in_rows,
        const int64_t* __restrict__ out_indptr,
        const int32_t* __restrict__ out_order,
        const int32_t* __restrict__ out_rows,
        const uint8_t* __restrict__ me, const uint8_t* __restrict__ mv,
        const T* __restrict__ cur, T* __restrict__ nxt,
        uint8_t* __restrict__ halted, uint8_t* __restrict__ done,
        int32_t* __restrict__ busy, unsigned int* __restrict__ ticket) {
    __shared__ uint32_t s_busy[kThreads];   // 4 column bits a thread
    __shared__ bool s_last;
    __shared__ int s_all;
    const T MAXV = Pay::max();
    const int R = blockDim.x / G;
    const int t = threadIdx.x;
    const int64_t c = static_cast<int64_t>(blockIdx.y) * kMinTile
                      + 4 * (t % G);
    uint32_t nb = 0;
    if (c < C) {
        uint32_t hc = 0;                     // the lane's halted columns
        int64_t hop[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            hop[b] = (c + b) / W;
            if (c + b < C && halted[c + b]) hc |= 1u << b;
        }
        const int64_t stride = static_cast<int64_t>(gridDim.x) * R;
        for (int64_t i = static_cast<int64_t>(blockIdx.x) * R + t / G; i < n;
             i += stride) {
            T agg[4] = {MAXV, MAXV, MAXV, MAXV};
            min_walk<T, Pay, VEC>(agg, in_indptr[i], in_indptr[i + 1],
                                  in_order, in_rows, me, cur, C, c, pay,
                                  hop);
            if (both)
                min_walk<T, Pay, VEC>(agg, out_indptr[i], out_indptr[i + 1],
                                      out_order, out_rows, me, cur, C, c,
                                      pay, hop);
            T old[4] = {MAXV, MAXV, MAXV, MAXV};
            load_quad<T, VEC>(old, cur, i, C, c);
            const uint32_t mw = mask_word<VEC>(mv, i, C, c);
            T x[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const T nw = (mw >> (8 * b)) & 0xffu ? tmin(old[b], agg[b])
                                                     : MAXV;
                if (c + b < C && nw != old[b]) nb |= 1u << b;
                x[b] = (hc >> b) & 1u ? old[b] : nw;
            }
            T* o = nxt + i * C + c;
            if (VEC) {
                *reinterpret_cast<int4*>(o) = make_int4(
                    to_bits(x[0]), to_bits(x[1]), to_bits(x[2]),
                    to_bits(x[3]));
            } else {
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (c + b < C) o[b] = x[b];
            }
        }
    }
    s_busy[t] = nb;
    __syncthreads();
    if (t < G && c < C) {                    // row 0's lanes: one a quad
        uint32_t b = 0;
        for (int r = 0; r < R; ++r) b |= s_busy[r * G + t];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (c + k < C)
                busy[static_cast<int64_t>(blockIdx.x) * C + c + k] =
                    (b >> k) & 1u;
    }
    __threadfence();   // partials visible device-wide before the ticket
    __syncthreads();
    if (t == 0) {
        const unsigned int nblocks = gridDim.x * gridDim.y;
        s_last = atomicAdd(ticket, 1u) == nblocks - 1;
        s_all = 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int64_t cc = t; cc < C; cc += blockDim.x) {
        int b = 0;
        for (int64_t bx = 0; bx < gridDim.x; ++bx) {
            b |= __ldcg(busy + bx * C + cc);
        }
        uint8_t hh = halted[cc];
        if (!b) hh = 1;
        halted[cc] = hh;
        if (!hh) s_all = 0;   // every writer stores the same 0
    }
    __syncthreads();
    if (t == 0) {
        done[0] = static_cast<uint8_t>(s_all);
        *ticket = 0u;
    }
}

inline bool aligned(const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
}

template <typename T, typename Pay>
int launch(int64_t n, int64_t C, int64_t W, int64_t gx, int64_t both, Pay pay,
           const void* in_indptr, const void* in_order, const void* in_rows,
           const void* out_indptr, const void* out_order,
           const void* out_rows, const void* me, const void* mv,
           const void* cur, void* nxt, void* halted, void* done, void* busy,
           void* ticket, void* stream) {
    if (C <= 0 || gx <= 0) return static_cast<int>(cudaGetLastError());
    const int G = min_group(C);
    const dim3 grid(static_cast<unsigned>(gx),
                    static_cast<unsigned>((C + kMinTile - 1) / kMinTile));
    const unsigned threads = static_cast<unsigned>((kThreads / G) * G);
    const bool vec = C % 4 == 0 && aligned(me, 4) && aligned(mv, 4)
                     && aligned(cur, 16) && aligned(nxt, 16);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTPU_MIN_ARGS                                                        \
    n, C, W, G, static_cast<int>(both), pay,                                 \
        static_cast<const int64_t*>(in_indptr),                              \
        static_cast<const int32_t*>(in_order),                               \
        static_cast<const int32_t*>(in_rows),                                \
        static_cast<const int64_t*>(out_indptr),                             \
        static_cast<const int32_t*>(out_order),                              \
        static_cast<const int32_t*>(out_rows),                               \
        static_cast<const uint8_t*>(me), static_cast<const uint8_t*>(mv),    \
        static_cast<const T*>(cur), static_cast<T*>(nxt),                    \
        static_cast<uint8_t*>(halted), static_cast<uint8_t*>(done),          \
        static_cast<int32_t*>(busy), static_cast<unsigned int*>(ticket)
    if (vec) {
        min_superstep<T, Pay, true><<<grid, threads, 0, st>>>(RTPU_MIN_ARGS);
    } else {
        min_superstep<T, Pay, false><<<grid, threads, 0, st>>>(RTPU_MIN_ARGS);
    }
#undef RTPU_MIN_ARGS
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5 / K5-P: CC over both directions, int32 labels | n, C, gx | in_indptr,
// in_order (null: the unbinned table's identity walk), in_rows (e_src /
// b_src), out_indptr, out_order (out_perm / the layout's source walk),
// out_rows (e_dst / b_dst), me, mv, cur, nxt, halted, done, busy, ticket,
// stream. One launch.
int rtpu_cc_superstep(int64_t n, int64_t C, int64_t gx, const void* in_indptr,
                      const void* in_order, const void* in_rows,
                      const void* out_indptr, const void* out_order,
                      const void* out_rows, const void* me, const void* mv,
                      const void* cur, void* nxt, void* halted, void* done,
                      void* busy, void* ticket, void* stream) {
    return launch<int32_t>(n, C, 1, gx, 1, CcPay{}, in_indptr, in_order,
                           in_rows, out_indptr, out_order, out_rows, me, mv,
                           cur, nxt, halted, done, busy, ticket, stream);
}

// K6 / K6-P: BFS (ew == nullptr: unit weights) or SSSP (ew: [m_pad, H] f32,
// binned [B, H]; hop h = c / W), f32 distances; the out-walk only when
// undirected. Arguments as K5's with W, H, directed and ew after C.
int rtpu_minplus_superstep(int64_t n, int64_t C, int64_t W, int64_t H,
                           int64_t gx, int64_t directed, const void* ew,
                           const void* in_indptr, const void* in_order,
                           const void* in_rows, const void* out_indptr,
                           const void* out_order, const void* out_rows,
                           const void* me, const void* mv, const void* cur,
                           void* nxt, void* halted, void* done, void* busy,
                           void* ticket, void* stream) {
    const int64_t both = directed ? 0 : 1;
    if (ew == nullptr) {
        return launch<float>(n, C, W, gx, both, UnitPay{}, in_indptr,
                             in_order, in_rows, out_indptr, out_order,
                             out_rows, me, mv, cur, nxt, halted, done, busy,
                             ticket, stream);
    }
    return launch<float>(n, C, W, gx, both,
                         WeightPay{static_cast<const float*>(ew), H},
                         in_indptr, in_order, in_rows, out_indptr, out_order,
                         out_rows, me, mv, cur, nxt, halted, done, busy,
                         ticket, stream);
}

}  // extern "C"
