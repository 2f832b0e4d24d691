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
// The reverse pull (reference: an unsorted segment-min keyed by source,
// `pull(e_dst, e_src, False)`) walks a source CSR over the same edges
// (`out_indptr`, `out_perm[k]` = engine position of the k-th edge in
// (src, dst) order), so both directions are gathers with no atomics and
// one code path serves int32 and f32 (there is no native f32 atomic min,
// and the int-reinterpretation trick breaks on negative weights). The pad
// edges lie outside both CSRs.
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
// and resets the ticket. Threads are laid out as in K2c: column-fastest,
// a block holds whole rows of up to 256 columns.
//
// What bounds it on the H100: bytes. Per superstep it streams the mask
// (m * C bytes, per direction), the edge ids and CSRs, reads the state by
// gather (n_pad * C * 4 bytes, L2-resident at the slice's shapes) and
// writes the next state once; one compare (and one add) per edge and
// column. A row's threads walk its whole edge run, so a very high degree
// serialises its warp — the same open item as K2b.
//
// K5-P / K6-P — the same superstep on the destination-binned (PCPM) route
// (hopbatch.py:572-583 `_cc_columns`, :653-664 `_bfs_columns` with
// `pcpm`): edges are binned slots (ops/partition.py), me is [B, C] and the
// weights [B, H]. The in-direction reads through the pre-aggregation
// buckets when the layout has them — a first kernel gathers vals[u, c] =
// cur[u_src[u], c], one row per (partition, source), and slot s pays
// vals[slot[s], c] — else cur[b_src[s], c]; its rows walk the layout's
// destination walk (each destination's real slots, built once with the
// layout). The reverse direction (`pull(e_dst, e_src, False)` over the
// binned arrays) walks the layout's source walk and pays cur[b_dst[s], c].
// Min is order-exact: labels and distances are bitwise the unbinned
// route's and the reference's. The cap-pad slots are in neither walk.
// One launch a superstep, two with the bucket gather.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/minplus.py).
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int64_t tile_cols(int64_t C) {
    return C < kThreads ? C : kThreads;
}

// payload of the edge e whose far end u holds `x`, column c
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
    const float* ew;   // [m_pad, H]
    int64_t H;
    __device__ static float max() { return __int_as_float(0x7f800000); }
    __device__ float operator()(float x, int64_t e, int64_t h) const {
        return __fadd_rn(x, ew[e * H + h]);
    }
};

template <typename T>
__device__ inline T tmin(T a, T b) { return b < a ? b : a; }

// In-direction operands: row i's in-edges are in_order[j] (the edge j
// itself when in_order is null) for j in [in_indptr[i], in_indptr[i+1]),
// and edge s gathers row in_rows[s] of `gsrc` (cur unbinned; on the binned
// route the bucket rows vals[slot[s]] or cur[b_src[s]]).
template <typename T, typename Pay>
__global__ void min_superstep(int64_t n, int64_t C, int64_t W, int both,
                              Pay pay,
                              const int64_t* __restrict__ in_indptr,
                              const int32_t* __restrict__ in_order,
                              const int32_t* __restrict__ in_rows,
                              const T* __restrict__ gsrc,
                              const int64_t* __restrict__ out_indptr,
                              const int32_t* __restrict__ out_perm,
                              const int32_t* __restrict__ e_dst,
                              const uint8_t* __restrict__ me,
                              const uint8_t* __restrict__ mv,
                              const T* __restrict__ cur,
                              T* __restrict__ nxt,
                              uint8_t* __restrict__ halted,
                              uint8_t* __restrict__ done,
                              int32_t* __restrict__ busy,
                              unsigned int* __restrict__ ticket) {
    __shared__ int s_busy[kThreads];
    __shared__ bool s_last;
    __shared__ int s_all;
    const T MAXV = Pay::max();
    const int64_t CT = tile_cols(C);
    const int64_t R = blockDim.x / CT;
    const int t = threadIdx.x;
    const int64_t c = static_cast<int64_t>(blockIdx.y) * CT + t % CT;
    int nb = 0;
    if (c < C) {
        const bool hc = halted[c] != 0;
        const int64_t h = c / W;
        const int64_t stride = static_cast<int64_t>(gridDim.x) * R;
        for (int64_t i = static_cast<int64_t>(blockIdx.x) * R + t / CT; i < n;
             i += stride) {
            const int64_t k = i * C + c;
            const T old = cur[k];
            T agg = MAXV;
            const int64_t e1 = in_indptr[i + 1];
            for (int64_t j = in_indptr[i]; j < e1; ++j) {
                const int64_t e = in_order ? in_order[j] : j;
                if (me[e * C + c]) {
                    agg = tmin(agg, pay(gsrc[static_cast<int64_t>(in_rows[e])
                                             * C + c], e, h));
                }
            }
            if (both) {
                const int64_t j1 = out_indptr[i + 1];
                for (int64_t j = out_indptr[i]; j < j1; ++j) {
                    const int64_t e = out_perm[j];
                    if (me[e * C + c]) {
                        agg = tmin(agg, pay(cur[static_cast<int64_t>(e_dst[e])
                                                * C + c], e, h));
                    }
                }
            }
            const T nw = mv[k] ? tmin(old, agg) : MAXV;
            if (nw != old) nb = 1;
            nxt[k] = hc ? old : nw;
        }
    }
    s_busy[t] = nb;
    __syncthreads();
    if (t < CT && c < C) {
        int b = 0;
        for (int64_t j = 0; j < R; ++j) b |= s_busy[j * CT + t];
        busy[static_cast<int64_t>(blockIdx.x) * C + c] = b;
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

template <typename T, typename Pay>
int launch(int64_t n, int64_t C, int64_t W, int64_t gx, int64_t both, Pay pay,
           const void* in_indptr, const void* in_order, const void* in_rows,
           const void* gsrc, const void* out_indptr,
           const void* out_perm, const void* e_dst, const void* me,
           const void* mv, const void* cur, void* nxt, void* halted,
           void* done, void* busy, void* ticket, void* stream) {
    if (C > 0 && gx > 0) {
        const int64_t CT = tile_cols(C);
        const dim3 grid(static_cast<unsigned>(gx),
                        static_cast<unsigned>((C + CT - 1) / CT));
        min_superstep<T, Pay><<<grid, static_cast<unsigned>((kThreads / CT) * CT),
                                0, static_cast<cudaStream_t>(stream)>>>(
            n, C, W, static_cast<int>(both), pay,
            static_cast<const int64_t*>(in_indptr),
            static_cast<const int32_t*>(in_order),
            static_cast<const int32_t*>(in_rows),
            static_cast<const T*>(gsrc),
            static_cast<const int64_t*>(out_indptr),
            static_cast<const int32_t*>(out_perm),
            static_cast<const int32_t*>(e_dst),
            static_cast<const uint8_t*>(me), static_cast<const uint8_t*>(mv),
            static_cast<const T*>(cur), static_cast<T*>(nxt),
            static_cast<uint8_t*>(halted), static_cast<uint8_t*>(done),
            static_cast<int32_t*>(busy), static_cast<unsigned int*>(ticket));
    }
    return static_cast<int>(cudaGetLastError());
}

// K5-P/K6-P's bucket gather: vals[u, c] = cur[u_src[u], c].
template <typename T>
__global__ void bucket_gather(int64_t U, int64_t C,
                              const int32_t* __restrict__ u_src,
                              const T* __restrict__ cur,
                              T* __restrict__ vals) {
    const int64_t total = U * C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        const int64_t u = k / C;
        vals[k] = cur[static_cast<int64_t>(u_src[u]) * C + (k - u * C)];
    }
}

inline unsigned blocks_for(int64_t n) {
    int64_t b = (n + kThreads - 1) / kThreads;
    if (b < 1) b = 1;
    if (b > 132 * 32) b = 132 * 32;   // grid-stride loops cover the rest
    return static_cast<unsigned>(b);
}

// The binned superstep: the bucket gather (when U > 0) then the template
// over the layout's walks — in-edges of row i are its destination walk,
// gathering vals[slot[s]] (U > 0) or cur[b_src[s]]; out-edges its source
// walk, gathering cur[b_dst[s]]. Adds its launches to *launched.
template <typename T, typename Pay>
int binned(int64_t n, int64_t C, int64_t W, int64_t gx, int64_t both,
           int64_t U, Pay pay, const void* in_indptr, const void* in_order,
           const void* b_src, const void* slot, const void* u_src,
           const void* out_indptr, const void* out_order, const void* b_dst,
           const void* me, const void* mv, const void* cur, void* vals,
           void* nxt, void* halted, void* done, void* busy, void* ticket,
           void* stream, int64_t* launched) {
    if (C <= 0 || gx <= 0) return static_cast<int>(cudaGetLastError());
    const void* gsrc = cur;
    const void* rows = b_src;
    if (U > 0) {
        bucket_gather<T><<<blocks_for(U * C), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
            U, C, static_cast<const int32_t*>(u_src),
            static_cast<const T*>(cur), static_cast<T*>(vals));
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ++*launched;
        gsrc = vals;
        rows = slot;
    }
    const int err = launch<T, Pay>(n, C, W, gx, both, pay, in_indptr,
                                   in_order, rows, gsrc, out_indptr,
                                   out_order, b_dst, me, mv, cur, nxt,
                                   halted, done, busy, ticket, stream);
    if (err == 0) ++*launched;
    return err;
}

}  // namespace

extern "C" {

// K5: CC over both directions, int32 labels.
int rtpu_cc_superstep(int64_t n, int64_t C, int64_t gx, const void* in_indptr,
                      const void* e_src, const void* out_indptr,
                      const void* out_perm, const void* e_dst, const void* me,
                      const void* mv, const void* cur, void* nxt,
                      void* halted, void* done, void* busy, void* ticket,
                      void* stream) {
    return launch<int32_t>(n, C, 1, gx, 1, CcPay{}, in_indptr, nullptr,
                           e_src, cur, out_indptr, out_perm, e_dst, me, mv,
                           cur, nxt, halted, done, busy, ticket, stream);
}

// K6: BFS (ew == nullptr: unit weights) or SSSP (ew: [m_pad, H] f32, hop
// h = c / W), f32 distances; the out-pull only when undirected.
int rtpu_minplus_superstep(int64_t n, int64_t C, int64_t W, int64_t H,
                           int64_t gx, int64_t directed, const void* ew,
                           const void* in_indptr, const void* e_src,
                           const void* out_indptr, const void* out_perm,
                           const void* e_dst, const void* me, const void* mv,
                           const void* cur, void* nxt, void* halted,
                           void* done, void* busy, void* ticket,
                           void* stream) {
    const int64_t both = directed ? 0 : 1;
    if (ew == nullptr) {
        return launch<float>(n, C, W, gx, both, UnitPay{}, in_indptr,
                             nullptr, e_src, cur, out_indptr, out_perm, e_dst,
                             me, mv, cur, nxt, halted, done, busy, ticket,
                             stream);
    }
    return launch<float>(n, C, W, gx, both,
                         WeightPay{static_cast<const float*>(ew), H},
                         in_indptr, nullptr, e_src, cur, out_indptr,
                         out_perm, e_dst, me, mv, cur, nxt, halted, done,
                         busy, ticket, stream);
}

// K5-P: binned CC, both directions, int32 labels | n, C, gx, U (buckets,
// 0: no pre-aggregation) | in_indptr, in_order, b_src, slot, u_src,
// out_indptr, out_order, b_dst, me [B, C], mv, cur, vals [U, C] scratch,
// nxt, halted, done, busy, ticket, stream | launched.
int rtpu_binned_cc_superstep(int64_t n, int64_t C, int64_t gx, int64_t U,
                             const void* in_indptr, const void* in_order,
                             const void* b_src, const void* slot,
                             const void* u_src, const void* out_indptr,
                             const void* out_order, const void* b_dst,
                             const void* me, const void* mv, const void* cur,
                             void* vals, void* nxt, void* halted, void* done,
                             void* busy, void* ticket, void* stream,
                             int64_t* launched) {
    return binned<int32_t>(n, C, 1, gx, 1, U, CcPay{}, in_indptr, in_order,
                           b_src, slot, u_src, out_indptr, out_order, b_dst,
                           me, mv, cur, vals, nxt, halted, done, busy, ticket,
                           stream, launched);
}

// K6-P: binned BFS (ew null) or SSSP (ew [B, H] f32, binned), f32
// distances; the source walk only when undirected. Arguments as K5-P with
// W, H, directed and ew after gx.
int rtpu_binned_minplus_superstep(int64_t n, int64_t C, int64_t W, int64_t H,
                                  int64_t gx, int64_t directed, int64_t U,
                                  const void* ew, const void* in_indptr,
                                  const void* in_order, const void* b_src,
                                  const void* slot, const void* u_src,
                                  const void* out_indptr,
                                  const void* out_order, const void* b_dst,
                                  const void* me, const void* mv,
                                  const void* cur, void* vals, void* nxt,
                                  void* halted, void* done, void* busy,
                                  void* ticket, void* stream,
                                  int64_t* launched) {
    const int64_t both = directed ? 0 : 1;
    if (ew == nullptr) {
        return binned<float>(n, C, W, gx, both, U, UnitPay{}, in_indptr,
                             in_order, b_src, slot, u_src, out_indptr,
                             out_order, b_dst, me, mv, cur, vals, nxt,
                             halted, done, busy, ticket, stream, launched);
    }
    return binned<float>(n, C, W, gx, both, U,
                         WeightPay{static_cast<const float*>(ew), H},
                         in_indptr, in_order, b_src, slot, u_src, out_indptr,
                         out_order, b_dst, me, mv, cur, vals, nxt, halted,
                         done, busy, ticket, stream, launched);
}

}  // extern "C"
