// K2 — the edge passes of the column-batched PageRank power iteration.
//
// Replaces the two segment-sums of raphtory_tpu/engine/hopbatch.py:154
// `_pagerank_columns` (unbinned, untiled route), the second half of the
// jitted `_compiled_delta` program. C = H*W views run as columns of one
// pass; masks are bool [m_pad, C] / [n_pad, C], state is f32 [n_pad, C],
// both row-major. Edges are (dst, src)-sorted; pad edges are
// dst = src = n_pad-1 with every mask column False, and the destination CSR
// ends before them (indptr[n] = real edge count), so K2b never walks them:
// in one row they would serialise that row's threads for m_pad - m edges.
//
// K2a `rtpu_column_out_degree`, once per dispatch:
//     deg[src[e], c] += me[e, c]
// over unsorted sources, with int32 atomics into a zeroed [n_pad, C]
// scratch the wrapper converts to f32. Counts are integers, so the result
// is exact and deterministic whatever order the atomics land in — the same
// values as JAX's f32 segment-sum of 0/1 (exact below 2^24).
//
// K2b `rtpu_column_pull_sum`, once per superstep:
//     agg[d, c] = sum over e in [indptr[d], indptr[d+1]) of
//                 (me[e, c] ? rd[src[e], c] : 0)
// over the destination CSR. One thread per (d, c): neighbouring threads
// take neighbouring columns of one destination row (and the next row's), so
// a warp reads one edge's mask row and gathered state row as contiguous
// bytes. Each thread accumulates in edge order in an f32 register, with no
// atomics: the result is identical from run to run and follows the same
// sequential order as XLA's CPU sorted segment-sum, so the two agree to f32
// rounding. Empty rows write 0. A row's threads walk its whole edge run, so
// a destination with a very large in-degree serialises its warp — fine for
// the GAB shapes (in-degree ~10), an open item for power-law graphs.
//
// K2c `rtpu_pagerank_update`, once per superstep after K2b (and once per
// dispatch with `prime` set): the superstep epilogue of the loop body
// (hopbatch.py:259-266). Per (v, c):
//     new = mv ? (1-d)/n_act[c] + d*(agg + dangling[c]/n_act[c]) : 0
//     busy[c] |= mv && !(|new - r| < tol)        (the column's halting test)
//     r = halted[c] ? r : new                     (freeze halted columns)
//     rd = r * (1 / max(deg, 1))                  (next superstep's K2b input)
//     next dangling[c] += (mv && deg == 0) ? r : 0
// With `prime` the update is skipped: only rd and dangling are derived
// from the starting ranks. Each f32 operation is a separately rounded
// intrinsic (no FMA contraction), the rounding of the torch twin's ops.
// The two column reductions (dangling mass and halting) cross blocks: every
// block folds its rows per column in a fixed order and writes one partial
// per column; the last block to finish (an atomic ticket after a fence)
// sums the partials in block order, so the result is deterministic, writes
// dangling, halted and the all-halted flag the host reads, and resets the
// ticket for the next launch. Threads are laid out column-fastest (a block
// holds whole rows of up to 256 columns; wider C tiles the columns over
// blockIdx.y), so each thread keeps one column for its whole grid-stride
// loop and the per-column sums live in registers. The dangling sums run in
// f64 and round to f32 once per block partial and once at the end: over the
// capped grid a thread walks ~10^4 rows at n = 5.3M, C = 128, and an f32
// running sum that long drifts from the twin's sum past its tolerance.
//
// K2b-P `rtpu_binned_pull_sum` — the pull-sum of the destination-binned
// (PCPM) route, raphtory_tpu/engine/hopbatch.py:242-258. Edges are binned
// slots (ops/partition.py: B = P * cap, sorted (src, dst) within each
// destination partition, cap-pads with b_src = b_dst = n_pad-1 and valid
// False); me is [B, C]. With pre-aggregation (U = P * cap_u > 0) a first
// kernel gathers one state row per (partition, source) bucket,
//     vals[u, c] = rd[u_src[u], c]
// and the pull reads vals[slot[s], c]; without it the pull reads
// rd[b_src[s], c] (the reference's plain binned gather, destinations
// unsorted). Per (d, c):
//     agg[d, c] = sum over j in [in_indptr[d], in_indptr[d+1]) of
//                 (me[s, c] ? src_row(s)[c] : 0),   s = in_order[j]
// The walk (`in_indptr`/`in_order`, built once with the layout) lists each
// destination's real slots in source order — the order the engine's
// (dst, src)-sorted table visits them — so the sum adds the same values in
// the same order as K2b: the binned ranks equal the unbinned route's bit
// for bit. The cap-pad slots are in no walk, so they never reach row
// n_pad-1. No atomics. Bound: bytes — the mask (B * C), the walk and ids,
// the gathered rows (U * C * 4 read and written by the bucket gather, or
// the per-edge row gather) and agg written once. One launch, two with the
// bucket gather.
//
// What bounds them on the H100: bytes. Per superstep K2b streams the mask
// (m_pad * C bytes), the source ids (4 * m_pad) and the CSR offsets, and
// gathers C-wide f32 rows of rd (n_pad * C * 4 bytes, small enough at the
// headline shapes to stay in the 50 MB L2); it does one add per edge and
// column. K2a is one pass over the mask and the source ids. K2c reads agg,
// deg, mv and r and writes r and rd once: 21 bytes per (v, c) and a dozen
// flops. No kernel allocates; the wrapper zeros K2a's scratch and owns
// K2c's partials and ticket.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/columns.py).
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
    int64_t b = (n + kThreads - 1) / kThreads;
    if (b < 1) b = 1;
    if (b > 132 * 32) b = 132 * 32;   // grid-stride loops cover the rest
    return static_cast<unsigned>(b);
}

__global__ void column_out_degree(int64_t m, int64_t C,
                                  const uint8_t* __restrict__ me,
                                  const int32_t* __restrict__ src,
                                  int32_t* __restrict__ deg) {
    const int64_t total = m * C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        if (!me[k]) continue;
        const int64_t e = k / C;
        atomicAdd(deg + static_cast<int64_t>(src[e]) * C + (k - e * C), 1);
    }
}

__global__ void column_pull_sum(int64_t n, int64_t C,
                                const int64_t* __restrict__ indptr,
                                const int32_t* __restrict__ src,
                                const uint8_t* __restrict__ me,
                                const float* __restrict__ rd,
                                float* __restrict__ agg) {
    const int64_t total = n * C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        const int64_t d = k / C;
        const int64_t c = k - d * C;
        const int64_t e1 = indptr[d + 1];
        float acc = 0.0f;
        for (int64_t e = indptr[d]; e < e1; ++e) {
            if (me[e * C + c]) acc += rd[static_cast<int64_t>(src[e]) * C + c];
        }
        agg[k] = acc;
    }
}

// K2b-P's bucket gather: vals[u, c] = rd[u_src[u], c] (row copies).
__global__ void bucket_gather(int64_t U, int64_t C,
                              const int32_t* __restrict__ u_src,
                              const float* __restrict__ rd,
                              float* __restrict__ vals) {
    const int64_t total = U * C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        const int64_t u = k / C;
        vals[k] = rd[static_cast<int64_t>(u_src[u]) * C + (k - u * C)];
    }
}

// K2b-P's pull: rows[s] names the gathered row of slot s in `src`
// (slot[] into vals with pre-aggregation, b_src[] into rd without).
__global__ void binned_pull_sum(int64_t n, int64_t C,
                                const int64_t* __restrict__ indptr,
                                const int32_t* __restrict__ order,
                                const int32_t* __restrict__ rows,
                                const uint8_t* __restrict__ me,
                                const float* __restrict__ src,
                                float* __restrict__ agg) {
    const int64_t total = n * C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        const int64_t d = k / C;
        const int64_t c = k - d * C;
        const int64_t j1 = indptr[d + 1];
        float acc = 0.0f;
        for (int64_t j = indptr[d]; j < j1; ++j) {
            const int64_t s = order[j];
            if (me[s * C + c]) {
                acc = __fadd_rn(acc, src[static_cast<int64_t>(rows[s]) * C + c]);
            }
        }
        agg[k] = acc;
    }
}

// Columns per block tile of K2c (a block holds kThreads / tile rows); the
// wrapper sizes the partials from the same numbers (columns.update_grid).
__host__ __device__ inline int64_t update_tile(int64_t C) {
    return C < kThreads ? C : kThreads;
}

__global__ void pagerank_update(int64_t n, int64_t C, int prime,
                                float one_minus_d, float damping, float tol,
                                const float* __restrict__ agg,
                                const float* __restrict__ deg,
                                const uint8_t* __restrict__ mv,
                                const float* __restrict__ n_act,
                                float* __restrict__ r,
                                float* __restrict__ rd,
                                float* __restrict__ dangling,
                                uint8_t* __restrict__ halted,
                                uint8_t* __restrict__ done,
                                float* __restrict__ part,
                                int32_t* __restrict__ busy,
                                unsigned int* __restrict__ ticket) {
    __shared__ double s_dang[kThreads];
    __shared__ int s_busy[kThreads];
    __shared__ bool s_last;
    __shared__ int s_all;
    const int64_t CT = update_tile(C);
    const int64_t R = blockDim.x / CT;
    const int t = threadIdx.x;
    const int64_t cl = t % CT;
    const int64_t c = static_cast<int64_t>(blockIdx.y) * CT + cl;
    double dsum = 0.0;
    int nb = 0;
    if (c < C) {
        const float na = n_act[c];
        const float base = __fdiv_rn(one_minus_d, na);
        const float dn = __fdiv_rn(dangling[c], na);
        const bool hc = halted[c] != 0;
        const int64_t stride = static_cast<int64_t>(gridDim.x) * R;
        for (int64_t i = static_cast<int64_t>(blockIdx.x) * R + t / CT; i < n;
             i += stride) {
            const int64_t k = i * C + c;
            const bool alive = mv[k] != 0;
            float v = r[k];
            if (!prime) {
                const float nw = alive
                    ? __fadd_rn(base, __fmul_rn(damping, __fadd_rn(agg[k], dn)))
                    : 0.0f;
                if (alive && !(fabsf(__fsub_rn(nw, v)) < tol)) nb = 1;
                if (!hc) v = nw;
                r[k] = v;
            }
            const float dg = deg[k];
            rd[k] = __fmul_rn(v, __fdiv_rn(1.0f, fmaxf(dg, 1.0f)));
            if (alive && dg == 0.0f) dsum += v;
        }
    }
    s_dang[t] = dsum;
    s_busy[t] = nb;
    __syncthreads();
    if (t < CT && c < C) {
        double acc = 0.0;
        int b = 0;
        for (int64_t j = 0; j < R; ++j) {
            acc += s_dang[j * CT + t];
            b |= s_busy[j * CT + t];
        }
        part[static_cast<int64_t>(blockIdx.x) * C + c] =
            static_cast<float>(acc);
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
        double acc = 0.0;
        int b = 0;
        for (int64_t bx = 0; bx < gridDim.x; ++bx) {
            acc += __ldcg(part + bx * C + cc);
            b |= __ldcg(busy + bx * C + cc);
        }
        dangling[cc] = static_cast<float>(acc);
        uint8_t h = halted[cc];
        if (!prime && !b) h = 1;
        halted[cc] = h;
        if (!h) s_all = 0;   // every writer stores the same 0
    }
    __syncthreads();
    if (t == 0) {
        done[0] = static_cast<uint8_t>(s_all);
        *ticket = 0u;
    }
}

}  // namespace

extern "C" {

int rtpu_column_out_degree(int64_t m, int64_t C, const void* me,
                           const void* src, void* deg, void* stream) {
    if (m > 0 && C > 0) {
        column_out_degree<<<blocks_for(m * C), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
            m, C, static_cast<const uint8_t*>(me),
            static_cast<const int32_t*>(src), static_cast<int32_t*>(deg));
    }
    return static_cast<int>(cudaGetLastError());
}

int rtpu_column_pull_sum(int64_t n, int64_t C, const void* indptr,
                         const void* src, const void* me, const void* rd,
                         void* agg, void* stream) {
    if (n > 0 && C > 0) {
        column_pull_sum<<<blocks_for(n * C), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
            n, C, static_cast<const int64_t*>(indptr),
            static_cast<const int32_t*>(src),
            static_cast<const uint8_t*>(me), static_cast<const float*>(rd),
            static_cast<float*>(agg));
    }
    return static_cast<int>(cudaGetLastError());
}

int rtpu_pagerank_update(int64_t n, int64_t C, int64_t gx, int64_t prime,
                         float one_minus_d, float damping, float tol,
                         const void* agg, const void* deg, const void* mv,
                         const void* n_act, void* r, void* rd,
                         void* dangling, void* halted, void* done, void* part,
                         void* busy, void* ticket, void* stream) {
    if (C > 0 && gx > 0) {
        const int64_t CT = update_tile(C);
        const dim3 grid(static_cast<unsigned>(gx),
                        static_cast<unsigned>((C + CT - 1) / CT));
        pagerank_update<<<grid, static_cast<unsigned>((kThreads / CT) * CT),
                          0, static_cast<cudaStream_t>(stream)>>>(
            n, C, static_cast<int>(prime), one_minus_d, damping, tol,
            static_cast<const float*>(agg), static_cast<const float*>(deg),
            static_cast<const uint8_t*>(mv), static_cast<const float*>(n_act),
            static_cast<float*>(r), static_cast<float*>(rd),
            static_cast<float*>(dangling), static_cast<uint8_t*>(halted),
            static_cast<uint8_t*>(done), static_cast<float*>(part),
            static_cast<int32_t*>(busy), static_cast<unsigned int*>(ticket));
    }
    return static_cast<int>(cudaGetLastError());
}

// K2b-P: n rows, C columns, U buckets (0: no pre-aggregation) | in_indptr
// [n+1] int64, in_order [m] int32, b_src, slot [B] int32, u_src [U] int32,
// me [B, C], rd [n, C] f32 | vals [U, C] f32 scratch (unused when U = 0),
// agg [n, C]. Adds the kernels it launched to *launched.
int rtpu_binned_pull_sum(int64_t n, int64_t C, int64_t U,
                         const void* in_indptr, const void* in_order,
                         const void* b_src, const void* slot,
                         const void* u_src, const void* me, const void* rd,
                         void* vals, void* agg, void* stream,
                         int64_t* launched) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
    const float* src = static_cast<const float*>(rd);
    const void* rows = b_src;
    if (U > 0) {
        bucket_gather<<<blocks_for(U * C), kThreads, 0, st>>>(
            U, C, static_cast<const int32_t*>(u_src), src,
            static_cast<float*>(vals));
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ++*launched;
        src = static_cast<const float*>(vals);
        rows = slot;
    }
    binned_pull_sum<<<blocks_for(n * C), kThreads, 0, st>>>(
        n, C, static_cast<const int64_t*>(in_indptr),
        static_cast<const int32_t*>(in_order),
        static_cast<const int32_t*>(rows), static_cast<const uint8_t*>(me),
        src, static_cast<float*>(agg));
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
    return static_cast<int>(e);
}

}  // extern "C"
