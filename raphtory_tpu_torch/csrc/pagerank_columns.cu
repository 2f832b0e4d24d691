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
//     deg[v, c] = number of e with src[e] = v and me[e, c]
// over a SOURCE walk (`out_indptr [n+1]`, `out_order [m]`): each source
// row's real edge rows, one contiguous run a row (GlobalTables' `out_perm`,
// a layout's `walk(reverse=True)`, or the bulk graph's stable sort of its
// sources, ops/columns.py `source_walk`). The reference scatter-adds 0/1
// into a segment-sum by source; edges are (dst, src)-sorted, so a scatter
// hits source rows at random, and at the scale shape the [n_pad, C] counts
// (2.7 GB) are far past the L2: the parent kernel's int32 atomics paid a
// DRAM read and write-back a live sector, into a zero-filled scratch that
// a second pass converted to f32 (18.2 ms against a 2.13 ms bound). Walked
// by source, the count is a gather: a group of lanes owns a source row, 4
// columns a lane, and reads each out-edge's mask row (one 128-byte line at
// C 128, a 32-bit word a lane) with kDegBatch (8) entries in flight, counts
// in registers, and writes its f32 counts once (16-byte stores): no
// atomics, no scratch, no conversion pass. Counts are integers below 2^24,
// so the f32 result is exact in any order — the bits of JAX's f32
// segment-sum of 0/1. A source with a very large out-degree serialises its
// group, as a large in-degree does K2b's.
//
// K2b `rtpu_column_pull_sum`, once per superstep:
//     agg[d, c] = sum over e in [indptr[d], indptr[d+1]) of
//                 (me[e, c] ? rd[src[e], c] : 0)
// over the destination CSR: K2b-P's kernel (below) with the walk entry j
// read as the pair (src[j], j) straight from the source ids — 4 bytes an
// entry, no pair array: on the (dst, src)-sorted table the CSR's j-th
// entry IS edge j. So K2b has K2b-P's layout (a lane group a row, 4
// columns a lane, kPullBatch rd segments staged with cp.async) and its sum
// order — __fadd_rn in edge order, the sequential order of XLA's CPU sorted
// segment-sum — and the binned and unbinned ranks stay equal bit for bit.
// (The parent kernel, one thread a (row, column) with one-byte mask loads
// and one gather in flight, took 10.2 ms a superstep at the scale shape
// against a 2.96 ms table bound.) Empty rows write 0. A row walks its
// whole edge run, so a very large in-degree serialises its group.
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
//   Layout: a thread owns 4 adjacent columns of a row (a "quad"): one
// 16-byte load each of agg, deg and r, one 32-bit load of mv's 4 bytes,
// 16-byte stores of r and rd — or, where C % 4 != 0 or a tensor is not
// 16-byte aligned, the same per element. A block holds whole rows of up to
// 256 quads (wider C tiles the quads over blockIdx.y), rows fastest after
// quads, so a warp reads one contiguous span; each thread walks its rows
// with a grid stride, kUpdateRows (4) rows loaded before any is used — 52
// bytes a row in flight a thread. Those registers (~120 a thread) leave 2
// blocks resident an SM, so the grid is columns.update_grid(n, C) blocks
// along the rows: 2 an SM of the 132 at most, fewer when n gives a thread
// fewer than 4 rows — a function of (n, C) alone, so every sum below has
// one order for a shape. (On the H100, 4 blocks an SM with one row a
// thread ran as fast at the scale shape and slower at the headline's; 4
// rows a thread at 4 blocks an SM spilled registers and ran far slower.)
//   The two column reductions (dangling mass and halting) cross blocks:
// every block folds its threads' per-column sums in a fixed tree (f64 for
// the dangling mass) and writes one f64 partial and one busy word per
// column; the last block to finish (an atomic ticket after a fence) splits
// each column's gx partials into fixed chunks over all its threads, each
// summed in block order, and combines the chunks in chunk order in shared
// memory. So the result does not depend on block scheduling and is
// identical from launch to launch; the last block writes dangling (rounded
// to f32 once), halted and the all-halted flag the host reads, and resets
// the ticket for the next launch.
//
// K2b-P `rtpu_binned_pull_sum` — the pull-sum of the destination-binned
// (PCPM) route, raphtory_tpu/engine/hopbatch.py:242-258. Edges are binned
// slots (ops/partition.py: B = P * cap, sorted (src, dst) within each
// destination partition, cap-pads with b_src = b_dst = n_pad-1 and valid
// False); me is [B, C]. Per (d, c):
//     agg[d, c] = sum over j in [in_indptr[d], in_indptr[d+1]) of
//                 (me[s, c] ? rd[b_src[s], c] : 0),   s = in_order[j]
// The walk (`in_indptr`/`in_order`, built once with the layout) lists each
// destination's real slots in source order — the order the engine's
// (dst, src)-sorted table visits them — and the sum adds in walk order
// with __fadd_rn, so the binned ranks equal the unbinned route's (K2b) bit
// for bit. The cap-pad slots are in no walk. The TPU kernel first gathers
// one state row per (partition, source) bucket when the layout
// pre-aggregates; on this card that is a [U, C] copy written and read
// again each superstep (and at the scale shape the layout does not
// pre-aggregate at all), so each slot reads rd at its source row directly:
// the walk arrives as `pairs [m]`, one (source row b_src[s], slot s) int32
// pair a walk entry, derived once per layout on the device
// (ops/columns.py `binned_pull_walk`, which checks that b_src[s] is the
// bucket's source u_src[slot[s]] on a pre-aggregating layout). One launch.
//   Layout: a group of G lanes owns one destination row (G = ceil(C/4) up
// to 32; wider C tiles the columns over blockIdx.y, 128 a tile), each lane
// 4 adjacent columns. A lane takes kPullBatch (6) walk entries at a time:
// their pairs (the group's lanes read the same 8 bytes), then each one's
// 32-bit mask word, then each one's 16-byte rd segment copied with
// cp.async into the lane's own slots in shared memory — a zero-byte copy
// where the mask word is 0, which reads nothing — all issued before the
// first add, so up to 6 row gathers a lane are in flight while the
// staged rows, not registers, hold them (44 registers: 5 blocks an SM).
// Each lane reads back only what it copied, so no barrier. (Held in
// registers instead, 8 entries took 80 registers and ran slower on the
// H100 at the scale shape, and so did 2 to 4.) C % 4 != 0 or an unaligned
// tensor takes the same walk per element from registers. No atomics.
//
// What bounds them on the H100: bytes. Per superstep K2b and K2b-P read
// the live mask rows (m * C bytes), the walk (4 bytes an edge for K2b, 8 a
// slot for K2b-P's pairs) and the CSR offsets, write agg once, and gather
// 16 bytes of rd per live (edge, quad); at the headline shapes rd stays in
// the 50 MB L2, at the scale shape (2.7 GB) it is far past it, so the
// gathers — counted in the 32-byte sectors they touch — set their pace. K2a
// reads the walk, each walked edge's mask row and the offsets, and writes
// deg once. K2c reads agg, deg, mv and r and writes r and rd once: 21
// bytes per (v, c) and a dozen flops. No kernel allocates; the wrapper owns
// K2c's partials and ticket.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/columns.py).
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------ K2b, K2b-P, K2a

constexpr int kPullBatch = 6;     // walk entries a lane keeps in flight
constexpr int kPullTile = 128;    // columns of a lane group: 32 lanes x 4

// 16 bytes global -> shared, of which the first `bytes` (16 or 0) are read
// and the rest zero-filled: a copy with bytes 0 reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}

// lanes a destination row (its group) for C columns
__host__ __device__ inline int pull_group(int64_t C) {
    const int64_t q = (C + 3) / 4;
    return q < 32 ? static_cast<int>(q) : 32;
}

// the mask bytes of columns [c, c + 4) of slot s as one word (byte b set
// where column c + b is), columns past C 0
template <bool VEC>
__device__ __forceinline__ uint32_t mask_word(const uint8_t* __restrict__ me,
                                              int64_t s, int64_t C,
                                              int64_t c) {
    const uint8_t* p = me + s * C + c;
    if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(p));
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (c + b < C && p[b]) w |= 1u << (8 * b);
    return w;
}

// acc[b] += v[b] where byte b of the mask word is set
__device__ __forceinline__ void add_masked(float (&acc)[4], uint32_t w,
                                           const float (&v)[4]) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if ((w >> (8 * b)) & 0xffu) acc[b] = __fadd_rn(acc[b], v[b]);
}

// a lane's 4 columns [c, c + 4) of a row written once: one 16-byte store,
// or per element (columns past C dropped)
template <bool VEC>
__device__ __forceinline__ void store_quad(float* __restrict__ out,
                                           int64_t C, int64_t c,
                                           const float (&x)[4]) {
    if (VEC) {
        *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
            if (c + b < C) out[b] = x[b];
    }
}

// the pull-sum of K2b (PAIRS false: walk entry j is the pair (src[j], j),
// `walk` the int32 source ids of the (dst, src)-sorted table) and K2b-P
// (PAIRS: `walk` the int2 pairs (source row, slot) of the layout's walk)
template <bool VEC, bool PAIRS>
__global__ void __launch_bounds__(kThreads) pull_sum(
        int64_t n, int64_t C, int G, const int64_t* __restrict__ indptr,
        const void* __restrict__ walk, const uint8_t* __restrict__ me,
        const float* __restrict__ rd, float* __restrict__ agg) {
    // a lane's staged rd segments: entry k at stage[k * kThreads + thread]
    __shared__ float4 stage[kPullBatch * kThreads];
    const int64_t d = static_cast<int64_t>(blockIdx.x) * (blockDim.x / G)
                      + threadIdx.x / G;
    const int64_t c = static_cast<int64_t>(blockIdx.y) * kPullTile
                      + 4 * (threadIdx.x % G);
    if (d >= n || c >= C) return;
    const int2* __restrict__ pairs = static_cast<const int2*>(walk);
    const int32_t* __restrict__ src = static_cast<const int32_t*>(walk);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int64_t j1 = indptr[d + 1];
    for (int64_t j = indptr[d]; j < j1; j += kPullBatch) {
        const int64_t cnt = j1 - j;
        int2 p[kPullBatch];
#pragma unroll
        for (int k = 0; k < kPullBatch; ++k) {
            if (PAIRS)
                p[k] = k < cnt ? __ldg(pairs + j + k) : make_int2(0, 0);
            else
                p[k] = make_int2(k < cnt ? __ldg(src + j + k) : 0, 0);
        }
        uint32_t w[kPullBatch];
#pragma unroll
        for (int k = 0; k < kPullBatch; ++k)
            w[k] = k < cnt ? mask_word<VEC>(me, PAIRS ? p[k].y : j + k, C, c)
                           : 0u;
        // the adds run in walk order: the (dst, src) edge order
        if (VEC) {
            // every entry's 16 bytes staged in shared memory at once (an
            // entry whose mask word is 0 reads nothing), then added
            float4* mine = stage + threadIdx.x;
#pragma unroll
            for (int k = 0; k < kPullBatch; ++k)
                cp_async16(mine + k * kThreads,
                           rd + static_cast<int64_t>(p[k].x) * C + c,
                           w[k] ? 16 : 0);
            asm volatile("cp.async.commit_group;\n" ::: "memory");
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
            for (int k = 0; k < kPullBatch; ++k) {
                const float4 x = mine[k * kThreads];
                const float v[4] = {x.x, x.y, x.z, x.w};
                add_masked(acc, w[k], v);
            }
        } else {
            float v[kPullBatch][4];
#pragma unroll
            for (int k = 0; k < kPullBatch; ++k) {
                const float* row = rd + static_cast<int64_t>(p[k].x) * C + c;
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    v[k][b] = (w[k] >> (8 * b)) & 0xffu ? row[b] : 0.0f;
            }
#pragma unroll
            for (int k = 0; k < kPullBatch; ++k) add_masked(acc, w[k], v[k]);
        }
    }
    store_quad<VEC>(agg + d * C + c, C, c, acc);
}

constexpr int kDegBatch = 8;      // K2a's walk entries a lane keeps in flight

// K2a: a group of G lanes a source row, 4 columns a lane, over the source
// walk; counts in registers, written once
template <bool VEC>
__global__ void __launch_bounds__(kThreads) out_degree(
        int64_t n, int64_t C, int G, const int64_t* __restrict__ indptr,
        const int32_t* __restrict__ order, const uint8_t* __restrict__ me,
        float* __restrict__ deg) {
    const int64_t v = static_cast<int64_t>(blockIdx.x) * (blockDim.x / G)
                      + threadIdx.x / G;
    const int64_t c = static_cast<int64_t>(blockIdx.y) * kPullTile
                      + 4 * (threadIdx.x % G);
    if (v >= n || c >= C) return;
    unsigned cnt[4] = {0u, 0u, 0u, 0u};
    const int64_t j1 = indptr[v + 1];
    for (int64_t j = indptr[v]; j < j1; j += kDegBatch) {
        const int64_t left = j1 - j;
        int32_t e[kDegBatch];
#pragma unroll
        for (int k = 0; k < kDegBatch; ++k)
            e[k] = k < left ? __ldg(order + j + k) : 0;
        uint32_t w[kDegBatch];
#pragma unroll
        for (int k = 0; k < kDegBatch; ++k)
            w[k] = k < left ? mask_word<VEC>(me, e[k], C, c) : 0u;
#pragma unroll
        for (int k = 0; k < kDegBatch; ++k) {
#pragma unroll
            for (int b = 0; b < 4; ++b)
                cnt[b] += (w[k] >> (8 * b)) & 0xffu ? 1u : 0u;
        }
    }
    // integer counts below 2^24: exact in f32
    const float out[4] = {static_cast<float>(cnt[0]),
                          static_cast<float>(cnt[1]),
                          static_cast<float>(cnt[2]),
                          static_cast<float>(cnt[3])};
    store_quad<VEC>(deg + v * C + c, C, c, out);
}

// ---------------------------------------------------------------- K2c

constexpr int kUpdateRows = 4;    // rows a thread loads before using any

// quads (4 columns) a block row holds; the wrapper sizes the partials from
// the same numbers (columns.update_grid)
__host__ __device__ inline int64_t update_tile(int64_t C) {
    const int64_t q = (C + 3) / 4;
    return q < kThreads ? q : kThreads;
}

// one row's 4 columns as K2c reads them
struct Quad {
    float a[4], g[4], r[4];
    uint32_t m;
};

template <bool VEC>
__device__ __forceinline__ void load_quad(Quad& x, int64_t k, int64_t C,
                                          int64_t c, bool prime,
                                          const float* __restrict__ agg,
                                          const float* __restrict__ deg,
                                          const uint8_t* __restrict__ mv,
                                          const float* __restrict__ r) {
    if (VEC) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(deg + k));
        const float4 v = *reinterpret_cast<const float4*>(r + k);
        x.g[0] = g.x; x.g[1] = g.y; x.g[2] = g.z; x.g[3] = g.w;
        x.r[0] = v.x; x.r[1] = v.y; x.r[2] = v.z; x.r[3] = v.w;
        x.m = __ldg(reinterpret_cast<const unsigned int*>(mv + k));
        if (!prime) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(agg + k));
            x.a[0] = a.x; x.a[1] = a.y; x.a[2] = a.z; x.a[3] = a.w;
        }
    } else {
        x.m = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const bool in = c + b < C;
            x.g[b] = in ? deg[k + b] : 1.0f;
            x.r[b] = in ? r[k + b] : 0.0f;
            if (in && mv[k + b]) x.m |= 1u << (8 * b);
            if (!prime) x.a[b] = in ? agg[k + b] : 0.0f;
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2) pagerank_update(
        int64_t n, int64_t C, int prime, float one_minus_d, float damping,
        float tol, const float* __restrict__ agg,
        const float* __restrict__ deg, const uint8_t* __restrict__ mv,
        const float* __restrict__ n_act, float* __restrict__ r,
        float* __restrict__ rd, float* __restrict__ dangling,
        uint8_t* __restrict__ halted, uint8_t* __restrict__ done,
        double* __restrict__ part, int32_t* __restrict__ busy,
        unsigned int* __restrict__ ticket) {
    __shared__ double s_dang[4 * kThreads];
    __shared__ int s_busy[kThreads];
    __shared__ bool s_last;
    __shared__ int s_all;
    const int64_t QT = update_tile(C);
    const int64_t R = blockDim.x / QT;
    const int t = threadIdx.x;
    const int64_t row0 = t / QT;
    const int64_t c = 4 * (static_cast<int64_t>(blockIdx.y) * QT + t % QT);
    double dsum[4] = {0.0, 0.0, 0.0, 0.0};
    int nb = 0;   // bit b: column c + b not converged in this thread's rows
    if (c < C) {
        float base[4], dn[4];
        bool hc[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int64_t cc = c + b < C ? c + b : c;
            const float na = n_act[cc];
            base[b] = __fdiv_rn(one_minus_d, na);
            dn[b] = __fdiv_rn(dangling[cc], na);
            hc[b] = halted[cc] != 0;
        }
        const int64_t stride = static_cast<int64_t>(gridDim.x) * R;
        for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * R + row0; i0 < n;
             i0 += kUpdateRows * stride) {
            Quad x[kUpdateRows];
#pragma unroll
            for (int u = 0; u < kUpdateRows; ++u) {
                const int64_t i = i0 + u * stride;
                if (i < n)
                    load_quad<VEC>(x[u], i * C + c, C, c, prime, agg, deg, mv,
                                   r);
            }
#pragma unroll
            for (int u = 0; u < kUpdateRows; ++u) {
                const int64_t i = i0 + u * stride;
                if (i >= n) break;
                float v[4], o[4];
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const bool alive = (x[u].m >> (8 * b)) & 0xffu;
                    v[b] = x[u].r[b];
                    if (!prime) {
                        const float nw = alive
                            ? __fadd_rn(base[b], __fmul_rn(
                                  damping, __fadd_rn(x[u].a[b], dn[b])))
                            : 0.0f;
                        if (alive && !(fabsf(__fsub_rn(nw, v[b])) < tol))
                            nb |= 1 << b;
                        if (!hc[b]) v[b] = nw;
                    }
                    const float dg = x[u].g[b];
                    o[b] = __fmul_rn(v[b], __fdiv_rn(1.0f, fmaxf(dg, 1.0f)));
                    if (alive && dg == 0.0f) dsum[b] += v[b];
                }
                const int64_t k = i * C + c;
                if (VEC) {
                    if (!prime)
                        *reinterpret_cast<float4*>(r + k) =
                            make_float4(v[0], v[1], v[2], v[3]);
                    *reinterpret_cast<float4*>(rd + k) =
                        make_float4(o[0], o[1], o[2], o[3]);
                } else {
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        if (c + b >= C) break;
                        if (!prime) r[k + b] = v[b];
                        rd[k + b] = o[b];
                    }
                }
            }
        }
    }
    // the block's rows per column: a fixed tree over its R row groups
#pragma unroll
    for (int b = 0; b < 4; ++b) s_dang[4 * t + b] = dsum[b];
    s_busy[t] = nb;
    __syncthreads();
    int64_t h = 1;
    while (h < R) h <<= 1;
    for (h >>= 1; h > 0; h >>= 1) {
        if (row0 < h && row0 + h < R) {
            const int o = t + static_cast<int>(h * QT);
#pragma unroll
            for (int b = 0; b < 4; ++b) s_dang[4 * t + b] += s_dang[4 * o + b];
            s_busy[t] |= s_busy[o];
        }
        __syncthreads();
    }
    if (row0 == 0 && c < C) {
        const int64_t at = static_cast<int64_t>(blockIdx.x) * C + c;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            if (c + b >= C) break;
            part[at + b] = s_dang[4 * t + b];
            busy[at + b] = (s_busy[t] >> b) & 1;
        }
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
    // every column's gx partials in K fixed chunks of L, one thread a
    // (column, chunk), summed in block order; then the chunks in order
    const int64_t nt = blockDim.x;
    const int64_t gx = gridDim.x;
    const int64_t CP = C < nt ? C : nt;
    const int64_t K = nt / CP;
    const int64_t L = (gx + K - 1) / K;
    const int64_t cl = t % CP, kc = t / CP;
    for (int64_t p0 = 0; p0 < C; p0 += CP) {
        const int64_t cc = p0 + cl;
        double acc = 0.0;
        int bz = 0;
        if (kc < K && cc < C) {
            const int64_t b1 = (kc + 1) * L < gx ? (kc + 1) * L : gx;
            for (int64_t bx = kc * L; bx < b1; ++bx) {
                acc += __ldcg(part + bx * C + cc);
                bz |= __ldcg(busy + bx * C + cc);
            }
        }
        if (K > 1) {
            __syncthreads();   // the previous pass has read its sums
            s_dang[t] = acc;
            s_busy[t] = bz;
            __syncthreads();
            if (kc == 0) {
                for (int64_t k = 1; k < K; ++k) {
                    acc += s_dang[k * CP + cl];
                    bz |= s_busy[k * CP + cl];
                }
            }
        }
        if (kc == 0 && cc < C) {
            dangling[cc] = static_cast<float>(acc);
            uint8_t hl = halted[cc];
            if (!prime && !bz) hl = 1;
            halted[cc] = hl;
            if (!hl) s_all = 0;   // every writer stores the same 0
        }
    }
    __syncthreads();
    if (t == 0) {
        done[0] = static_cast<uint8_t>(s_all);
        *ticket = 0u;
    }
}

bool aligned(const void* p, uintptr_t to) {
    return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

// K2b / K2b-P: a lane group a row, ceil(C / 128) column tiles
template <bool PAIRS>
int launch_pull(int64_t n, int64_t C, const void* indptr, const void* walk,
                const void* me, const void* rd, void* agg, void* stream) {
    if (n > 0 && C > 0) {
        const int G = pull_group(C);
        const int rows = kThreads / G;
        const dim3 grid(static_cast<unsigned>((n + rows - 1) / rows),
                        static_cast<unsigned>((C + kPullTile - 1)
                                              / kPullTile));
        const bool vec = C % 4 == 0 && aligned(me, 4) && aligned(rd, 16)
                         && aligned(agg, 16);
        auto* f = vec ? pull_sum<true, PAIRS> : pull_sum<false, PAIRS>;
        f<<<grid, static_cast<unsigned>(rows * G), 0,
            static_cast<cudaStream_t>(stream)>>>(
            n, C, G, static_cast<const int64_t*>(indptr), walk,
            static_cast<const uint8_t*>(me), static_cast<const float*>(rd),
            static_cast<float*>(agg));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2a: n rows, C columns | out_indptr [n+1] int64, out_order [m] int32
// (the source walk: each source row's real edge rows), me [rows, C] bool |
// deg [n, C] f32. One launch.
int rtpu_column_out_degree(int64_t n, int64_t C, const void* out_indptr,
                           const void* out_order, const void* me, void* deg,
                           void* stream) {
    if (n > 0 && C > 0) {
        const int G = pull_group(C);
        const int rows = kThreads / G;
        const dim3 grid(static_cast<unsigned>((n + rows - 1) / rows),
                        static_cast<unsigned>((C + kPullTile - 1)
                                              / kPullTile));
        const bool vec = C % 4 == 0 && aligned(me, 4) && aligned(deg, 16);
        auto* f = vec ? out_degree<true> : out_degree<false>;
        f<<<grid, static_cast<unsigned>(rows * G), 0,
            static_cast<cudaStream_t>(stream)>>>(
            n, C, G, static_cast<const int64_t*>(out_indptr),
            static_cast<const int32_t*>(out_order),
            static_cast<const uint8_t*>(me), static_cast<float*>(deg));
    }
    return static_cast<int>(cudaGetLastError());
}

// K2b: n rows, C columns | indptr [n+1] int64 (the destination CSR of the
// (dst, src)-sorted table), src [m_pad] int32, me [m_pad, C] bool, rd
// [n, C] f32 | agg [n, C] f32. One launch.
int rtpu_column_pull_sum(int64_t n, int64_t C, const void* indptr,
                         const void* src, const void* me, const void* rd,
                         void* agg, void* stream) {
    return launch_pull<false>(n, C, indptr, src, me, rd, agg, stream);
}

// K2c: n rows, C columns, gx blocks along the rows (columns.update_grid),
// prime | 1 - damping, damping, tol | agg (unused with prime), deg, mv,
// n_act, r, rd, dangling, halted, done, part [gx, C] f64, busy [gx, C]
// int32, ticket, stream.
int rtpu_pagerank_update(int64_t n, int64_t C, int64_t gx, int64_t prime,
                         float one_minus_d, float damping, float tol,
                         const void* agg, const void* deg, const void* mv,
                         const void* n_act, void* r, void* rd,
                         void* dangling, void* halted, void* done, void* part,
                         void* busy, void* ticket, void* stream) {
    if (C > 0 && gx > 0) {
        const int64_t QT = update_tile(C);
        const dim3 grid(static_cast<unsigned>(gx),
                        static_cast<unsigned>(((C + 3) / 4 + QT - 1) / QT));
        const unsigned threads = static_cast<unsigned>((kThreads / QT) * QT);
        const bool vec = C % 4 == 0 && aligned(deg, 16) && aligned(r, 16)
                         && aligned(rd, 16) && aligned(mv, 4)
                         && (prime || aligned(agg, 16));
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        auto* f = vec ? pagerank_update<true> : pagerank_update<false>;
        f<<<grid, threads, 0, st>>>(
            n, C, static_cast<int>(prime), one_minus_d, damping, tol,
            static_cast<const float*>(agg), static_cast<const float*>(deg),
            static_cast<const uint8_t*>(mv), static_cast<const float*>(n_act),
            static_cast<float*>(r), static_cast<float*>(rd),
            static_cast<float*>(dangling), static_cast<uint8_t*>(halted),
            static_cast<uint8_t*>(done), static_cast<double*>(part),
            static_cast<int32_t*>(busy), static_cast<unsigned int*>(ticket));
    }
    return static_cast<int>(cudaGetLastError());
}

// K2b-P: n rows, C columns | in_indptr [n+1] int64 (the layout's
// destination walk), pairs [m, 2] int32 (each walk entry's source row
// b_src[s] and slot s), me [B, C], rd [n, C] f32 | agg [n, C] f32. One
// launch.
int rtpu_binned_pull_sum(int64_t n, int64_t C, const void* in_indptr,
                         const void* pairs, const void* me, const void* rd,
                         void* agg, void* stream) {
    return launch_pull<true>(n, C, in_indptr, pairs, me, rd, agg, stream);
}

}  // extern "C"
