// K1 — per-hop fold-state rebuild and window masks of the hop-batched
// columnar engine.
//
// Replaces raphtory_tpu/engine/hopbatch.py:66 `_masks_from_deltas`, the
// first half of the jitted `_compiled_delta` program. For each hop h of a
// dispatch it scatter-SETS hop h's touched-entity deltas (pos, lat, alive)
// into the running state (hop 0 only when `h0`: the base is then the
// previous dispatch's device-resident advanced state and delta[0] is the
// catch-up), then writes the hop's W window columns
//     out[i, h*W + w] = alive[i] && (w_col < 0 || lat[i] >= lo[h*W + w])
// straight into the entity-major [len, H*W] bool output. The running state
// is updated in place: after the last hop it IS the advanced base the caller
// keeps resident for the next dispatch.
//
// What bounds it on the H100: bytes. Per hop it reads the state (len *
// (sizeof(T) + 1) bytes, from L2 after the first hop at the headline shapes)
// and writes len * W mask bytes; the scatter moves O(delta) bytes. There is
// no arithmetic to speak of. The design keeps the hop loop on the host side
// of one C call (2 launches per hop on one stream, 2H-1 without `h0`, so
// hop h's scatter is ordered before its columns and after hop h-1's; the
// call reports how many kernels it launched), lets each column thread
// write one output byte with neighbouring threads on neighbouring bytes of
// one row, and never materialises the per-hop [H, len] state columns the
// host-column route ships. Within one hop the host fold emits each touched
// position once, so the scatter-set is race-free and deterministic. Pad
// rows carry position 2^31-1 and are skipped explicitly (JAX drops them
// with mode="drop").
//
// K6w — the weight-state rebuild of weighted SSSP, the same scatter with
// f32 values and no window compare. Replaces raphtory_tpu/engine/
// hopbatch.py:374-384 (inside `_compiled_delta`): for each hop h it
// scatter-sets hop h's (pos, val) weight deltas into the running weight
// state (hop 0 only with `h0`; pad positions skipped as above; the host
// removes duplicate positions within a hop, last wins) and writes the
// state as column h of the [len, H] weight block the K6 superstep reads
// (minplus_columns.cu). The state is updated in place and is the advanced
// weight state the caller keeps resident. Bound: bytes, len * 4 per hop
// written plus the delta rows; 2 launches per hop (2H-1 without `h0`).
//
// K3 — host fold columns to window masks (the host-column route). Replaces
// raphtory_tpu/engine/hopbatch.py:50 `_column_masks`, the head of the
// jitted `_compiled`, `_compiled_cc` and `_compiled_bfs` programs: from the
// hop-major [H, len] fold columns (lat, alive) the host fold built,
//     out[i, c] = alive[hop_of_col[c], i]
//                 && (nowin[c] || lat[hop_of_col[c], i] >= lo[c])
// into the entity-major [len, C] bool layout the superstep kernels read.
// Edges and vertices share one launch. What bounds it: bytes — the columns
// are read once (H * len * (sizeof(T) + 1)) and the masks written once
// (len * C); no arithmetic to speak of. The read runs along entities and
// the write along columns, so the design is a tiled transpose: a block
// owns one 32-column tile (its hops, bounds and flags read once into
// shared memory, so no mask byte pays a division) and strides over
// 32-entity row tiles; its threads read a tile's 32 entities of one
// column's hop row as neighbouring words (coalesced), park the mask bytes
// in shared memory, and write them back as 32 neighbouring bytes of one
// output row. Columns sharing a hop re-read the same words, from L1/L2.
//
// K4 — the scale path's per-hop masks. Replaces
// raphtory_tpu/engine/hopbatch.py:2129-2150 `_compiled_scale.hop_masks`
// (both its unrolled and its `lax.scan` program shapes, which compute the
// same function). Add-only streams: hop h's state is the running scatter-MAX
//     cur[pos[h, u]] = max(cur[pos[h, u]], t[h, u])
// of the base state and every update list up to h, and its W columns are
//     out[i, h*W + w] = cur[i] >= thr[h*W + w]
// (thr = max(T - w, 0), or 0 unwindowed; never-seen entities hold
// INT32_MIN). Pads are (pos 0, INT32_MIN): a max no-op at a VALID index, so
// position 0 is not skipped — only positions outside [0, len) are.
//   Design: the state is never built. A running max reaches a threshold
// exactly when one of its terms does, so
//     out[i, c] = base[i] >= thr[c]
//                 || some update (h', i, t) with h' <= c / W has t >= thr[c]
// for any int32 values (the pads and an unwindowed thr of 0 need no special
// case). Pass A writes the first term for every row: a thread owns 16
// columns of a row, built from one base value and 16 thresholds held in
// registers and written as one 16-byte store, so a 128-column row is one
// 128-byte line written once by 8 neighbouring threads, each thread with
// 4 rows' base values in flight (C not a multiple of 16 takes flat
// 16-byte chunks across row ends, the thresholds in shared memory, byte
// by byte where a chunk is short). Pass B, after it on the stream, adds
// the second: a warp loads 32 updates (h, u) at once and takes them in
// turn, its lanes over the columns [h * W, C) of the update's row, each
// storing a 1 where t >= thr[c]. Bits are only ever set to 1, so several
// updates of one row need no atomics and no order. Bound: bytes — the
// base and the update lists read once and len * H * W mask bytes written;
// pass A moves exactly that, pass B one line of each updated row. Two
// launches a call (one with no updates), no snapshot, no device copy.
//
// KB1 — the binned mask emission of the destination-binned (PCPM) route.
// Replaces raphtory_tpu/engine/hopbatch.py:283 `_bin_masks` (the host-
// column route's permutation of K3's edge masks into the binned layout).
// Binned slot b of the [B, C] output is
//     out[b, c] = valid[b] && mask of edge perm[b] in column c
// (perm, valid: ops/partition.py). One pass: K3's tiled transpose whose
// read side gathers entity perm[b] instead of b, so the engine-order
// [m_pad, C] masks are never materialised next to the binned ones. The
// reads are no longer neighbouring words (slots sort by source within a
// partition, engine positions by destination); the writes stay coalesced.
// Bound: bytes — the input columns read once, perm and valid once, B * C
// mask bytes written. The vertex masks are K3's. One launch a call.
//   K4 binned (the binned `col_of` of hopbatch.py:2126-2137: the hop state
// advances in engine order, its columns are read through the layout
// permutation) is K4's two passes over the [B, C] output: pass A reads row
// b's base at perm[b] (0 where !valid[b]), pass B writes an update of
// engine position p into slot inv[p], the device inverse of perm
// (ops/columns.py `slot_inverse`: -1 where no valid slot holds p, as for
// the engine's pad rows, which pass B then skips).
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/columns.py).
// Every entry point launches on the caller's stream, allocates nothing,
// adds the number of kernels it launched to the host integer `*launched`,
// and returns cudaGetLastError().

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

template <typename T>
__global__ void scatter_set(int64_t len, int64_t U,
                            const int32_t* __restrict__ pos,
                            const T* __restrict__ lat,
                            const uint8_t* __restrict__ alive,
                            T* __restrict__ cur_l, uint8_t* __restrict__ cur_a) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         u < U; u += stride) {
        const int64_t p = pos[u];
        if (p < 0 || p >= len) continue;   // pad row
        cur_l[p] = lat[u];
        cur_a[p] = alive[u];
    }
}

template <typename T>
__global__ void write_columns(int64_t len, int64_t W, int64_t C, int64_t col0,
                              const T* __restrict__ cur_l,
                              const uint8_t* __restrict__ cur_a,
                              const T* __restrict__ lo,
                              const uint8_t* __restrict__ nowin,
                              uint8_t* __restrict__ out) {
    const int64_t total = len * W;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        const int64_t i = k / W;
        const int64_t c = col0 + (k - i * W);
        out[i * C + c] = cur_a[i] && (nowin[c] || cur_l[i] >= lo[c]);
    }
}

__global__ void scatter_set_f32(int64_t len, int64_t U,
                                const int32_t* __restrict__ pos,
                                const float* __restrict__ val,
                                float* __restrict__ cur) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         u < U; u += stride) {
        const int64_t p = pos[u];
        if (p < 0 || p >= len) continue;   // pad row
        cur[p] = val[u];
    }
}

__global__ void write_weight_column(int64_t len, int64_t H, int64_t h,
                                    const float* __restrict__ cur,
                                    float* __restrict__ out) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < len; i += stride) {
        out[i * H + h] = cur[i];
    }
}

template <typename T>
int masks_from_deltas(int64_t len, int64_t H, int64_t W, int64_t U, int64_t h0,
                      const int32_t* d_pos, const T* d_lat,
                      const uint8_t* d_alive, const T* lo,
                      const uint8_t* nowin, T* cur_l, uint8_t* cur_a,
                      uint8_t* out, cudaStream_t stream, int64_t* launched) {
    const int64_t C = H * W;
    for (int64_t h = 0; h < H; ++h) {
        if (h > 0 || h0) {
            scatter_set<T><<<blocks_for(U), kThreads, 0, stream>>>(
                len, U, d_pos + h * U, d_lat + h * U, d_alive + h * U,
                cur_l, cur_a);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return static_cast<int>(e);
            ++*launched;
        }
        if (len > 0 && W > 0) {
            write_columns<T><<<blocks_for(len * W), kThreads, 0, stream>>>(
                len, W, C, h * W, cur_l, cur_a, lo, nowin, out);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return static_cast<int>(e);
            ++*launched;
        }
    }
    return static_cast<int>(cudaGetLastError());
}


constexpr int kTile = 32;   // K3 tile: 32 entities x 32 columns

// The 32 columns of a block's column tile [c0, c0 + 32): hop row, bound and
// unwindowed flag, read once per block.
template <typename T>
struct ColumnTile {
    int64_t hop[kTile];
    T lo[kTile];
    uint8_t nowin[kTile];
};

template <typename T>
__device__ void load_column_tile(int64_t c0, int64_t C,
                                 const int32_t* __restrict__ hop_of_col,
                                 const T* __restrict__ lo,
                                 const uint8_t* __restrict__ nowin,
                                 ColumnTile<T>* ct) {
    if (threadIdx.x < kTile) {
        const int64_t c = c0 + threadIdx.x;
        if (c < C) {
            ct->hop[threadIdx.x] = hop_of_col[c];
            ct->lo[threadIdx.x] = lo[c];
            ct->nowin[threadIdx.x] = nowin[c];
        }
    }
    __syncthreads();
}

// One 32 x 32 tile of K3's masks: rows [i0, i0 + 32) of `out [len, C]`,
// the block's columns [c0, c0 + 32), read from hop rows of `stride`
// entities. `perm` null: row i reads entity i;
// else entity perm[i], and `valid[i]` false gives 0 (the binned rows of
// KB1, which gather through the layout permutation).
template <typename T>
__device__ void mask_tile(int64_t i0, int64_t c0, int64_t len,
                          int64_t stride, int64_t C,
                          const T* __restrict__ lat,
                          const uint8_t* __restrict__ alive,
                          const int32_t* __restrict__ perm,
                          const uint8_t* __restrict__ valid,
                          const ColumnTile<T>* ct,
                          uint8_t* __restrict__ out,
                          uint8_t (*sh)[kTile + 1]) {
    const int lane = threadIdx.x % kTile;
    const int row = threadIdx.x / kTile;
    const int rows = blockDim.x / kTile;
    const int ncol = C - c0 < kTile ? static_cast<int>(C - c0) : kTile;
    // read: lane = entity, so a warp reads 32 neighbouring words of a row
    // (unbinned; binned rows gather within their partition)
    const int64_t i = i0 + lane;
    const bool live = i < len && (!valid || valid[i]);
    const int64_t src = live ? (perm ? static_cast<int64_t>(perm[i]) : i) : 0;
    for (int cl = row; cl < ncol; cl += rows) {
        uint8_t m = 0;
        if (live) {
            const int64_t k = ct->hop[cl] * stride + src;
            m = alive[k] && (ct->nowin[cl] || lat[k] >= ct->lo[cl]);
        }
        sh[lane][cl] = m;
    }
    __syncthreads();
    // write: lane = column, so a warp writes 32 neighbouring bytes of a row
    for (int rl = row; rl < kTile; rl += rows) {
        const int64_t r = i0 + rl;
        if (r < len && lane < ncol) out[r * C + c0 + lane] = sh[rl][lane];
    }
    __syncthreads();
}

// K3 over edges then vertices in one grid: blockIdx.y is the column tile,
// blockIdx.x strides over the edge row tiles, then the vertex row tiles.
// (`me` has m rows read from hop rows of m_src edges, through perm/valid
// when binned; see mask_tile.)
template <typename T>
__global__ void column_masks(int64_t m, int64_t m_src, int64_t n, int64_t H,
                             int64_t C,
                             const T* __restrict__ e_lat,
                             const uint8_t* __restrict__ e_alive,
                             const T* __restrict__ v_lat,
                             const uint8_t* __restrict__ v_alive,
                             const int32_t* __restrict__ hop_of_col,
                             const T* __restrict__ lo,
                             const uint8_t* __restrict__ nowin,
                             const int32_t* __restrict__ perm,
                             const uint8_t* __restrict__ valid,
                             uint8_t* __restrict__ me,
                             uint8_t* __restrict__ mv) {
    __shared__ uint8_t sh[kTile][kTile + 1];
    __shared__ ColumnTile<T> ct;
    const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kTile;
    load_column_tile<T>(c0, C, hop_of_col, lo, nowin, &ct);
    const int64_t te = (m + kTile - 1) / kTile;
    const int64_t total = te + (n + kTile - 1) / kTile;
    for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
        if (t < te) {
            mask_tile<T>(t * kTile, c0, m, m_src, C, e_lat, e_alive, perm,
                         valid, &ct, me, sh);
        } else {
            mask_tile<T>((t - te) * kTile, c0, n, n, C, v_lat, v_alive,
                         nullptr, nullptr, &ct, mv, sh);
        }
    }
}

// ---------------------------------------------------------------- K4

constexpr int kChunk = 16;          // output bytes a pass-A thread writes
constexpr int64_t kThrShared = 8192;   // most thresholds staged in shared

// one threshold compare as a mask byte
__device__ __forceinline__ uint32_t ge(int32_t v, int32_t t) {
    return v >= t ? 1u : 0u;
}

// pass A's value of output row r: base[r], or (BINNED) base[perm[r]] where
// valid[r] (live false, and no read, elsewhere)
template <bool BINNED>
__device__ __forceinline__ int32_t row_value(int64_t r,
                                             const int32_t* __restrict__ base,
                                             const int32_t* __restrict__ perm,
                                             const uint8_t* __restrict__ valid,
                                             bool& live) {
    if (!BINNED) {
        live = true;
        return base[r];
    }
    live = valid[r] != 0;
    return live ? base[perm[r]] : 0;
}

constexpr int kRowsInFlight = 4;     // rows a pass-A thread loads at once

// Pass A where C % 16 == 0 and C <= 16 * 256: out[r, c] = live(r) &&
// val(r) >= thr[c]. A thread owns the 16 columns [16 q, 16 q + 16) of
// every row it writes (q = thread % (C / 16), its thresholds held in
// registers), a block C / 16 threads a row and 256 / (C / 16) rows at a
// time; a thread loads kRowsInFlight rows' values before it writes any,
// then writes each as one 16-byte store — no division in the loop.
template <bool BINNED>
__global__ void __launch_bounds__(kThreads) threshold_rows(
        int64_t rows, int64_t C, const int32_t* __restrict__ base,
        const int32_t* __restrict__ thr, const int32_t* __restrict__ perm,
        const uint8_t* __restrict__ valid, uint8_t* __restrict__ out) {
    const int cpr = static_cast<int>(C / kChunk);
    const int rpb = blockDim.x / cpr;
    const int64_t c = static_cast<int64_t>(kChunk) * (threadIdx.x % cpr);
    int32_t th[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) th[i] = __ldg(thr + c + i);
    const int64_t step = static_cast<int64_t>(gridDim.x) * rpb * kRowsInFlight;
    for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb * kRowsInFlight
                      + threadIdx.x / cpr;
         r0 < rows; r0 += step) {
        int32_t v[kRowsInFlight];
        bool live[kRowsInFlight];
#pragma unroll
        for (int k = 0; k < kRowsInFlight; ++k) {
            const int64_t r = r0 + static_cast<int64_t>(k) * rpb;
            live[k] = false;
            v[k] = r < rows ? row_value<BINNED>(r, base, perm, valid, live[k])
                            : 0;
        }
#pragma unroll
        for (int k = 0; k < kRowsInFlight; ++k) {
            const int64_t r = r0 + static_cast<int64_t>(k) * rpb;
            if (r >= rows) break;
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                w[q] = live[k] ? (ge(v[k], th[4 * q])
                                  | ge(v[k], th[4 * q + 1]) << 8
                                  | ge(v[k], th[4 * q + 2]) << 16
                                  | ge(v[k], th[4 * q + 3]) << 24)
                               : 0u;
            }
            *reinterpret_cast<uint4*>(out + r * C + c) =
                make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
}

// Pass A for any other C: the flat [rows, C] bytes, 16 a thread, the
// chunk running across row ends (one 16-byte store where it is whole,
// byte stores at the end); thresholds staged in shared memory up to
// kThrShared columns, read from global memory past that.
template <bool BINNED>
__global__ void __launch_bounds__(kThreads) threshold_pass(
        int64_t rows, int64_t C, const int32_t* __restrict__ base,
        const int32_t* __restrict__ thr, const int32_t* __restrict__ perm,
        const uint8_t* __restrict__ valid, uint8_t* __restrict__ out) {
    extern __shared__ int32_t s_thr[];
    const bool staged = C <= kThrShared;
    if (staged) {
        for (int64_t c = threadIdx.x; c < C; c += blockDim.x) s_thr[c] = thr[c];
        __syncthreads();
    }
    const int32_t* t_of = staged ? s_thr : thr;
    const int64_t total = rows * C;
    const int64_t chunks = (total + kChunk - 1) / kChunk;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         k < chunks; k += stride) {
        const int64_t f = k * kChunk;
        int64_t r = f / C;
        int64_t c = f - r * C;
        bool live;
        int32_t v = row_value<BINNED>(r, base, perm, valid, live);
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        const int n = total - f < kChunk ? static_cast<int>(total - f)
                                         : kChunk;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
            if (i < n) {
                if (c == C) {            // the next row starts in the chunk
                    c = 0;
                    ++r;
                    v = row_value<BINNED>(r, base, perm, valid, live);
                }
                if (live && v >= t_of[c]) w[i >> 2] |= 1u << (8 * (i & 3));
                ++c;
            }
        }
        if (n == kChunk) {
            *reinterpret_cast<uint4*>(out + f) = make_uint4(w[0], w[1], w[2],
                                                            w[3]);
        } else {
            for (int i = 0; i < n; ++i)
                out[f + i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
        }
    }
}

// Pass B: updates g = (h, u) of the [H, U] lists, 32 a warp at a time —
// each lane loads one update's (pos, t) and its row, so 32 loads are in
// flight, then the warp takes the live ones in turn (broadcast by
// shuffle), its lanes over the columns [h * W, C) of the update's row,
// storing a 1 where t >= thr[c]. An update at a position outside [0, len)
// is skipped, and so (BINNED) is one whose position no slot holds
// (inv[p] = -1), and one with t = INT32_MIN (the pads): it could only set
// a column whose threshold is INT32_MIN, which pass A set on every live
// row. Only 1s are stored, so racing updates of one row agree.
template <bool BINNED>
__global__ void __launch_bounds__(kThreads) update_pass(
        int64_t len, int64_t W, int64_t U, int64_t C, int64_t updates,
        const int32_t* __restrict__ pos, const int32_t* __restrict__ t,
        const int32_t* __restrict__ thr, const int32_t* __restrict__ inv,
        uint8_t* __restrict__ out) {
    extern __shared__ int32_t s_thr[];
    const bool staged = C <= kThrShared;
    if (staged) {
        for (int64_t c = threadIdx.x; c < C; c += blockDim.x) s_thr[c] = thr[c];
        __syncthreads();
    }
    const int32_t* t_of = staged ? s_thr : thr;
    const unsigned all = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
    for (int64_t g0 = ((static_cast<int64_t>(blockIdx.x) * blockDim.x
                        + threadIdx.x) >> 5) * 32;
         g0 < updates; g0 += warps * 32) {
        const int64_t g = g0 + lane;
        long long row = -1;
        int32_t tt = INT32_MIN;
        long long c0 = 0;
        if (g < updates) {
            const int64_t p = pos[g];
            tt = t[g];
            if (p >= 0 && p < len) row = BINNED ? inv[p] : p;
            c0 = (g / U) * W;
        }
        unsigned live = __ballot_sync(all, row >= 0 && tt != INT32_MIN);
        while (live) {
            const int k = __ffs(live) - 1;
            live &= live - 1;
            const long long r = __shfl_sync(all, row, k);
            const int32_t tk = __shfl_sync(all, tt, k);
            uint8_t* o = out + r * C;
            for (long long c = __shfl_sync(all, c0, k) + lane; c < C; c += 32)
                if (tk >= t_of[c]) o[c] = 1;
        }
    }
}

template <bool BINNED>
int scale_passes(int64_t rows, int64_t len, int64_t H, int64_t W, int64_t U,
                 const int32_t* base, const int32_t* pos, const int32_t* t,
                 const int32_t* thr, const int32_t* perm,
                 const uint8_t* valid, const int32_t* inv, uint8_t* out,
                 cudaStream_t st, int64_t* launched) {
    const int64_t C = H * W;
    if (rows <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
    if (C % kChunk == 0 && C <= kChunk * kThreads) {
        const int cpr = static_cast<int>(C / kChunk);
        const int rpb = kThreads / cpr;
        threshold_rows<BINNED><<<blocks_for((rows + kRowsInFlight - 1)
                                            / kRowsInFlight * cpr),
                                 rpb * cpr, 0, st>>>(rows, C, base, thr, perm,
                                                     valid, out);
    } else {
        const size_t smem = C <= kThrShared ? static_cast<size_t>(C) * 4 : 0;
        threshold_pass<BINNED><<<blocks_for((rows * C + kChunk - 1) / kChunk),
                                 kThreads, smem, st>>>(rows, C, base, thr,
                                                       perm, valid, out);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    if (U > 0 && len > 0) {
        const int64_t updates = H * U;
        const size_t smem = C <= kThrShared ? static_cast<size_t>(C) * 4 : 0;
        update_pass<BINNED><<<blocks_for(updates), kThreads, smem, st>>>(
            len, W, U, C, updates, pos, t, thr, inv, out);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ++*launched;
    }
    return static_cast<int>(cudaGetLastError());
}

// Grid of a K3 pass: one block row per column tile (y), the row tiles
// strided over x, about 132 * 32 blocks in all.
inline dim3 tile_grid(int64_t row_tiles, int64_t C) {
    const int64_t ct = (C + kTile - 1) / kTile;
    int64_t x = (132 * 32 + ct - 1) / ct;
    if (x > row_tiles) x = row_tiles;
    if (x < 1) x = 1;
    return dim3(static_cast<unsigned>(x), static_cast<unsigned>(ct));
}

template <typename T>
int column_masks_launch(int64_t m, int64_t m_src, int64_t n, int64_t H,
                        int64_t C, const void* e_lat,
                        const void* e_alive, const void* v_lat,
                        const void* v_alive, const void* hop_of_col,
                        const void* lo, const void* nowin, const void* perm,
                        const void* valid, void* me, void* mv,
                        void* stream) {
    if (C <= 0 || H <= 0 || m + n <= 0) {
        return static_cast<int>(cudaGetLastError());
    }
    const int64_t rows = (m + kTile - 1) / kTile + (n + kTile - 1) / kTile;
    column_masks<T><<<tile_grid(rows, C), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        m, m_src, n, H, C, static_cast<const T*>(e_lat),
        static_cast<const uint8_t*>(e_alive), static_cast<const T*>(v_lat),
        static_cast<const uint8_t*>(v_alive),
        static_cast<const int32_t*>(hop_of_col), static_cast<const T*>(lo),
        static_cast<const uint8_t*>(nowin),
        static_cast<const int32_t*>(perm),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(me),
        static_cast<uint8_t*>(mv));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rtpu_masks_from_deltas_i32(int64_t len, int64_t H, int64_t W, int64_t U,
                               int64_t h0, const void* d_pos, const void* d_lat,
                               const void* d_alive, const void* lo,
                               const void* nowin, void* cur_l, void* cur_a,
                               void* out, void* stream,
                               int64_t* launched) {
    return masks_from_deltas<int32_t>(
        len, H, W, U, h0, static_cast<const int32_t*>(d_pos),
        static_cast<const int32_t*>(d_lat),
        static_cast<const uint8_t*>(d_alive), static_cast<const int32_t*>(lo),
        static_cast<const uint8_t*>(nowin), static_cast<int32_t*>(cur_l),
        static_cast<uint8_t*>(cur_a), static_cast<uint8_t*>(out),
        static_cast<cudaStream_t>(stream), launched);
}

int rtpu_masks_from_deltas_i64(int64_t len, int64_t H, int64_t W, int64_t U,
                               int64_t h0, const void* d_pos, const void* d_lat,
                               const void* d_alive, const void* lo,
                               const void* nowin, void* cur_l, void* cur_a,
                               void* out, void* stream,
                               int64_t* launched) {
    return masks_from_deltas<int64_t>(
        len, H, W, U, h0, static_cast<const int32_t*>(d_pos),
        static_cast<const int64_t*>(d_lat),
        static_cast<const uint8_t*>(d_alive), static_cast<const int64_t*>(lo),
        static_cast<const uint8_t*>(nowin), static_cast<int64_t*>(cur_l),
        static_cast<uint8_t*>(cur_a), static_cast<uint8_t*>(out),
        static_cast<cudaStream_t>(stream), launched);
}

int rtpu_weights_from_deltas(int64_t len, int64_t H, int64_t U, int64_t h0,
                             const void* d_pos, const void* d_val,
                             void* cur_w, void* out, void* stream,
                             int64_t* launched) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* pos = static_cast<const int32_t*>(d_pos);
    const float* val = static_cast<const float*>(d_val);
    float* cur = static_cast<float*>(cur_w);
    for (int64_t h = 0; h < H; ++h) {
        if (h > 0 || h0) {
            scatter_set_f32<<<blocks_for(U), kThreads, 0, st>>>(
                len, U, pos + h * U, val + h * U, cur);
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return static_cast<int>(e);
            ++*launched;
        }
        if (len > 0) {
            write_weight_column<<<blocks_for(len), kThreads, 0, st>>>(
                len, H, h, cur, static_cast<float*>(out));
            const cudaError_t e = cudaGetLastError();
            if (e != cudaSuccess) return static_cast<int>(e);
            ++*launched;
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// K3: m edges and n vertices, H hops, C columns | e_lat, e_alive [H, m],
// v_lat, v_alive [H, n], hop_of_col [C] int32, lo [C], nowin [C] |
// me [m, C], mv [n, C]. One launch (none when there is nothing to write).
int rtpu_column_masks_i32(int64_t m, int64_t n, int64_t H, int64_t C,
                          const void* e_lat,
                          const void* e_alive, const void* v_lat,
                          const void* v_alive, const void* hop_of_col,
                          const void* lo, const void* nowin, void* me,
                          void* mv, void* stream) {
    return column_masks_launch<int32_t>(m, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, hop_of_col, lo, nowin,
                                        nullptr, nullptr, me, mv, stream);
}

int rtpu_column_masks_i64(int64_t m, int64_t n, int64_t H, int64_t C,
                          const void* e_lat,
                          const void* e_alive, const void* v_lat,
                          const void* v_alive, const void* hop_of_col,
                          const void* lo, const void* nowin, void* me,
                          void* mv, void* stream) {
    return column_masks_launch<int64_t>(m, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, hop_of_col, lo, nowin,
                                        nullptr, nullptr, me, mv, stream);
}

// K4: rows output rows (len; B binned), len entities, H hops, W windows,
// U updates a hop | base [len], d_pos, d_t [H, U] int32, thr [H*W] int32,
// perm [B] int32 / valid [B] bool / inv [len] int32 (all null unbinned),
// out [rows, H*W] bool, 16-byte aligned. Adds the kernels it launched
// (pass A, then pass B when there are updates) to *launched.
int rtpu_scale_hop_masks(int64_t rows, int64_t len, int64_t H, int64_t W,
                         int64_t U, const void* base, const void* d_pos,
                         const void* d_t, const void* thr, const void* perm,
                         const void* valid, const void* inv, void* out,
                         void* stream, int64_t* launched) {
    if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* b = static_cast<const int32_t*>(base);
    const int32_t* pos = static_cast<const int32_t*>(d_pos);
    const int32_t* t = static_cast<const int32_t*>(d_t);
    const int32_t* th = static_cast<const int32_t*>(thr);
    uint8_t* o = static_cast<uint8_t*>(out);
    if (perm != nullptr) {
        return scale_passes<true>(rows, len, H, W, U, b, pos, t, th,
                                  static_cast<const int32_t*>(perm),
                                  static_cast<const uint8_t*>(valid),
                                  static_cast<const int32_t*>(inv), o, st,
                                  launched);
    }
    return scale_passes<false>(rows, len, H, W, U, b, pos, t, th, nullptr,
                               nullptr, nullptr, o, st, launched);
}

// KB1 (host-column route): K3 with the edge masks emitted straight into
// the binned layout — me [B, C] row b from edge perm[b] of the [H, m]
// columns, 0 where !valid[b]; mv [n, C] as K3. One launch.
int rtpu_bin_column_masks_i32(int64_t B, int64_t m, int64_t n, int64_t H,
                              int64_t C, const void* e_lat,
                              const void* e_alive, const void* v_lat,
                              const void* v_alive, const void* hop_of_col,
                              const void* lo, const void* nowin,
                              const void* perm, const void* valid, void* me,
                              void* mv, void* stream) {
    return column_masks_launch<int32_t>(B, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, hop_of_col, lo, nowin, perm,
                                        valid, me, mv, stream);
}

int rtpu_bin_column_masks_i64(int64_t B, int64_t m, int64_t n, int64_t H,
                              int64_t C, const void* e_lat,
                              const void* e_alive, const void* v_lat,
                              const void* v_alive, const void* hop_of_col,
                              const void* lo, const void* nowin,
                              const void* perm, const void* valid, void* me,
                              void* mv, void* stream) {
    return column_masks_launch<int64_t>(B, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, hop_of_col, lo, nowin, perm,
                                        valid, me, mv, stream);
}

}  // extern "C"
