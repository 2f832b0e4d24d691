// K1 — per-hop fold-state rebuild and window masks of the hop-batched
// columnar engine; K6w, weighted SSSP's weight rebuild, on the same
// template.
//
// Replaces raphtory_tpu/engine/hopbatch.py:66 `_masks_from_deltas`, the
// first half of the jitted `_compiled_delta` program. For each hop h of a
// dispatch the reference scatter-SETS hop h's touched-entity deltas (pos,
// lat, alive) into the running state (hop 0 only when `h0`: the base is
// then the previous dispatch's device-resident advanced state and delta[0]
// is the catch-up), then writes the hop's W window columns
//     out[i, h*W + w] = alive[i] && (w_col < 0 || lat[i] >= lo[h*W + w])
// into the entity-major [len, H*W] bool output, and returns the state after
// the last hop (the advanced base the caller keeps resident).
//
// What bounds it on the H100: bytes — the base read once (len * (sizeof(T)
// + 1)), the mask (len * H * W) and the advanced state written once, the
// delta rows read; no arithmetic to speak of. At the headline shapes (len
// 327,680) each pass takes a few microseconds, so launches (and the host
// time each costs) weigh as much as the bytes do.
//   Design: the hop-by-hop state is never rebuilt. The host fold emits each
// position once per hop, so under set semantics hop h's state of row i is
// the value of i's latest update at a hop <= h, or the base where there is
// none. Three passes a group of hops, in ONE cooperative launch (grid syncs
// between the passes; pass B0 is skipped where one hop of the group applies
// updates, since no later hop can touch a row, and both B passes where
// none does):
//   * pass A, a block a tile of 1,024 rows: the tile's base values staged
//     in shared memory by coalesced loads, which also copy the base into
//     the advanced state (no clone) and clear the rows' hop-touch words;
//     then all the group's columns of the tile written from the staged
//     values, a thread a 16-byte chunk of the tile's flat bytes (neighbour
//     threads on neighbour chunks; byte stores where a group's columns are
//     not whole rows);
//   * pass B0, a thread an update: ORs bit h into touch[pos] (order-free);
//   * pass B1, a thread an update: next = the lowest touch bit above h, or
//     the group's end; it writes columns [h*W, next*W) of its row from the
//     update's (lat, alive), as the widest aligned stores the range allows,
//     and the advanced state where no later hop of the group touches the
//     row.
// A group whose one applied hop is its last (H 2 without `h0`, or H 1
// with it: the `scale` path's calls) and whose updates are dense (U >=
// len / 8) takes a row pass instead of the update rows' random mask writes:
// the base copied into the advanced state, the updates scattered into it,
// then one row pass writing the hop's columns from the advanced state and
// the earlier ones from the base (both staged in shared memory).
// After pass A exactly one thread writes each output byte and each
// advanced-state entry, so there are no atomics on the output and the
// result does not depend on the order of the threads: it is bitwise the
// twin's. Updates of hop 0 without `h0`, and pad positions (outside
// [0, len): 2^31-1, negatives), are skipped by both B passes. `w_col < 0`
// folds into the threshold (the type's minimum, which every lat reaches).
// The touch word is 1, 4 or 8 bytes a row (groups of 8, 32 or 64 hops;
// 1-byte words are ORed through their aligned 32-bit word); a longer call
// chains groups the way `h0` chains dispatches: group g + 1 takes group
// g's advanced state as its base and writes its own column range.

// K6w — the weight-state rebuild of weighted SSSP. Replaces
// raphtory_tpu/engine/hopbatch.py:374-384 (inside `_compiled_delta`): for
// each hop h it scatter-sets hop h's (pos, val) weight deltas into the
// running weight state (hop 0 only with `h0`; pad positions, outside
// [0, len), skipped; the host removes duplicate positions within a hop,
// last wins) and writes the state as column h of the [len, H] f32 weight
// block the K6 superstep reads (minplus_columns.cu), and returns the
// advanced weight state the caller keeps resident. Bound: bytes — the base
// read once, the [len, H] block and the advanced state written once, the
// live delta rows read.
//   Design: K1's, from the same template (`k1_kernel<WeightCell>`): the
// state is an f32 weight with no alive byte, W = 1 and no window compare,
// and a cell is the weight itself. One cooperative launch a call, not two a
// hop (a scatter, then a strided column pass storing one 4-byte word a row
// 4H bytes apart, would be 2H launches): pass A stages a tile's base weights,
// copies them into the advanced state (no clone) and writes the tile's H
// columns as flat 16-byte chunks (four weights); B0 marks each update's
// hop in its row's touch word; B1 writes columns [h, next) of its row and
// the advanced state where no later hop touches the row. Values are moved,
// never computed, so the block is bitwise the twin's.

// K3 — host fold columns to window masks (the host-column route). Replaces
// raphtory_tpu/engine/hopbatch.py:50 `_column_masks`, the head of the
// jitted `_compiled`, `_compiled_cc` and `_compiled_bfs` programs: from the
// hop-major [H, len] fold columns (lat, alive) the host fold built,
//     out[i, c] = alive[hop_of_col[c], i]
//                 && (nowin[c] || lat[hop_of_col[c], i] >= lo[c])
// into the entity-major [len, C] bool layout the superstep kernels read.
// Edges and vertices share one launch. What bounds it: bytes — the columns
// are read once (H * len * (sizeof(T) + 1)) and the masks written once
// (len * C); no arithmetic to speak of.
//   Design: the column bounds travel BY VALUE. The C entry copies a group
// of up to 64 columns from a host array (hop_of_col, lo, nowin, as the
// wrapper computes them in Python integers) into a __grid_constant__
// struct, with the group's distinct hops and each hop's run of columns;
// more columns, one launch a group. Nothing of the bounds is uploaded, so
// the dispatch makes no synchronizing copy. A thread takes one output row:
// it reads its entity's (lat, alive) once for each hop of the group —
// neighbouring threads on neighbouring entities, so every read is a
// coalesced warp load — evaluates every column of that hop, and stages the
// row's mask bytes in shared memory (an odd number of words a row: no bank
// conflicts); the block then writes its 256 rows' column bytes as 4-byte
// words where C allows (2 or 1 byte otherwise), neighbouring threads on
// neighbouring words, so a tile whose group covers the row is one
// contiguous run of the output.
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
// (perm, valid: ops/partition.py). K3's kernel, an edge row b reading
// entity perm[b] (perm read once a row, not once a column) and writing 0
// where !valid[b], so the engine-order [m_pad, C] masks are never
// materialised next to the binned ones. The reads are no longer
// neighbouring words (slots sort by source within a partition, engine
// positions by destination); the writes stay coalesced. Bound: bytes — the
// input columns read once, perm and valid once, B * C mask bytes written.
// The vertex masks are K3's, in the same launch.
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

#include <cooperative_groups.h>
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

// ---------------------------------------------------------------- K1

template <typename T> struct TimeMin;
template <> struct TimeMin<int32_t> {
    __device__ static int32_t v() { return INT32_MIN; }
};
template <> struct TimeMin<int64_t> {
    __device__ static int64_t v() { return INT64_MIN; }
};

// What a row's state is and what it writes into a column: K1 keeps (lat,
// alive) and writes one mask byte a (hop, window) column; K6w keeps an f32
// weight and writes it, W = 1, no window compare.
template <typename T>
struct MaskCell {
    using V = T;                  // the state's value
    using O = uint8_t;            // an output cell
    static constexpr bool kAlive = true;
};
struct WeightCell {
    using V = float;
    using O = float;
    static constexpr bool kAlive = false;
};

__device__ __forceinline__ uint32_t cell_bits(uint8_t x) { return x; }
__device__ __forceinline__ uint32_t cell_bits(float x) {
    return __float_as_uint(x);
}
template <typename O> __device__ __forceinline__ O cell_of(uint32_t x);
template <> __device__ __forceinline__ uint8_t cell_of<uint8_t>(uint32_t x) {
    return static_cast<uint8_t>(x & 0xffu);
}
template <> __device__ __forceinline__ float cell_of<float>(uint32_t x) {
    return __uint_as_float(x);
}

constexpr int kK1Tile = 1024;            // rows a pass-A tile stages
constexpr int64_t kK1ThrShared = 2048;   // most thresholds staged in shared

// a tile's two staged states (before and after the updates: the dense
// path's split) and the group's thresholds
template <typename V>
constexpr size_t k1_smem_bytes() {
    return 2 * kK1Tile * (sizeof(V) + 1) + kK1ThrShared * sizeof(V);
}

// One call's operands (the kernel's one parameter); the alive bytes, lo and
// nowin are K1's (null for K6w).
template <typename C>
struct K1Args {
    using V = typename C::V;
    using O = typename C::O;
    int64_t len, H, W, U, tw, h0;
    const V* base_l;
    const uint8_t* base_a;
    const int32_t* pos;
    const V* d_lat;
    const uint8_t* d_alive;
    const V* lo;
    const uint8_t* nowin;
    V* adv_l;
    uint8_t* adv_a;
    uint8_t* touch;
    O* out;
};

// the thresholds of one group of hops, columns [c0, c0 + Cg): staged in
// shared memory where they fit, else taken from global memory; a column
// with no window takes the type's minimum, which every lat reaches
template <typename T>
struct K1Thr {
    const T* s;
    const T* lo;
    const uint8_t* nowin;
    int64_t c0;
    bool staged;
    __device__ __forceinline__ T operator()(int64_t c) const {
        if (staged) return s[c];
        return nowin[c0 + c] ? TimeMin<T>::v() : lo[c0 + c];
    }
};

__device__ __forceinline__ void k1_clear(uint8_t* touch, int64_t tw,
                                         int64_t r) {
    if (tw == 1) touch[r] = 0;
    else if (tw == 4) reinterpret_cast<uint32_t*>(touch)[r] = 0u;
    else reinterpret_cast<unsigned long long*>(touch)[r] = 0ull;
}

// OR bit h into row p's touch word (1-byte words through their aligned
// 32-bit word; the buffer is padded to a multiple of 4 bytes)
__device__ __forceinline__ void k1_touch(uint8_t* touch, int64_t tw,
                                         int64_t p, int h) {
    if (tw == 1) {
        atomicOr(reinterpret_cast<unsigned int*>(touch + (p & ~int64_t(3))),
                 1u << (h + 8 * static_cast<int>(p & 3)));
    } else if (tw == 4) {
        atomicOr(reinterpret_cast<unsigned int*>(touch) + p, 1u << h);
    } else {
        atomicOr(reinterpret_cast<unsigned long long*>(touch) + p, 1ull << h);
    }
}

__device__ __forceinline__ unsigned long long k1_touched(
        const uint8_t* touch, int64_t tw, int64_t p) {
    if (tw == 1) return touch[p];
    if (tw == 4) return reinterpret_cast<const uint32_t*>(touch)[p];
    return reinterpret_cast<const unsigned long long*>(touch)[p];
}

// A row pass over the tiles of kK1Tile rows: the tile's states staged in
// shared memory (coalesced loads), then the group's columns written from
// them. Columns before `split` (group-local) take the state (pl, pa),
// the rest (ql, qa): pass A's split is the group's width (the base state
// alone), the dense path's is its one applied hop's first column. `copy`
// also copies (pl, pa) into the advanced state, `clear` clears the rows'
// touch words. `flat` (one group: its columns are whole rows, and the
// tile's C-cell lines are whole 16-byte chunks): a thread a 16-byte chunk
// (16 mask bytes or 4 weights), its row and column from one 32-bit
// division, one 16-byte store, neighbouring threads on neighbouring
// chunks; else a thread a cell of the group's columns.
template <typename C>
__device__ void k1_rows(const K1Args<C>& a, const typename C::V* pl,
                        const uint8_t* pa, const typename C::V* ql,
                        const uint8_t* qa, int64_t split, bool copy,
                        bool clear, int64_t c0, int64_t Cg,
                        const K1Thr<typename C::V>& thr,
                        unsigned char* smem) {
    using V = typename C::V;
    using O = typename C::O;
    V* s_pl = reinterpret_cast<V*>(smem);
    V* s_ql = s_pl + kK1Tile;
    uint8_t* s_pa = smem + 2 * kK1Tile * sizeof(V);
    uint8_t* s_qa = s_pa + kK1Tile;
    const int64_t Cw = a.H * a.W;
    const bool flat = Cg == Cw;
    const bool both = split < Cg;
    const int sp = static_cast<int>(split);
    const int64_t tiles = (a.len + kK1Tile - 1) / kK1Tile;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int64_t r0 = t * kK1Tile;
        const int nr = a.len - r0 < kK1Tile ? static_cast<int>(a.len - r0)
                                            : kK1Tile;
        for (int i = threadIdx.x; i < nr; i += blockDim.x) {
            const V l = pl[r0 + i];
            s_pl[i] = l;
            if (both) s_ql[i] = ql[r0 + i];
            if (copy) a.adv_l[r0 + i] = l;
            if constexpr (C::kAlive) {
                const uint8_t al = pa[r0 + i];
                s_pa[i] = al;
                if (both) s_qa[i] = qa[r0 + i];
                if (copy) a.adv_a[r0 + i] = al;
            }
            if (clear) k1_clear(a.touch, a.tw, r0 + i);
        }
        __syncthreads();
        auto cell = [&](int i, int c) -> O {
            if constexpr (C::kAlive) {
                return c < sp ? (s_pa[i] && s_pl[i] >= thr(c))
                              : (s_qa[i] && s_ql[i] >= thr(c));
            } else {
                return c < sp ? s_pl[i] : s_ql[i];
            }
        };
        if (flat) {
            constexpr int kPer = 16 / static_cast<int>(sizeof(O));
            constexpr int kWord = 4 / static_cast<int>(sizeof(O));
            const int Ci = static_cast<int>(Cw);
            const int nb = nr * Ci;
            O* o = a.out + r0 * Cw;
            for (int k = threadIdx.x; k * kPer < nb; k += blockDim.x) {
                const int f = k * kPer;
                int i = f / Ci;
                int c = f - i * Ci;
                const int n = nb - f < kPer ? nb - f : kPer;
                uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int b = 0; b < kPer; ++b) {
                    if (b < n) {
                        w[b / kWord] |= cell_bits(cell(i, c))
                                        << (8 * sizeof(O) * (b % kWord));
                        if (++c == Ci) {
                            c = 0;
                            ++i;
                        }
                    }
                }
                if (n == kPer) {
                    *reinterpret_cast<uint4*>(o + f) =
                        make_uint4(w[0], w[1], w[2], w[3]);
                } else {
                    for (int b = 0; b < n; ++b)
                        o[f + b] = cell_of<O>(
                            w[b / kWord] >> (8 * sizeof(O) * (b % kWord)));
                }
            }
        } else {
            const int Cgi = static_cast<int>(Cg);
            for (int f = threadIdx.x; f < nr * Cgi; f += blockDim.x) {
                const int i = f / Cgi, c = f - i * Cgi;
                a.out[(r0 + i) * Cw + c0 + c] = cell(i, c);
            }
        }
        __syncthreads();
    }
}

// cells [cb, ce) of one output row from one update (v, al). K1: mask bytes
// by the widest aligned stores the range allows (bytes, then 16-bit, then
// 32-bit words); K6w: the weight in each column.
template <typename C>
__device__ __forceinline__ void k1_write_range(
        typename C::O* row, int64_t cb, int64_t ce, uint8_t al,
        typename C::V v, const K1Thr<typename C::V>& thr) {
    int64_t c = cb;
    if constexpr (!C::kAlive) {
        for (; c < ce; ++c) row[c] = v;
    } else {
        auto bit = [&](int64_t x) -> uint32_t {
            return (al && v >= thr(x)) ? 1u : 0u;
        };
        if (c < ce && (reinterpret_cast<uintptr_t>(row + c) & 1)) {
            row[c] = static_cast<uint8_t>(bit(c));
            ++c;
        }
        if (c + 2 <= ce && (reinterpret_cast<uintptr_t>(row + c) & 2)) {
            *reinterpret_cast<uint16_t*>(row + c) =
                static_cast<uint16_t>(bit(c) | bit(c + 1) << 8);
            c += 2;
        }
        for (; c + 4 <= ce; c += 4) {
            *reinterpret_cast<uint32_t*>(row + c) =
                bit(c) | bit(c + 1) << 8 | bit(c + 2) << 16 | bit(c + 3) << 24;
        }
        if (c + 2 <= ce) {
            *reinterpret_cast<uint16_t*>(row + c) =
                static_cast<uint16_t>(bit(c) | bit(c + 1) << 8);
            c += 2;
        }
        if (c < ce) row[c] = static_cast<uint8_t>(bit(c));
    }
}

// K1 and K6w, one cooperative launch: for each group of 8 * tw hops, pass
// A, grid sync, pass B0 (more than one applied hop), grid sync, pass B1,
// and a grid sync before the next group, which reads this one's advanced
// state. A group with ONE applied hop (its last) and dense updates (U >=
// len / 8: the update rows' random writes would cost more than a row pass)
// takes the dense path instead: the base copied into the advanced state,
// grid sync, the updates scattered into it (no touch words: no later hop),
// grid sync, one row pass writing the columns before the hop from the base
// and the rest from the advanced state. Every branch around a grid sync is
// uniform over the grid.
template <typename C>
__global__ void __launch_bounds__(kThreads) k1_kernel(K1Args<C> a) {
    using V = typename C::V;
    extern __shared__ __align__(16) unsigned char k1_smem[];
    V* s_thr = reinterpret_cast<V*>(k1_smem + 2 * kK1Tile * (sizeof(V) + 1));
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const int64_t Cw = a.H * a.W;
    const int64_t hops = 8 * a.tw;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    for (int64_t g0 = 0; g0 < a.H; g0 += hops) {
        const int Hg = static_cast<int>(a.H - g0 < hops ? a.H - g0 : hops);
        const int64_t c0 = g0 * a.W, Cg = Hg * a.W;
        K1Thr<V> thr{s_thr, a.lo, a.nowin, c0, Cg <= kK1ThrShared};
        if constexpr (C::kAlive) {
            if (thr.staged) {
                for (int64_t c = threadIdx.x; c < Cg; c += blockDim.x)
                    s_thr[c] = a.nowin[c0 + c] ? TimeMin<V>::v()
                                               : a.lo[c0 + c];
            }
            __syncthreads();
        }
        const bool first = g0 == 0;
        const V* bl = first ? a.base_l : a.adv_l;     // the group's base
        const uint8_t* ba = first ? a.base_a : a.adv_a;
        const int h1 = (first && !a.h0) ? 1 : 0;      // hop 0 applies with h0
        const bool multi = Hg - h1 > 1;
        // the group's applied updates are contiguous in the [H, U] lists
        const int64_t at = (g0 + h1) * a.U;
        const int64_t nup = a.U > 0 && Hg > h1 ? (Hg - h1) * a.U : 0;
        if (nup && !multi && a.U * 8 >= a.len) {
            if (first) {
                for (int64_t r = tid; r < a.len; r += stride) {
                    a.adv_l[r] = a.base_l[r];
                    if constexpr (C::kAlive) a.adv_a[r] = a.base_a[r];
                }
            }
            grid.sync();
            for (int64_t g = tid; g < nup; g += stride) {
                const int64_t p = a.pos[at + g];
                if (p >= 0 && p < a.len) {
                    a.adv_l[p] = a.d_lat[at + g];
                    if constexpr (C::kAlive) a.adv_a[p] = a.d_alive[at + g];
                }
            }
            grid.sync();
            if (h1) {               // hop 0's columns from the base
                k1_rows<C>(a, bl, ba, a.adv_l, a.adv_a, h1 * a.W, false,
                           false, c0, Cg, thr, k1_smem);
            } else {                // every column after the scatter
                k1_rows<C>(a, a.adv_l, a.adv_a, a.adv_l, a.adv_a, Cg, false,
                           false, c0, Cg, thr, k1_smem);
            }
        } else {
            k1_rows<C>(a, bl, ba, bl, ba, Cg, first, true, c0, Cg, thr,
                       k1_smem);
            if (nup && multi) {
                grid.sync();
                for (int64_t g = tid; g < nup; g += stride) {
                    const int64_t p = a.pos[at + g];
                    if (p >= 0 && p < a.len)
                        k1_touch(a.touch, a.tw, p,
                                 h1 + static_cast<int>(g / a.U));
                }
            }
            if (nup) {
                grid.sync();
                for (int64_t g = tid; g < nup; g += stride) {
                    const int64_t p = a.pos[at + g];
                    if (p < 0 || p >= a.len) continue;       // pad row
                    const int h = h1 + static_cast<int>(g / a.U);
                    const V v = a.d_lat[at + g];
                    uint8_t al = 1;
                    if constexpr (C::kAlive) al = a.d_alive[at + g];
                    int next = Hg;
                    if (multi && h + 1 < 64) {
                        const unsigned long long above =
                            k1_touched(a.touch, a.tw, p) >> (h + 1);
                        if (above)
                            next = h + __ffsll(static_cast<long long>(above));
                    }
                    k1_write_range<C>(a.out + p * Cw + c0, h * a.W,
                                      next * a.W, al, v, thr);
                    if (next == Hg) {
                        a.adv_l[p] = v;
                        if constexpr (C::kAlive) a.adv_a[p] = al;
                    }
                }
            }
        }
        if (g0 + hops < a.H) grid.sync();
    }
}

// the most blocks of k1_kernel<C> that fit on the card at once (a
// cooperative launch must not exceed it), asked once per process
template <typename C>
int k1_max_blocks() {
    static int blocks = [] {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, k1_kernel<C>, kThreads,
            k1_smem_bytes<typename C::V>());
        return sms * per_sm;
    }();
    return blocks;
}

template <typename C>
int masks_from_deltas(const K1Args<C>& a, cudaStream_t st,
                      int64_t* launched) {
    if (a.len <= 0 || a.H <= 0) return static_cast<int>(cudaGetLastError());
    if (a.tw != 1 && a.tw != 4 && a.tw != 8)
        return static_cast<int>(cudaErrorInvalidValue);
    if (a.H * a.W > 0 && reinterpret_cast<uintptr_t>(a.out) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    if (a.H * a.W * kK1Tile >= (int64_t(1) << 31))   // tile indices in int
        return static_cast<int>(cudaErrorInvalidValue);
    const int cap = k1_max_blocks<C>();
    if (cap <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t tiles = (a.len + kK1Tile - 1) / kK1Tile;
    const int64_t ups = (a.H * a.U + kThreads - 1) / kThreads;
    int64_t blocks = tiles > ups ? tiles : ups;
    if (blocks > cap) blocks = cap;
    K1Args<C> arg = a;
    void* params[] = {&arg};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(k1_kernel<C>),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), params,
        k1_smem_bytes<typename C::V>(), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K3

constexpr int kColGroup = 64;   // columns a K3 / KB1 launch carries
constexpr int kRowTile = 256;   // rows a K3 block stages (a thread a row)
constexpr int kPitchMax = 68;   // bytes a staged row takes, at most

// One launch's columns, by value (a __grid_constant__ kernel parameter):
// output columns [c0, c0 + cg); their distinct hops hop[0, nh), each with
// its run col[off[j], off[j + 1]) of columns (offsets from c0); each
// column's bound lo (inside the times' dtype's range) and bit c of nowin
// set where column c + c0 is unwindowed.
struct ColGroup {
    int64_t lo[kColGroup];
    uint64_t nowin;
    int64_t c0;
    int32_t hop[kColGroup];
    int32_t nh, cg;
    uint8_t col[kColGroup];
    uint8_t off[kColGroup + 1];
};

// bytes a staged row takes: cg rounded up to whole words, and an odd
// number of words, so the 32 rows a warp stages fall in 32 banks
__host__ __device__ constexpr int row_pitch(int cg) {
    return ((cg + 3) / 4) % 2 ? (cg + 3) / 4 * 4 : (cg + 3) / 4 * 4 + 4;
}

template <int W> struct Word;
template <> struct Word<1> { using type = uint8_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<4> { using type = uint32_t; };

// K3 / KB1 over one column group: block x < etiles is the edge row tile x,
// the rest the vertex row tiles. A thread takes one output row: it reads
// its entity's (lat, alive) once for each hop of the group, evaluates every
// column of that hop, and stages the row's cg mask bytes in shared memory;
// the block then writes its rows' column bytes as W-byte words (W = 4, 2
// or 1, as C allows), neighbouring threads on neighbouring words — where
// one group covers the row, the tile is one contiguous run of the output.
// Edge row r reads entity r of hop rows m_src long, or (binned, `perm`
// given) entity perm[r], and is 0 where !valid[r].
template <typename T, int W>
__global__ void __launch_bounds__(kRowTile) column_masks_kernel(
        int64_t m, int64_t m_src, int64_t n, int64_t C, int64_t etiles,
        const T* __restrict__ e_lat, const uint8_t* __restrict__ e_alive,
        const T* __restrict__ v_lat, const uint8_t* __restrict__ v_alive,
        const int32_t* __restrict__ perm, const uint8_t* __restrict__ valid,
        uint8_t* __restrict__ me, uint8_t* __restrict__ mv,
        const __grid_constant__ ColGroup g) {
    __shared__ __align__(16) uint8_t sh[kRowTile * kPitchMax];
    const bool edges = blockIdx.x < etiles;            // block-uniform
    const int64_t r0 =
        (edges ? blockIdx.x : blockIdx.x - etiles) * (int64_t)kRowTile;
    const int64_t len = edges ? m : n;
    const int64_t stride = edges ? m_src : n;
    const T* __restrict__ lat = edges ? e_lat : v_lat;
    const uint8_t* __restrict__ alive = edges ? e_alive : v_alive;
    const int pitch = row_pitch(g.cg);
    const int64_t r = r0 + threadIdx.x;
    uint8_t* mine = sh + threadIdx.x * pitch;
    if (r < len) {
        if (edges && valid != nullptr && !valid[r]) {
            for (int c = 0; c < g.cg; ++c) mine[c] = 0;
        } else {
            const int64_t e =
                edges && perm != nullptr ? static_cast<int64_t>(perm[r]) : r;
            for (int j = 0; j < g.nh; ++j) {
                const int64_t k = static_cast<int64_t>(g.hop[j]) * stride + e;
                const bool al = alive[k] != 0;
                const T l = lat[k];
                for (int q = g.off[j]; q < g.off[j + 1]; ++q) {
                    const int c = g.col[q];
                    mine[c] = al && (((g.nowin >> c) & 1u)
                                     || l >= static_cast<T>(g.lo[c]));
                }
            }
        }
    }
    __syncthreads();
    using V = typename Word<W>::type;
    const int64_t rows = len - r0 < kRowTile ? len - r0 : kRowTile;
    const int per = g.cg / W;                    // words a row
    uint8_t* out = (edges ? me : mv) + g.c0;
    for (int i = threadIdx.x; i < rows * per; i += kRowTile) {
        const int row = i / per;
        const int k = i - row * per;
        *reinterpret_cast<V*>(out + (r0 + row) * C + k * W) =
            *reinterpret_cast<const V*>(sh + row * pitch + k * W);
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

// K3 / KB1: one launch a group of kColGroup columns (`bounds`: the host's
// hop[C], lo[C], nowin[C]); adds the launches to *launched.
template <typename T>
int column_masks_launch(int64_t m, int64_t m_src, int64_t n, int64_t H,
                        int64_t C, const void* e_lat, const void* e_alive,
                        const void* v_lat, const void* v_alive,
                        const int64_t* bounds, const void* perm,
                        const void* valid, void* me, void* mv, void* stream,
                        int64_t* launched) {
    if (C <= 0 || m + n <= 0) return static_cast<int>(cudaGetLastError());
    for (int64_t c = 0; c < C; ++c)
        if (bounds[c] < 0 || bounds[c] >= H)
            return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t etiles = (m + kRowTile - 1) / kRowTile;
    const int64_t tiles = etiles + (n + kRowTile - 1) / kRowTile;
    const T* el = static_cast<const T*>(e_lat);
    const T* vl = static_cast<const T*>(v_lat);
    const uint8_t* ea = static_cast<const uint8_t*>(e_alive);
    const uint8_t* va = static_cast<const uint8_t*>(v_alive);
    const int32_t* pm = static_cast<const int32_t*>(perm);
    const uint8_t* vd = static_cast<const uint8_t*>(valid);
    uint8_t* oe = static_cast<uint8_t*>(me);
    uint8_t* ov = static_cast<uint8_t*>(mv);
    for (int64_t c0 = 0; c0 < C; c0 += kColGroup) {
        ColGroup g{};
        g.c0 = c0;
        g.cg = static_cast<int32_t>(C - c0 < kColGroup ? C - c0 : kColGroup);
        // the group's distinct hops in order of first use, and the count of
        // columns each
        int slot[kColGroup], count[kColGroup] = {};
        for (int c = 0; c < g.cg; ++c) {
            const int32_t h = static_cast<int32_t>(bounds[c0 + c]);
            int j = 0;
            while (j < g.nh && g.hop[j] != h) ++j;
            if (j == g.nh) g.hop[g.nh++] = h;
            slot[c] = j;
            ++count[j];
            g.lo[c] = bounds[C + c0 + c];
            if (bounds[2 * C + c0 + c]) g.nowin |= uint64_t{1} << c;
        }
        for (int j = 0; j < g.nh; ++j)
            g.off[j + 1] = static_cast<uint8_t>(g.off[j] + count[j]);
        int fill[kColGroup];
        for (int j = 0; j < g.nh; ++j) fill[j] = g.off[j];
        for (int c = 0; c < g.cg; ++c)
            g.col[fill[slot[c]]++] = static_cast<uint8_t>(c);
        if (C % 4 == 0)
            column_masks_kernel<T, 4><<<static_cast<unsigned>(tiles), kRowTile, 0, st>>>(
                m, m_src, n, C, etiles, el, ea, vl, va, pm, vd, oe, ov, g);
        else if (C % 2 == 0)
            column_masks_kernel<T, 2><<<static_cast<unsigned>(tiles), kRowTile, 0, st>>>(
                m, m_src, n, C, etiles, el, ea, vl, va, pm, vd, oe, ov, g);
        else
            column_masks_kernel<T, 1><<<static_cast<unsigned>(tiles), kRowTile, 0, st>>>(
                m, m_src, n, C, etiles, el, ea, vl, va, pm, vd, oe, ov, g);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ++*launched;
    }
    return static_cast<int>(cudaSuccess);
}

template <typename T>
int k1_entry(int64_t len, int64_t H, int64_t W, int64_t U, int64_t h0,
             int64_t tw, const void* base_l, const void* base_a,
             const void* d_pos, const void* d_lat, const void* d_alive,
             const void* lo, const void* nowin, void* adv_l, void* adv_a,
             void* touch, void* out, void* stream, int64_t* launched) {
    const K1Args<MaskCell<T>> a{len, H, W, U, tw, h0,
                                static_cast<const T*>(base_l),
                                static_cast<const uint8_t*>(base_a),
                                static_cast<const int32_t*>(d_pos),
                                static_cast<const T*>(d_lat),
                                static_cast<const uint8_t*>(d_alive),
                                static_cast<const T*>(lo),
                                static_cast<const uint8_t*>(nowin),
                                static_cast<T*>(adv_l),
                                static_cast<uint8_t*>(adv_a),
                                static_cast<uint8_t*>(touch),
                                static_cast<uint8_t*>(out)};
    return masks_from_deltas<MaskCell<T>>(
        a, static_cast<cudaStream_t>(stream), launched);
}

}  // namespace

extern "C" {

// K1: len rows, H hops, W windows, U updates a hop, h0, tw (touch word
// bytes: 1, 4 or 8 — groups of 8, 32 or 64 hops) | base_l [len], base_a
// [len] bool, d_pos [H, U] int32 (pads outside [0, len)), d_lat [H, U],
// d_alive [H, U] bool, lo [H*W], nowin [H*W] bool | adv_l, adv_a [len] (the
// advanced state, never the base's own buffers), touch [len] words
// (scratch, a multiple of 4 bytes), out [len, H*W] bool, 16-byte aligned.
// One cooperative launch (none for len 0); adds it to *launched.
int rtpu_masks_from_deltas_i32(int64_t len, int64_t H, int64_t W, int64_t U,
                               int64_t h0, int64_t tw, const void* base_l,
                               const void* base_a, const void* d_pos,
                               const void* d_lat, const void* d_alive,
                               const void* lo, const void* nowin, void* adv_l,
                               void* adv_a, void* touch, void* out,
                               void* stream, int64_t* launched) {
    return k1_entry<int32_t>(len, H, W, U, h0, tw, base_l, base_a, d_pos,
                             d_lat, d_alive, lo, nowin, adv_l, adv_a, touch,
                             out, stream, launched);
}

int rtpu_masks_from_deltas_i64(int64_t len, int64_t H, int64_t W, int64_t U,
                               int64_t h0, int64_t tw, const void* base_l,
                               const void* base_a, const void* d_pos,
                               const void* d_lat, const void* d_alive,
                               const void* lo, const void* nowin, void* adv_l,
                               void* adv_a, void* touch, void* out,
                               void* stream, int64_t* launched) {
    return k1_entry<int64_t>(len, H, W, U, h0, tw, base_l, base_a, d_pos,
                             d_lat, d_alive, lo, nowin, adv_l, adv_a, touch,
                             out, stream, launched);
}

// K6w: len rows, H hops, U updates a hop, h0, tw (touch word bytes, as
// K1's) | base [len] f32, d_pos [H, U] int32 (pads outside [0, len)),
// d_val [H, U] f32 | adv [len] f32 (the advanced state, never the base),
// touch [len] words (scratch, a multiple of 4 bytes), out [len, H] f32,
// 16-byte aligned. One cooperative launch (none for len 0); adds it to
// *launched.
int rtpu_weights_from_deltas(int64_t len, int64_t H, int64_t U, int64_t h0,
                             int64_t tw, const void* base,
                             const void* d_pos, const void* d_val,
                             void* adv, void* touch, void* out,
                             void* stream, int64_t* launched) {
    const K1Args<WeightCell> a{len, H, 1, U, tw, h0,
                               static_cast<const float*>(base), nullptr,
                               static_cast<const int32_t*>(d_pos),
                               static_cast<const float*>(d_val), nullptr,
                               nullptr, nullptr, static_cast<float*>(adv),
                               nullptr, static_cast<uint8_t*>(touch),
                               static_cast<float*>(out)};
    return masks_from_deltas<WeightCell>(
        a, static_cast<cudaStream_t>(stream), launched);
}

// K3: m edges and n vertices, H hops, C columns | e_lat, e_alive [H, m],
// v_lat, v_alive [H, n] on the card | bounds: a HOST array of 3C int64 —
// hop_of_col[0, C) (each in [0, H)), lo[0, C) (each inside the times'
// dtype's range), nowin[0, C) (0 or 1) | me [m, C], mv [n, C] on the card,
// 16-byte aligned | launched: one launch a group of 64 columns (none when
// there is nothing to write).
int rtpu_column_masks_i32(int64_t m, int64_t n, int64_t H, int64_t C,
                          const void* e_lat, const void* e_alive,
                          const void* v_lat, const void* v_alive,
                          const int64_t* bounds, void* me, void* mv,
                          void* stream, int64_t* launched) {
    return column_masks_launch<int32_t>(m, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, bounds, nullptr, nullptr, me,
                                        mv, stream, launched);
}

int rtpu_column_masks_i64(int64_t m, int64_t n, int64_t H, int64_t C,
                          const void* e_lat, const void* e_alive,
                          const void* v_lat, const void* v_alive,
                          const int64_t* bounds, void* me, void* mv,
                          void* stream, int64_t* launched) {
    return column_masks_launch<int64_t>(m, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, bounds, nullptr, nullptr, me,
                                        mv, stream, launched);
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
// columns, 0 where !valid[b]; mv [n, C] as K3; the bounds as K3's. One
// launch a group of 64 columns.
int rtpu_bin_column_masks_i32(int64_t B, int64_t m, int64_t n, int64_t H,
                              int64_t C, const void* e_lat,
                              const void* e_alive, const void* v_lat,
                              const void* v_alive, const int64_t* bounds,
                              const void* perm, const void* valid, void* me,
                              void* mv, void* stream, int64_t* launched) {
    return column_masks_launch<int32_t>(B, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, bounds, perm, valid, me, mv,
                                        stream, launched);
}

int rtpu_bin_column_masks_i64(int64_t B, int64_t m, int64_t n, int64_t H,
                              int64_t C, const void* e_lat,
                              const void* e_alive, const void* v_lat,
                              const void* v_alive, const int64_t* bounds,
                              const void* perm, const void* valid, void* me,
                              void* mv, void* stream, int64_t* launched) {
    return column_masks_launch<int64_t>(B, m, n, H, C, e_lat, e_alive, v_lat,
                                        v_alive, bounds, perm, valid, me, mv,
                                        stream, launched);
}

}  // extern "C"
