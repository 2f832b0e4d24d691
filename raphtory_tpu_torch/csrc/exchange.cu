// The exchange kernels of the mesh path: the halo route's send-page pack
// (K11) and the sparse frontier route's compaction and min-merge (K13).
//
// `rtpu_halo_pack` replaces the `jnp.take(a, send_idx, axis=1)` of
// raphtory_tpu/parallel/sharded.py:704 (`exchange_halo`): the rows
// `send_idx[j]` (int32 [S*h], chunk r = the local rows requester r
// referenced, sorted and unique; pad slots name a valid row) of a state
// leaf [k, n, row] gathered into the send page, written slot-major [S*h,
// k, row]: the layout all_to_all splits into one contiguous chunk a peer,
// so no copy reorders it. Any dtype. An index outside [0, n) writes zeros
// (the partition never makes one).
//   Bound: bytes. The page is written once (S*h*k*row bytes, contiguous)
// and each slot reads k rows that lie n rows apart; for 4-byte rows a
// read costs the 32-byte sector it falls in, so the reads cost what the
// referenced rows' sectors add up to (a chunk's sorted indices share
// sectors where they are dense). Design: a group of `lanes` threads a
// slot reads send_idx[j] once and copies the slot's k rows in the widest
// word that the row bytes and the leaf's alignment allow (16, 8, 4, 2 or
// 1 bytes); neighbouring slots sit on neighbouring lanes, so one window's
// reads of a sorted chunk coalesce. A block stages its tile of slots in
// shared memory and writes the tile, which is one contiguous span of the
// page, in 16-byte vectors: the page costs no more store sectors than its
// bytes (a thread writing its own slot's k words would touch k times as
// many). Rows too wide to stage are copied straight to the page, which is
// then coalesced already. Index arithmetic is 32-bit within a block and
// 64-bit only for a block's and a row's base; no division. The launch
// plan (word, lanes, tile, grid, shared bytes) comes from the wrapper,
// computed once per input signature (ops/exchange.py `halo_plan`).
//
// `rtpu_frontier_compact` + `rtpu_frontier_pad` replace the host
// compaction of raphtory_tpu/parallel/frontier.py:458-485
// (`np.flatnonzero(changed)` and the bucket fill). The first counts and
// compacts in one pass, a decoupled look-back scan (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016):
// each block takes a tile of 8,192 rows by an atomic ticket (so a tile
// only ever waits on tiles that have started), reads its flags 32 a
// thread, scans their counts, stages each warp's set rows in order in
// shared memory, publishes its count, looks back over its predecessors'
// status words (a warp reads 32 at a time, nearest first, summing counts
// until it meets an inclusive prefix), publishes its own inclusive
// prefix, and writes its set rows' int64 flat indices and value rows at
// their ranks, a warp's run from consecutive lanes: ascending,
// np.flatnonzero's order, the same every run. A status word carries the
// call's epoch beside its flag and value, so words of earlier calls read
// as "not yet" and no launch clears them; the tile with the last ticket
// sets the ticket back to 0 (every tile has taken its own by then) and
// writes the total to device memory. The output buffers hold N rows (the
// bucket never exceeds N), so the count needs no read-back before the
// compaction: the ranks agree the bucket from the device count
// afterwards. `rtpu_frontier_pad` then fills slots [count, B) with index
// 0 and the min identity, reading the count from device memory.
//   Bound: bytes (the flags read once, the set rows read and written once,
// the pads written once), and at small N the chain of latencies a block
// waits through, which keeps tiles small enough that the mesh shape's
// 98,304 rows spread over 12 blocks. The flags arrive as two 16-byte
// loads a thread where the mask is 16-byte aligned; the writes are
// coalesced; scalar rows' values are loaded kAhead a lane before any is
// stored, the first batch before the look-back, so their latency
// overlaps it.

// `rtpu_frontier_merge_min` replaces the `np.minimum.at` merge of
// frontier.py:498-502: for each of the R gathered slices and each slot
// below that slice's count, replica[idx] = min(replica[idx], val) with
// np.minimum's semantics (a NaN on either side wins). Each row has one
// owner, so no two live slots name one row: a plain read-modify-write, no
// atomics, exact for floats and integers alike.
//   Bound: bytes. The live slots' indices and values are read once
// (coalesced), and each names a replica row that is read and written
// once; for 4-byte rows that costs the 32-byte sectors the live rows fall
// in (a slice is ascending, so dense slices share sectors, sparse ones
// pay a sector a row). Design: the grid is (slot tile, slice); a block
// reads its slice's count once (the counts may be a strided column) and
// a block whose tile starts past it exits at once, so the pad slots of a
// slice cost no loads; within a tile a group of `lanes` threads a slot
// reads its index once and merges the row's elements. No division.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/
// exchange.py). Each entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(256) halo_pack_kernel(
        int k, int64_t n, int64_t sh, int words, int tile, int staged,
        const int32_t* __restrict__ send_idx, const W* __restrict__ src,
        W* __restrict__ out) {
    extern __shared__ uint4 stage[];
    const int64_t j0 = (int64_t)blockIdx.x * tile;
    const int64_t left = sh - j0;
    const int cnt = left < tile ? (int)left : tile;
    const int slot_words = k * words;
    W* page = out + j0 * slot_words;           // this tile's span of the page
    W* dst = staged ? reinterpret_cast<W*>(stage) : page;
    const int64_t win = n * words;             // words between two windows
    for (int jl = threadIdx.y; jl < cnt; jl += blockDim.y) {
        const int32_t s = send_idx[j0 + jl];   // once a slot
        const bool ok = s >= 0 && s < n;
        const W* row = src + (ok ? (int64_t)s * words : 0);
        W* d = dst + (int64_t)jl * slot_words;
        for (int kk = 0; kk < k; ++kk, row += win, d += words)
            for (int w = threadIdx.x; w < words; w += blockDim.x)
                d[w] = ok ? row[w] : W{};
    }
    if (!staged) return;
    __syncthreads();
    // the tile is one contiguous span of the page, 16-byte aligned (the
    // plan's tile times a slot's bytes is a multiple of 16)
    const int nbytes = cnt * slot_words * (int)sizeof(W);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nth = blockDim.x * blockDim.y;
    const int n16 = nbytes >> 4;
    uint4* p16 = reinterpret_cast<uint4*>(page);
    for (int i = tid; i < n16; i += nth) p16[i] = stage[i];
    const W* sw = reinterpret_cast<const W*>(stage);
    const int nw = nbytes / (int)sizeof(W);
    for (int i = n16 * (16 / (int)sizeof(W)) + tid; i < nw; i += nth)
        page[i] = sw[i];
}

// the one-pass compaction: a tile of kTileRows rows a block, kThreadRows
// rows a thread (two 16-byte loads of flags)
constexpr int kTileThreads = 256;
constexpr int kThreadRows = 32;
constexpr int kTileRows = kTileThreads * kThreadRows;
constexpr int kAhead = 4;               // values a lane loads before storing
// a tile's status word: epoch (22 bits) | flag (2) | value (40)
constexpr unsigned long long kAggregate = 1, kPrefix = 2;
constexpr unsigned long long kValueMask = (1ull << 40) - 1;

__device__ __forceinline__ unsigned long long status_word(
        unsigned long long epoch, unsigned long long flag, int64_t value) {
    return (epoch << 42) | (flag << 40) | (unsigned long long)value;
}
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(w)
                 : "memory");
}
__device__ __forceinline__ unsigned long long load_status(
        const unsigned long long* p) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p)
                 : "memory");
    return w;
}

// scratch[0] the ticket, scratch[1 + t] tile t's status word
template <typename T>
__global__ void __launch_bounds__(kTileThreads) compact_kernel(
        int64_t n, int64_t f, int64_t tiles, unsigned long long epoch,
        const uint8_t* __restrict__ changed, const T* __restrict__ values,
        int64_t* __restrict__ out_idx, T* __restrict__ out_val,
        int64_t* __restrict__ count,
        unsigned long long* __restrict__ scratch) {
    __shared__ int64_t s_tile, s_excl;
    __shared__ int warp_total[kTileThreads / 32];
    // each warp's set rows (offsets in the tile), in order
    __shared__ uint16_t s_rows[kTileRows];
    unsigned long long* status = scratch + 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
        const int64_t t = (int64_t)atomicAdd(scratch, 1ull);
        if (t == tiles - 1) atomicExch(scratch, 0ull);   // all are taken
        s_tile = t;
    }
    __syncthreads();
    const int64_t tile = s_tile;
    const int first = threadIdx.x * kThreadRows;       // in the tile
    const int64_t base = tile * kTileRows + first;
    unsigned bits = 0;                       // bit k: row base + k is set
    if (base + kThreadRows <= n
            && (reinterpret_cast<uintptr_t>(changed) & 15) == 0) {
        const uint4* p = reinterpret_cast<const uint4*>(changed + base);
        uint4 v[kThreadRows / 16];
#pragma unroll
        for (int h = 0; h < kThreadRows / 16; ++h) v[h] = p[h];
#pragma unroll
        for (int h = 0; h < kThreadRows / 16; ++h) {
            const unsigned w[4] = {v[h].x, v[h].y, v[h].z, v[h].w};
#pragma unroll
            for (int k = 0; k < 16; ++k)
                bits |= ((w[k >> 2] >> (8 * (k & 3))) & 0xffu)
                    ? 1u << (16 * h + k) : 0u;
        }
    } else {
        for (int k = 0; k < kThreadRows; ++k)
            if (base + k < n && changed[base + k]) bits |= 1u << k;
    }
    // the warp's scan of the threads' counts; each thread stages its set
    // rows at its rank in the warp's run of s_rows
    const int c = __popc(bits);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    const int run_len = __shfl_sync(0xffffffffu, incl, 31);
    uint16_t* run = s_rows + warp * 32 * kThreadRows;
    int at = incl - c;
    for (unsigned b = bits; b; b &= b - 1, ++at)
        run[at] = (uint16_t)(first + __ffs(b) - 1);
    __syncwarp();
    // scalar rows: the run's first kAhead x 32 values are loaded now, so
    // their latency hides behind the look-back
    const int64_t tile0 = tile * kTileRows;
    T ahead[kAhead];
    if (f == 1) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const int i = lane + 32 * u;
            if (i < run_len) ahead[u] = values[tile0 + run[i]];
        }
    }
    __syncthreads();
    int before = 0, aggregate = 0;
    for (int w = 0; w < kTileThreads / 32; ++w) {
        before += w < warp ? warp_total[w] : 0;
        aggregate += warp_total[w];
    }
    // the look-back (warp 0): the rows set in the tiles before this one
    if (warp == 0) {
        int64_t excl = 0;
        if (tile == 0) {
            if (lane == 0)
                store_status(status, status_word(epoch, kPrefix, aggregate));
        } else {
            if (lane == 0)
                store_status(status + tile,
                             status_word(epoch, kAggregate, aggregate));
            for (int64_t pred = tile - 1;; pred -= 32) {
                const int64_t i = pred - lane;
                unsigned long long w = status_word(epoch, kPrefix, 0);
                if (i >= 0) {
                    do {
                        w = load_status(status + i);
                    } while ((w >> 42) != epoch);
                }
                const unsigned done = __ballot_sync(
                    0xffffffffu, ((w >> 40) & 3) == kPrefix);
                const int cut = done ? __ffs(done) - 1 : 31;
                int64_t v = lane <= cut ? (int64_t)(w & kValueMask) : 0;
                for (int o = 16; o > 0; o >>= 1)
                    v += __shfl_xor_sync(0xffffffffu, v, o);
                excl += v;
                if (done) break;
            }
            if (lane == 0)
                store_status(status + tile,
                             status_word(epoch, kPrefix, excl + aggregate));
        }
        if (lane == 0) {
            s_excl = excl;
            if (tile == tiles - 1) *count = excl + aggregate;
        }
    }
    __syncthreads();
    // each warp writes its run: consecutive lanes, consecutive slots
    const int64_t out0 = s_excl + before;
    if (f != 1) {
        for (int i = lane; i < run_len; i += 32) {
            const int64_t row = tile0 + run[i];
            out_idx[out0 + i] = row;
            for (int64_t e = 0; e < f; ++e)
                out_val[(out0 + i) * f + e] = values[row * f + e];
        }
        return;
    }
    for (int i0 = 0; i0 < run_len; i0 += kAhead * 32) {
        if (i0) {                             // the next kAhead x 32 values
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
                const int i = i0 + lane + 32 * u;
                if (i < run_len) ahead[u] = values[tile0 + run[i]];
            }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const int i = i0 + lane + 32 * u;
            if (i < run_len) {
                out_idx[out0 + i] = tile0 + run[i];
                out_val[out0 + i] = ahead[u];
            }
        }
    }
}

// slots [count, bucket): index 0 and the identity
template <typename T>
__global__ void pad_kernel(int64_t bucket, int64_t f, uint64_t ident_bits,
                           const int64_t* __restrict__ count,
                           int64_t* __restrict__ out_idx,
                           T* __restrict__ out_val) {
    T ident;
    memcpy(&ident, &ident_bits, sizeof(T));
    const int64_t c = *count;
    const int64_t t0 = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t j = c + t0; j < bucket; j += step) out_idx[j] = 0;
    for (int64_t e = c * f + t0; e < bucket * f; e += step) out_val[e] = ident;
}

template <typename T>
__device__ __forceinline__ T np_min(T cur, T v) { return v < cur ? v : cur; }
template <>
__device__ __forceinline__ float np_min(float cur, float v) {
    return (v < cur || v != v) ? v : cur;   // a NaN on either side wins
}
template <>
__device__ __forceinline__ double np_min(double cur, double v) {
    return (v < cur || v != v) ? v : cur;
}

template <typename T>
__global__ void __launch_bounds__(256) merge_min_kernel(
        int64_t bucket, int f, int64_t n, int64_t cstride, int tile,
        const int64_t* __restrict__ counts, const int64_t* __restrict__ idx,
        const T* __restrict__ val, T* __restrict__ replica) {
    __shared__ int64_t live;
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        const int64_t c = counts[blockIdx.y * cstride];
        live = c < 0 ? 0 : (c < bucket ? c : bucket);
    }
    __syncthreads();
    const int64_t s0 = (int64_t)blockIdx.x * tile;
    if (s0 >= live) return;                   // pad slots: nothing to read
    const int64_t left = live - s0;
    const int cnt = left < tile ? (int)left : tile;
    const int64_t base = (int64_t)blockIdx.y * bucket + s0;
    for (int jl = threadIdx.y; jl < cnt; jl += blockDim.y) {
        const int64_t slot = base + jl;
        const int64_t row = idx[slot];        // once a slot
        if (row < 0 || row >= n) continue;
        T* c = replica + row * f;
        const T* v = val + slot * f;
        for (int e = threadIdx.x; e < f; e += blockDim.x)
            c[e] = np_min(c[e], v[e]);
    }
}

}  // namespace

extern "C" {

// plan (ops/exchange.py `halo_plan`): k, n, S*h, row bytes, word bytes,
// lanes, tile (slots a block), staged, grid, shared bytes
int rtpu_halo_pack(const void* plan, const void* send_idx, const void* src,
                   void* out, void* stream) {
    const auto* p = static_cast<const int64_t*>(plan);
    const int k = (int)p[0], words = (int)(p[3] / p[4]), lanes = (int)p[5],
              tile = (int)p[6], staged = (int)p[7];
    const int64_t n = p[1], sh = p[2], grid = p[8];
    const size_t smem = (size_t)p[9];
    if (grid == 0) return cudaGetLastError();
    const dim3 block(lanes, 256 / lanes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* ids = static_cast<const int32_t*>(send_idx);
    switch (p[4]) {
    case 16:
        halo_pack_kernel<uint4><<<(unsigned)grid, block, smem, s>>>(
            k, n, sh, words, tile, staged, ids,
            static_cast<const uint4*>(src), static_cast<uint4*>(out));
        break;
    case 8:
        halo_pack_kernel<uint64_t><<<(unsigned)grid, block, smem, s>>>(
            k, n, sh, words, tile, staged, ids,
            static_cast<const uint64_t*>(src), static_cast<uint64_t*>(out));
        break;
    case 4:
        halo_pack_kernel<uint32_t><<<(unsigned)grid, block, smem, s>>>(
            k, n, sh, words, tile, staged, ids,
            static_cast<const uint32_t*>(src), static_cast<uint32_t*>(out));
        break;
    case 2:
        halo_pack_kernel<uint16_t><<<(unsigned)grid, block, smem, s>>>(
            k, n, sh, words, tile, staged, ids,
            static_cast<const uint16_t*>(src), static_cast<uint16_t*>(out));
        break;
    case 1:
        halo_pack_kernel<uint8_t><<<(unsigned)grid, block, smem, s>>>(
            k, n, sh, words, tile, staged, ids,
            static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out));
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// plan (ops/exchange.py `_count_signature`): N, F (elements a row),
// element bytes, tiles | epoch (1 .. 2^22 - 1, new each call on this
// scratch) | changed [N] bool, values [N, F], out_idx [>= N] int64,
// out_val [>= N, F], count [1] int64, scratch [1 + tiles] (zeroed once)
int rtpu_frontier_compact(const void* plan, int64_t epoch,
                          const void* changed, const void* values,
                          void* out_idx, void* out_val, void* count,
                          void* scratch, void* stream) {
    const auto* p = static_cast<const int64_t*>(plan);
    const int64_t n = p[0], f = p[1], tiles = p[3];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* ch = static_cast<const uint8_t*>(changed);
    auto* oi = static_cast<int64_t*>(out_idx);
    auto* cnt = static_cast<int64_t*>(count);
    auto* sc = static_cast<unsigned long long*>(scratch);
    const auto ep = static_cast<unsigned long long>(epoch);
    if (p[2] == 4) {
        compact_kernel<uint32_t><<<(unsigned)tiles, kTileThreads, 0, s>>>(
            n, f, tiles, ep, ch, static_cast<const uint32_t*>(values), oi,
            static_cast<uint32_t*>(out_val), cnt, sc);
    } else if (p[2] == 8) {
        compact_kernel<uint64_t><<<(unsigned)tiles, kTileThreads, 0, s>>>(
            n, f, tiles, ep, ch, static_cast<const uint64_t*>(values), oi,
            static_cast<uint64_t*>(out_val), cnt, sc);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// plan (ops/exchange.py `_pad_signature`): bucket, F, element bytes, the
// identity's bits, grid | count [1] int64, out_idx, out_val
int rtpu_frontier_pad(const void* plan, const void* count, void* out_idx,
                      void* out_val, void* stream) {
    const auto* p = static_cast<const int64_t*>(plan);
    const int64_t bucket = p[0], f = p[1], grid = p[4];
    if (grid == 0) return cudaGetLastError();
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto bits = static_cast<uint64_t>(p[3]);
    const auto* cnt = static_cast<const int64_t*>(count);
    auto* oi = static_cast<int64_t*>(out_idx);
    if (p[2] == 4) {
        pad_kernel<uint32_t><<<(unsigned)grid, kThreads, 0, s>>>(
            bucket, f, bits, cnt, oi, static_cast<uint32_t*>(out_val));
    } else if (p[2] == 8) {
        pad_kernel<uint64_t><<<(unsigned)grid, kThreads, 0, s>>>(
            bucket, f, bits, cnt, oi, static_cast<uint64_t*>(out_val));
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// plan (ops/exchange.py `merge_plan`): R, B, F, n, dtype (0 float32, 1
// int32, 2 float64, 3 int64), the counts' stride, lanes, tile, grid x
int rtpu_frontier_merge_min(const void* plan, const void* counts,
                            const void* idx, const void* val, void* replica,
                            void* stream) {
    const auto* p = static_cast<const int64_t*>(plan);
    const int64_t r = p[0], bucket = p[1], n = p[3], cstride = p[5];
    const int f = (int)p[2], lanes = (int)p[6], tile = (int)p[7];
    const dim3 grid((unsigned)p[8], (unsigned)r);
    if (p[8] == 0 || r == 0) return cudaGetLastError();
    const dim3 block(lanes, 256 / lanes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* c = static_cast<const int64_t*>(counts);
    const auto* ix = static_cast<const int64_t*>(idx);
    switch (p[4]) {
    case 0:
        merge_min_kernel<float><<<grid, block, 0, s>>>(
            bucket, f, n, cstride, tile, c, ix,
            static_cast<const float*>(val), static_cast<float*>(replica));
        break;
    case 1:
        merge_min_kernel<int32_t><<<grid, block, 0, s>>>(
            bucket, f, n, cstride, tile, c, ix,
            static_cast<const int32_t*>(val), static_cast<int32_t*>(replica));
        break;
    case 2:
        merge_min_kernel<double><<<grid, block, 0, s>>>(
            bucket, f, n, cstride, tile, c, ix,
            static_cast<const double*>(val), static_cast<double*>(replica));
        break;
    case 3:
        merge_min_kernel<int64_t><<<grid, block, 0, s>>>(
            bucket, f, n, cstride, tile, c, ix,
            static_cast<const int64_t*>(val), static_cast<int64_t*>(replica));
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // extern "C"
