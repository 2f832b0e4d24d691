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
// `rtpu_frontier_count` + `rtpu_frontier_compact` replace the host
// compaction of raphtory_tpu/parallel/frontier.py:458-485
// (`np.flatnonzero(changed)` and the bucket fill): a count pass (one block
// per 4,096-row chunk counts its set flags; one block scans the chunk
// counts into exclusive offsets and the total, which the host reads to
// agree the bucket length B with the other ranks), then the compaction:
// each block walks its chunk in 256-row tiles, ranks its set rows with a
// warp ballot and a block scan, and writes their flat indices (int64) and
// value rows at its offset — ascending, np.flatnonzero's order, the same
// every run. Slots [count, B) get index 0 and the min identity. No
// atomics. Bound: bytes (a compare or a copy per element).
//
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
constexpr int kChunk = 4096;            // rows per count/compact block
constexpr int kScanThreads = 1024;

inline int64_t blocks_for(int64_t total) {
    int64_t b = (total + kThreads - 1) / kThreads;
    if (b > 65535 * 8) b = 65535 * 8;
    return b < 1 ? 1 : b;
}

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

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__global__ void count_kernel(int64_t n, const uint8_t* __restrict__ changed,
                             int64_t* __restrict__ counts) {
    __shared__ int part[kThreads / 32];
    const int64_t lo = (int64_t)blockIdx.x * kChunk;
    const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
    int c = 0;
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) c += changed[i] != 0;
    c = warp_sum(c);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t s = 0;
        for (int w = 0; w < kThreads / 32; ++w) s += part[w];
        counts[blockIdx.x] = s;
    }
}

// one block: exclusive scan of the G chunk counts, and their total
__global__ void scan_kernel(int64_t g, const int64_t* __restrict__ counts,
                            int64_t* __restrict__ offsets,
                            int64_t* __restrict__ total) {
    __shared__ int64_t buf[kScanThreads];
    __shared__ int64_t carry;
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (int64_t base = 0; base < g; base += kScanThreads) {
        const int64_t i = base + threadIdx.x;
        const int64_t v = i < g ? counts[i] : 0;
        buf[threadIdx.x] = v;
        __syncthreads();
        // Hillis-Steele inclusive scan over the tile
        for (int o = 1; o < kScanThreads; o <<= 1) {
            const int64_t add = threadIdx.x >= o ? buf[threadIdx.x - o] : 0;
            __syncthreads();
            buf[threadIdx.x] += add;
            __syncthreads();
        }
        if (i < g) offsets[i] = carry + buf[threadIdx.x] - v;
        __syncthreads();
        if (threadIdx.x == 0) carry += buf[kScanThreads - 1];
        __syncthreads();
    }
    if (threadIdx.x == 0) *total = carry;
}

template <typename T>
__global__ void compact_kernel(int64_t n, int64_t bucket, int64_t count,
                               int64_t f, uint64_t ident_bits,
                               const uint8_t* __restrict__ changed,
                               const int64_t* __restrict__ offsets,
                               const T* __restrict__ values,
                               int64_t* __restrict__ out_idx,
                               T* __restrict__ out_val) {
    __shared__ int warp_tot[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if ((int64_t)blockIdx.x * kChunk < n) {
        const int64_t lo = (int64_t)blockIdx.x * kChunk;
        const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
        int64_t pos = offsets[blockIdx.x];
        for (int64_t start = lo; start < hi; start += kThreads) {
            const int64_t i = start + threadIdx.x;
            const bool set = i < hi && changed[i] != 0;
            const unsigned bal = __ballot_sync(0xffffffffu, set);
            if (lane == 0) warp_tot[warp] = __popc(bal);
            __syncthreads();
            int before = 0, tile = 0;
            for (int w = 0; w < kThreads / 32; ++w) {
                before += w < warp ? warp_tot[w] : 0;
                tile += warp_tot[w];
            }
            if (set) {
                const int64_t at =
                    pos + before + __popc(bal & ((1u << lane) - 1u));
                out_idx[at] = i;
                for (int64_t e = 0; e < f; ++e) out_val[at * f + e] = values[i * f + e];
            }
            pos += tile;
            __syncthreads();
        }
    }
    T ident;
    memcpy(&ident, &ident_bits, sizeof(T));
    for (int64_t j = count + blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         j < bucket; j += (int64_t)gridDim.x * blockDim.x) {
        out_idx[j] = 0;
        for (int64_t e = 0; e < f; ++e) out_val[j * f + e] = ident;
    }
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

// launches 2 kernels: the chunk counts, then their scan and total
int rtpu_frontier_count(int64_t n, const void* changed, void* counts,
                        void* offsets, void* total, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t g = n > 0 ? (n + kChunk - 1) / kChunk : 1;
    count_kernel<<<g, kThreads, 0, s>>>(
        n, static_cast<const uint8_t*>(changed),
        static_cast<int64_t*>(counts));
    scan_kernel<<<1, kScanThreads, 0, s>>>(
        g, static_cast<const int64_t*>(counts),
        static_cast<int64_t*>(offsets), static_cast<int64_t*>(total));
    return cudaGetLastError();
}

int rtpu_frontier_compact(int64_t n, int64_t bucket, int64_t count,
                          int64_t f, int64_t esize, int64_t ident_bits,
                          const void* changed, const void* offsets,
                          const void* values, void* out_idx, void* out_val,
                          void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t g = n > 0 ? (n + kChunk - 1) / kChunk : 1;
    const int64_t pads = bucket > count ? bucket - count : 0;
    int64_t grid = g > blocks_for(pads) ? g : blocks_for(pads);
    const auto bits = static_cast<uint64_t>(ident_bits);
    const auto* ch = static_cast<const uint8_t*>(changed);
    const auto* off = static_cast<const int64_t*>(offsets);
    auto* oi = static_cast<int64_t*>(out_idx);
    if (esize == 4) {
        compact_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
            n, bucket, count, f, bits, ch, off,
            static_cast<const uint32_t*>(values), oi,
            static_cast<uint32_t*>(out_val));
    } else if (esize == 8) {
        compact_kernel<uint64_t><<<grid, kThreads, 0, s>>>(
            n, bucket, count, f, bits, ch, off,
            static_cast<const uint64_t*>(values), oi,
            static_cast<uint64_t*>(out_val));
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
