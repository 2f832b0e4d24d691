// The exchange kernels of the mesh path: the halo route's send-page pack
// (K11) and the sparse frontier route's compaction and min-merge (K13).
//
// `rtpu_halo_pack` replaces the `jnp.take(a, send_idx, axis=1)` of
// raphtory_tpu/parallel/sharded.py:704 (`exchange_halo`): the rows
// `send_idx[j]` (int32 [S*h], chunk r = the local rows requester r
// referenced; pad slots point at row n-1) of a state leaf [k, n, row]
// gathered into the send page, written slot-major [S*h, k, row]: the
// layout all_to_all splits into one contiguous chunk a peer, so no copy
// reorders it. Any dtype: a row is copied as 8-, 4-, 2- or 1-byte words.
// An index outside [0, n) writes zeros (the partition never makes one).
// One thread per (slot, window, word).
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
// atomics.
//
// `rtpu_frontier_merge_min` replaces the `np.minimum.at` merge of
// frontier.py:498-502: for each of the R gathered slices and each slot
// below that slice's count, replica[idx] = min(replica[idx], val) with
// np.minimum's semantics (a NaN on either side wins). Each row has one
// owner, so no two live slots name one row: a plain read-modify-write, no
// atomics, exact for floats and integers alike; pad slots are skipped by
// count. One thread per (slot, element).
//
// What bounds them on the H100: bytes (a compare or a copy per element).
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
__global__ void halo_pack_kernel(int64_t k, int64_t n, int64_t sh,
                                 int64_t words,
                                 const int32_t* __restrict__ send_idx,
                                 const W* __restrict__ src,
                                 W* __restrict__ out) {
    const int64_t total = sh * k * words;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t w = t % words;
        const int64_t kk = (t / words) % k;
        const int64_t j = t / (words * k);
        const int64_t s = send_idx[j];
        out[t] = (s >= 0 && s < n) ? src[(kk * n + s) * words + w] : W(0);
    }
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
__global__ void merge_min_kernel(int64_t r, int64_t bucket, int64_t f,
                                 int64_t n, const int64_t* __restrict__ counts,
                                 const int64_t* __restrict__ idx,
                                 const T* __restrict__ val,
                                 T* __restrict__ replica) {
    const int64_t total = r * bucket * f;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t e = t % f;
        const int64_t slot = t / f;
        const int64_t rr = slot / bucket, j = slot % bucket;
        if (j >= counts[rr]) continue;            // pad slot
        const int64_t row = idx[slot];
        if (row < 0 || row >= n) continue;
        T* c = replica + row * f + e;
        *c = np_min(*c, val[t]);
    }
}

}  // namespace

extern "C" {

int rtpu_halo_pack(int64_t k, int64_t n, int64_t sh, int64_t row_bytes,
                   const void* send_idx, const void* src, void* out,
                   void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* ids = static_cast<const int32_t*>(send_idx);
    const uintptr_t align = reinterpret_cast<uintptr_t>(src)
        | reinterpret_cast<uintptr_t>(out);
    if (k * sh * row_bytes == 0) return cudaGetLastError();
    if (row_bytes % 8 == 0 && align % 8 == 0) {
        const int64_t w = row_bytes / 8;
        halo_pack_kernel<uint64_t><<<blocks_for(k * sh * w), kThreads, 0, s>>>(
            k, n, sh, w, ids, static_cast<const uint64_t*>(src),
            static_cast<uint64_t*>(out));
    } else if (row_bytes % 4 == 0 && align % 4 == 0) {
        const int64_t w = row_bytes / 4;
        halo_pack_kernel<uint32_t><<<blocks_for(k * sh * w), kThreads, 0, s>>>(
            k, n, sh, w, ids, static_cast<const uint32_t*>(src),
            static_cast<uint32_t*>(out));
    } else if (row_bytes % 2 == 0 && align % 2 == 0) {
        const int64_t w = row_bytes / 2;
        halo_pack_kernel<uint16_t><<<blocks_for(k * sh * w), kThreads, 0, s>>>(
            k, n, sh, w, ids, static_cast<const uint16_t*>(src),
            static_cast<uint16_t*>(out));
    } else {
        halo_pack_kernel<uint8_t><<<blocks_for(k * sh * row_bytes), kThreads,
                                    0, s>>>(
            k, n, sh, row_bytes, ids, static_cast<const uint8_t*>(src),
            static_cast<uint8_t*>(out));
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

// dtype: 0 float32, 1 int32, 2 float64, 3 int64
int rtpu_frontier_merge_min(int64_t r, int64_t bucket, int64_t f, int64_t n,
                            int64_t dtype, const void* counts, const void* idx,
                            const void* val, void* replica, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t total = r * bucket * f;
    if (total == 0) return cudaGetLastError();
    const auto* c = static_cast<const int64_t*>(counts);
    const auto* ix = static_cast<const int64_t*>(idx);
    const int64_t g = blocks_for(total);
    switch (dtype) {
    case 0:
        merge_min_kernel<float><<<g, kThreads, 0, s>>>(
            r, bucket, f, n, c, ix, static_cast<const float*>(val),
            static_cast<float*>(replica));
        break;
    case 1:
        merge_min_kernel<int32_t><<<g, kThreads, 0, s>>>(
            r, bucket, f, n, c, ix, static_cast<const int32_t*>(val),
            static_cast<int32_t*>(replica));
        break;
    case 2:
        merge_min_kernel<double><<<g, kThreads, 0, s>>>(
            r, bucket, f, n, c, ix, static_cast<const double*>(val),
            static_cast<double*>(replica));
        break;
    case 3:
        merge_min_kernel<int64_t><<<g, kThreads, 0, s>>>(
            r, bucket, f, n, c, ix, static_cast<const int64_t*>(val),
            static_cast<int64_t*>(replica));
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // extern "C"
