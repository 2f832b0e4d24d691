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

}  // extern "C"
