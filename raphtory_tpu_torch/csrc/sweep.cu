// K9a, K9b and K8u — the device half of the resident sweep and of the
// cold route's masks.
//
// K9a `rtpu_apply_delta_chunk` replaces raphtory_tpu/engine/
// device_sweep.py:239 `_compiled_apply`: scatter-set one padded delta chunk
// into the six resident fold-state buffers (v_lat, v_alive, v_first over
// n_pad vertices; e_lat, e_alive, e_first over m_pad edges), in place. The
// reference drops a pad row through an out-of-range index (2^31-1) under
// mode="drop"; here every index outside [0, len) is skipped explicitly.
// The host fold emits each entity at most once per chunk, so the writes
// never race. One thread per chunk row: threads [0, cap_v) take the vertex
// rows, the next cap_e threads the edge rows.
//
// K9b `rtpu_window_masks` replaces the mask half of device_sweep.py:261
// `_compiled_run` (:273-277):
//     mask[w, i] = alive[i] & (nowin[w] | lat[i] >= lo[w])
// for the vertices and the edges in one launch, over the resident times in
// their narrow dtype (int32 or int64); lo[w] = clamp(T - win[w]) into that
// dtype's range is computed by the wrapper (a clamped lo only widens the
// window past every real time).
//
// K8u `rtpu_unpack_mask_bits` replaces raphtory_tpu/engine/bsp.py:39
// `_unpack_bits`: u8[rows, nbytes] in little bit order to bool[rows,
// 8*nbytes] — the cold route ships its window masks bit-packed and unpacks
// them on the card. One thread per output byte.
//
// What bounds them on the H100: bytes (one compare or shift per element).
// K9a moves O(chunk) bytes and is launch-bound at the path's shapes.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/
// resident.py). Each entry point launches one kernel on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline int64_t blocks_for(int64_t total) {
    int64_t b = (total + kThreads - 1) / kThreads;
    if (b > 65535 * 8) b = 65535 * 8;
    return b < 1 ? 1 : b;
}

template <typename T>
__global__ void apply_delta_kernel(int64_t n_pad, int64_t m_pad,
                                   int64_t cap_v, int64_t cap_e,
                                   T* __restrict__ v_lat,
                                   uint8_t* __restrict__ v_alive,
                                   T* __restrict__ v_first,
                                   T* __restrict__ e_lat,
                                   uint8_t* __restrict__ e_alive,
                                   T* __restrict__ e_first,
                                   const int32_t* __restrict__ v_idx,
                                   const T* __restrict__ vd_lat,
                                   const uint8_t* __restrict__ vd_alive,
                                   const T* __restrict__ vd_first,
                                   const int32_t* __restrict__ e_idx,
                                   const T* __restrict__ ed_lat,
                                   const uint8_t* __restrict__ ed_alive,
                                   const T* __restrict__ ed_first) {
    const int64_t total = cap_v + cap_e;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        if (t < cap_v) {
            const int64_t p = v_idx[t];
            if (p < 0 || p >= n_pad) continue;       // pad row
            v_lat[p] = vd_lat[t];
            v_alive[p] = vd_alive[t];
            v_first[p] = vd_first[t];
        } else {
            const int64_t i = t - cap_v;
            const int64_t p = e_idx[i];
            if (p < 0 || p >= m_pad) continue;       // pad row
            e_lat[p] = ed_lat[i];
            e_alive[p] = ed_alive[i];
            e_first[p] = ed_first[i];
        }
    }
}

template <typename T>
__global__ void window_masks_kernel(int64_t k, int64_t n, int64_t m,
                                    const T* __restrict__ v_lat,
                                    const uint8_t* __restrict__ v_alive,
                                    const T* __restrict__ e_lat,
                                    const uint8_t* __restrict__ e_alive,
                                    const T* __restrict__ lo,
                                    const uint8_t* __restrict__ nowin,
                                    uint8_t* __restrict__ v_out,
                                    uint8_t* __restrict__ e_out) {
    const int64_t nv = k * n;
    const int64_t total = nv + k * m;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        if (t < nv) {
            const int64_t w = t / n, i = t - w * n;
            v_out[t] = v_alive[i] && (nowin[w] || v_lat[i] >= lo[w]);
        } else {
            const int64_t u = t - nv;
            const int64_t w = u / m, i = u - w * m;
            e_out[u] = e_alive[i] && (nowin[w] || e_lat[i] >= lo[w]);
        }
    }
}

__global__ void unpack_bits_kernel(int64_t total,
                                   const uint8_t* __restrict__ packed,
                                   uint8_t* __restrict__ out) {
    // out is row-major [rows, 8*nbytes] and packed [rows, nbytes], so the
    // flat output index j reads byte j/8 of the flat packed array
    for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         j < total; j += (int64_t)gridDim.x * blockDim.x)
        out[j] = (packed[j >> 3] >> (j & 7)) & 1;
}

}  // namespace

extern "C" {

// tbytes: 4 (int32 times) or 8 (int64 times)
int rtpu_apply_delta_chunk(int64_t n_pad, int64_t m_pad, int64_t cap_v,
                           int64_t cap_e, int64_t tbytes, void* v_lat,
                           void* v_alive, void* v_first, void* e_lat,
                           void* e_alive, void* e_first, const void* v_idx,
                           const void* vd_lat, const void* vd_alive,
                           const void* vd_first, const void* e_idx,
                           const void* ed_lat, const void* ed_alive,
                           const void* ed_first, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t b = blocks_for(cap_v + cap_e);
    auto u8 = [](void* p) { return static_cast<uint8_t*>(p); };
    auto cu8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
    auto ci32 = [](const void* p) { return static_cast<const int32_t*>(p); };
    if (tbytes == 4) {
        using T = int32_t;
        apply_delta_kernel<T><<<b, kThreads, 0, s>>>(
            n_pad, m_pad, cap_v, cap_e, static_cast<T*>(v_lat), u8(v_alive),
            static_cast<T*>(v_first), static_cast<T*>(e_lat), u8(e_alive),
            static_cast<T*>(e_first), ci32(v_idx),
            static_cast<const T*>(vd_lat), cu8(vd_alive),
            static_cast<const T*>(vd_first), ci32(e_idx),
            static_cast<const T*>(ed_lat), cu8(ed_alive),
            static_cast<const T*>(ed_first));
    } else if (tbytes == 8) {
        using T = int64_t;
        apply_delta_kernel<T><<<b, kThreads, 0, s>>>(
            n_pad, m_pad, cap_v, cap_e, static_cast<T*>(v_lat), u8(v_alive),
            static_cast<T*>(v_first), static_cast<T*>(e_lat), u8(e_alive),
            static_cast<T*>(e_first), ci32(v_idx),
            static_cast<const T*>(vd_lat), cu8(vd_alive),
            static_cast<const T*>(vd_first), ci32(e_idx),
            static_cast<const T*>(ed_lat), cu8(ed_alive),
            static_cast<const T*>(ed_first));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int rtpu_window_masks(int64_t k, int64_t n, int64_t m, int64_t tbytes,
                      const void* v_lat, const void* v_alive,
                      const void* e_lat, const void* e_alive, const void* lo,
                      const void* nowin, void* v_out, void* e_out,
                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t b = blocks_for(k * (n + m));
    auto cu8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
    auto u8 = [](void* p) { return static_cast<uint8_t*>(p); };
    if (tbytes == 4) {
        using T = int32_t;
        window_masks_kernel<T><<<b, kThreads, 0, s>>>(
            k, n, m, static_cast<const T*>(v_lat), cu8(v_alive),
            static_cast<const T*>(e_lat), cu8(e_alive),
            static_cast<const T*>(lo), cu8(nowin), u8(v_out), u8(e_out));
    } else if (tbytes == 8) {
        using T = int64_t;
        window_masks_kernel<T><<<b, kThreads, 0, s>>>(
            k, n, m, static_cast<const T*>(v_lat), cu8(v_alive),
            static_cast<const T*>(e_lat), cu8(e_alive),
            static_cast<const T*>(lo), cu8(nowin), u8(v_out), u8(e_out));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int rtpu_unpack_mask_bits(int64_t rows, int64_t nbytes, const void* packed,
                          void* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t total = rows * nbytes * 8;
    unpack_bits_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        total, static_cast<const uint8_t*>(packed),
        static_cast<uint8_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
