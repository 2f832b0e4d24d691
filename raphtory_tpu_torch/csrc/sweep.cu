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
// never race.
//   The chunk arrives as ONE byte buffer (one upload a chunk from pinned
// host memory, raphtory_tpu_torch/ops/resident.py `pack_chunk`): the eight
// arrays v_idx (int32), v_lat (T), v_alive (u8), v_first (T), e_idx, e_lat,
// e_alive, e_first, each capacity long, in that order, each starting at a
// multiple of 16 bytes (`chunk_offset` below; the wrapper's
// `chunk_offsets` is the same rule). A thread takes 4 consecutive rows of
// one side: its indices, times and alive flags in one 16-byte (int32) or
// two (int64) loads a field, neighbouring threads on neighbouring rows;
// the vertex rows take the first blocks, the edge rows the rest.
//
// K9b `rtpu_window_masks` replaces the mask half of device_sweep.py:261
// `_compiled_run` (:273-277):
//     mask[w, i] = alive[i] & (nowin[w] | lat[i] >= lo[w])
// for the vertices and the edges in one launch, over the resident times in
// their narrow dtype (int32 or int64); lo[w] = clamp(T - win[w]) into that
// dtype's range is computed by the wrapper (a clamped lo only widens the
// window past every real time) and arrives BY VALUE: the C entry copies up
// to 32 windows' bounds (lo, and nowin as a bit mask) into a kernel
// parameter, so no bound lives in device memory and the host makes no
// copy; a call with more windows launches once a group of 32, over the same
// state. A thread takes 16 consecutive elements of the vertices or of the
// edges (separate block ranges, no division), loads their times and alive
// flags once (16-byte loads), and writes each window's 16 mask bytes as
// one 16-byte store (byte stores where a row is not 16-byte aligned or at
// the ragged end).
//
// K8u `rtpu_unpack_view_masks` replaces raphtory_tpu/engine/bsp.py:39
// `_unpack_bits` as the cold route calls it (`:377-378`): a View's vertex
// masks [k, n] and edge masks [k, m], bit-packed on the host in little bit
// order, arrive as ONE byte buffer (one non-blocking copy from pinned
// memory, raphtory_tpu_torch/ops/resident.py `pack_view_masks`): the k*n
// vertex bits flat from byte 0, the k*m edge bits flat from the next
// multiple of 16 bytes (`view_offsets` below; the wrapper's
// `view_mask_layout` is the same rule). One launch unpacks both into one
// bool allocation, the edge rows at the next multiple of 16 bytes past the
// k*n vertex bytes. The vertex region takes the first blocks, the edge
// region the rest (no division). A block takes 4,096 bytes of bits, one
// 16-byte load a thread, staged in shared memory; a warp then writes its
// 512 bytes' 4,096 mask bytes as eight 16-byte stores a lane, store q of
// lane L covering bits bytes 2(32q + L) and 2(32q + L) + 1, so that each
// store instruction of the warp writes 512 contiguous bytes. A byte's 8
// bits become 8 mask bytes by one 64-bit multiply and masks (`spread`).
// Ragged ends (a region under 16 bytes of bits, the tail of a region) take
// byte loads and byte stores.
//
// What bounds them on the H100: bytes (one compare or shift per element).
// K9a and K9b move well under a megabyte on the resident paths and are
// launch-bound there: their designs cut the host's part of a call (one
// upload and no synchronizing copy a call). K8u writes 8 bytes for each
// byte it reads (31.5 MB from 3.9 MB for the taint View): its stores set
// its pace, hence whole coalesced 16-byte stores.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/
// resident.py). Each entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWinGroup = 32;          // windows a K9b launch carries
constexpr int kSpan = 16;              // elements a K9b thread takes
constexpr int kRows = 4;               // chunk rows a K9a thread takes

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------- K9a

// byte offset of field f (0..7) of a packed chunk; f == 8: its size
__host__ __device__ inline int64_t chunk_offset(int f, int64_t cap_v,
                                               int64_t cap_e, int64_t tb) {
    const int64_t width[4] = {4, tb, 1, tb};
    int64_t off = 0;
    for (int i = 0; i < f; ++i)
        off += ((i < 4 ? cap_v : cap_e) * width[i % 4] + 15) / 16 * 16;
    return off;
}

// kRows consecutive T values from p (16-byte aligned where whole), or the
// first `cnt` of them
template <typename T>
__device__ __forceinline__ void load_rows(const T* p, int cnt, T (&v)[kRows]) {
    if (cnt == kRows) {
        if constexpr (sizeof(T) == 4) {
            const int4 a = *reinterpret_cast<const int4*>(p);
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        } else {
            const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
            const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
            v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
        }
    } else {
        for (int q = 0; q < kRows; ++q) v[q] = q < cnt ? p[q] : T(0);
    }
}

// one side of the chunk (vertices or edges): rows [q0, q0 + kRows) of cap
template <typename T>
__device__ __forceinline__ void apply_rows(int64_t q0, int64_t cap,
                                           int64_t len, const uint8_t* base,
                                           int64_t o_idx, int64_t o_lat,
                                           int64_t o_alive, int64_t o_first,
                                           T* lat, uint8_t* alive, T* first) {
    const int cnt = cap - q0 < kRows ? (int)(cap - q0) : kRows;
    int32_t idx[kRows];
    T lt[kRows], ft[kRows];
    load_rows<int32_t>(reinterpret_cast<const int32_t*>(base + o_idx) + q0,
                       cnt, idx);
    load_rows<T>(reinterpret_cast<const T*>(base + o_lat) + q0, cnt, lt);
    load_rows<T>(reinterpret_cast<const T*>(base + o_first) + q0, cnt, ft);
    const uint8_t* al = base + o_alive + q0;
    uint32_t a = 0;
    if (cnt == kRows)
        a = *reinterpret_cast<const uint32_t*>(al);     // q0 % 4 == 0
    else
        for (int q = 0; q < cnt; ++q) a |= (uint32_t)al[q] << (8 * q);
    for (int q = 0; q < cnt; ++q) {
        const int64_t p = idx[q];
        if (p < 0 || p >= len) continue;                // pad row
        lat[p] = lt[q];
        alive[p] = (uint8_t)(a >> (8 * q));
        first[p] = ft[q];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) apply_delta_kernel(
        int64_t n_pad, int64_t m_pad, int64_t cap_v, int64_t cap_e,
        int64_t vblocks, T* __restrict__ v_lat, uint8_t* __restrict__ v_alive,
        T* __restrict__ v_first, T* __restrict__ e_lat,
        uint8_t* __restrict__ e_alive, T* __restrict__ e_first,
        const uint8_t* __restrict__ packed) {
    constexpr int64_t tb = sizeof(T);
    if (blockIdx.x < vblocks) {                         // block-uniform
        const int64_t q0 =
            ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kRows;
        if (q0 < cap_v)
            apply_rows<T>(q0, cap_v, n_pad, packed,
                          chunk_offset(0, cap_v, cap_e, tb),
                          chunk_offset(1, cap_v, cap_e, tb),
                          chunk_offset(2, cap_v, cap_e, tb),
                          chunk_offset(3, cap_v, cap_e, tb),
                          v_lat, v_alive, v_first);
        return;
    }
    const int64_t q0 =
        ((int64_t)(blockIdx.x - vblocks) * kThreads + threadIdx.x) * kRows;
    if (q0 < cap_e)
        apply_rows<T>(q0, cap_e, m_pad, packed,
                      chunk_offset(4, cap_v, cap_e, tb),
                      chunk_offset(5, cap_v, cap_e, tb),
                      chunk_offset(6, cap_v, cap_e, tb),
                      chunk_offset(7, cap_v, cap_e, tb),
                      e_lat, e_alive, e_first);
}

// ---------------------------------------------------------------- K9b

// one launch's windows, by value: lo[w] (in the times' dtype's range) and
// bit w of nowin set where window w is unbounded
struct WinBounds {
    int64_t lo[kWinGroup];
    uint32_t nowin;
    int32_t kw;
};

// elements [i0, i0 + kSpan) of one side: lat / alive in, kw mask rows out
// (row w at out + w * len)
template <typename T>
__device__ __forceinline__ void mask_span(int64_t i0, int64_t len,
                                          const T* __restrict__ lat,
                                          const uint8_t* __restrict__ alive,
                                          uint8_t* __restrict__ out,
                                          const WinBounds& b) {
    const int cnt = len - i0 < kSpan ? (int)(len - i0) : kSpan;
    T l[kSpan];
    union { uint4 v; uint8_t c[kSpan]; } al;
    const bool whole = cnt == kSpan && aligned16(lat + i0)
                       && aligned16(alive + i0);
    if (whole) {
        if constexpr (sizeof(T) == 4) {
            #pragma unroll
            for (int q = 0; q < kSpan / 4; ++q) {
                const int4 v = reinterpret_cast<const int4*>(lat + i0)[q];
                l[4 * q] = v.x; l[4 * q + 1] = v.y;
                l[4 * q + 2] = v.z; l[4 * q + 3] = v.w;
            }
        } else {
            #pragma unroll
            for (int q = 0; q < kSpan / 2; ++q) {
                const longlong2 v =
                    reinterpret_cast<const longlong2*>(lat + i0)[q];
                l[2 * q] = v.x; l[2 * q + 1] = v.y;
            }
        }
        al.v = *reinterpret_cast<const uint4*>(alive + i0);
    } else {
        #pragma unroll
        for (int q = 0; q < kSpan; ++q) {
            l[q] = q < cnt ? lat[i0 + q] : T(0);
            al.c[q] = q < cnt ? alive[i0 + q] : 0;
        }
    }
    for (int w = 0; w < b.kw; ++w) {
        union { uint4 v; uint8_t c[kSpan]; } o;
        if ((b.nowin >> w) & 1u) {
            #pragma unroll
            for (int q = 0; q < kSpan; ++q) o.c[q] = al.c[q] != 0;
        } else {
            const T lo = (T)b.lo[w];
            #pragma unroll
            for (int q = 0; q < kSpan; ++q)
                o.c[q] = (al.c[q] != 0) & (l[q] >= lo);
        }
        uint8_t* dst = out + w * len + i0;
        if (cnt == kSpan && aligned16(dst)) {
            *reinterpret_cast<uint4*>(dst) = o.v;
        } else {
            for (int q = 0; q < cnt; ++q) dst[q] = o.c[q];
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) window_masks_kernel(
        int64_t n, int64_t m, int64_t vblocks, const T* __restrict__ v_lat,
        const uint8_t* __restrict__ v_alive, const T* __restrict__ e_lat,
        const uint8_t* __restrict__ e_alive, uint8_t* __restrict__ v_out,
        uint8_t* __restrict__ e_out, const __grid_constant__ WinBounds b) {
    if (blockIdx.x < vblocks) {                         // block-uniform
        const int64_t i0 =
            ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kSpan;
        if (i0 < n) mask_span<T>(i0, n, v_lat, v_alive, v_out, b);
        return;
    }
    const int64_t i0 =
        ((int64_t)(blockIdx.x - vblocks) * kThreads + threadIdx.x) * kSpan;
    if (i0 < m) mask_span<T>(i0, m, e_lat, e_alive, e_out, b);
}

// ---------------------------------------------------------------- K8u

constexpr int kBitsBlock = kThreads * 16;   // bytes of bits a block takes

__host__ __device__ inline int64_t align16(int64_t n) {
    return (n + 15) / 16 * 16;
}

// (byte offset of the edge bits in the packed buffer, byte offset of the
// edge masks in the output) of a View with vbits vertex and ebits edge
// bits
__host__ __device__ inline void view_offsets(int64_t vbits, int64_t& e_in,
                                             int64_t& e_out) {
    e_in = align16((vbits + 7) / 8);
    e_out = align16(vbits);
}

// the 8 bits of b as 8 bytes of 0 / 1, bit j in byte j: b copied into every
// byte, byte j keeps bit j, then each non-zero byte becomes 1
__host__ __device__ __forceinline__ uint64_t spread(uint32_t b) {
    const uint64_t x = ((uint64_t)b * 0x0101010101010101ull)
                       & 0x8040201008040201ull;
    return ((x + 0x7f7f7f7f7f7f7f7full) & 0x8080808080808080ull) >> 7;
}

__global__ void __launch_bounds__(kThreads) unpack_view_kernel(
        int64_t vbits, int64_t ebits, int64_t vblocks,
        const uint8_t* __restrict__ packed, uint8_t* __restrict__ out) {
    __shared__ uint4 stage[kThreads];
    const bool vert = blockIdx.x < vblocks;                 // block-uniform
    int64_t e_in, e_out;
    view_offsets(vbits, e_in, e_out);
    const int64_t bits = vert ? vbits : ebits;
    const int64_t nbytes = (bits + 7) / 8;
    const uint8_t* in = packed + (vert ? 0 : e_in);
    uint8_t* o = out + (vert ? 0 : e_out);
    const int64_t b0 =
        (int64_t)(vert ? blockIdx.x : blockIdx.x - vblocks) * kBitsBlock;
    // one 16-byte load a thread, neighbouring threads on neighbouring words
    const int64_t i0 = b0 + (int64_t)threadIdx.x * 16;
    union { uint4 v; uint8_t c[16]; } w;
    if (i0 + 16 <= nbytes) {
        w.v = *reinterpret_cast<const uint4*>(in + i0);
    } else {
        #pragma unroll
        for (int q = 0; q < 16; ++q)
            w.c[q] = i0 + q < nbytes ? in[i0 + q] : 0;
    }
    stage[threadIdx.x] = w.v;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(stage)
                        + (threadIdx.x >> 5) * 512;
    // the warp's first byte of bits
    const int64_t wbyte = b0 + (threadIdx.x >> 5) * 512;
    #pragma unroll
    for (int q = 0; q < 8; ++q) {
        const int h = q * 32 + lane;        // the warp's half-word h
        const int64_t j0 = (wbyte + 2 * h) * 8;
        if (j0 >= bits) break;
        const uint64_t lo = spread(wb[2 * h]);
        const uint64_t hi = spread(wb[2 * h + 1]);
        if (j0 + 16 <= bits) {
            *reinterpret_cast<uint4*>(o + j0) = make_uint4(
                (uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                (uint32_t)(hi >> 32));
        } else {
            for (int t = 0; j0 + t < bits; ++t)
                o[j0 + t] = (uint8_t)((t < 8 ? lo >> (8 * t)
                                             : hi >> (8 * (t - 8))) & 1);
        }
    }
}

}  // namespace

extern "C" {

// K9a. tbytes: 4 (int32 times) or 8 (int64 times) | the six resident
// buffers, packed: the chunk's bytes (chunk_offset(8, ...) of them, on the
// card).
int rtpu_apply_delta_chunk(int64_t n_pad, int64_t m_pad, int64_t cap_v,
                           int64_t cap_e, int64_t tbytes, void* v_lat,
                           void* v_alive, void* v_first, void* e_lat,
                           void* e_alive, void* e_first, const void* packed,
                           void* stream) {
    if (cap_v < 0 || cap_e < 0) return (int)cudaErrorInvalidValue;
    if (cap_v + cap_e == 0) return (int)cudaGetLastError();
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t vb = ceil_div(cap_v, (int64_t)kThreads * kRows);
    const int64_t eb = ceil_div(cap_e, (int64_t)kThreads * kRows);
    const auto* pk = static_cast<const uint8_t*>(packed);
    auto u8 = [](void* p) { return static_cast<uint8_t*>(p); };
    if (tbytes == 4) {
        using T = int32_t;
        apply_delta_kernel<T><<<vb + eb, kThreads, 0, s>>>(
            n_pad, m_pad, cap_v, cap_e, vb, static_cast<T*>(v_lat),
            u8(v_alive), static_cast<T*>(v_first), static_cast<T*>(e_lat),
            u8(e_alive), static_cast<T*>(e_first), pk);
    } else if (tbytes == 8) {
        using T = int64_t;
        apply_delta_kernel<T><<<vb + eb, kThreads, 0, s>>>(
            n_pad, m_pad, cap_v, cap_e, vb, static_cast<T*>(v_lat),
            u8(v_alive), static_cast<T*>(v_first), static_cast<T*>(e_lat),
            u8(e_alive), static_cast<T*>(e_first), pk);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// K9b. k windows, n vertices, m edges, tbytes 4 or 8 | v_lat [n], v_alive
// [n], e_lat [m], e_alive [m] on the card; bounds: a HOST array of 2k int64,
// lo[0..k) (each inside the times' dtype's range) then nowin[0..k) (0 or
// 1); v_out [k, n] and e_out [k, m] on the card | launched: one launch a
// group of 32 windows.
int rtpu_window_masks(int64_t k, int64_t n, int64_t m, int64_t tbytes,
                      const void* v_lat, const void* v_alive,
                      const void* e_lat, const void* e_alive,
                      const int64_t* bounds, void* v_out, void* e_out,
                      void* stream, int64_t* launched) {
    *launched = 0;
    if (tbytes != 4 && tbytes != 8) return (int)cudaErrorInvalidValue;
    if (k <= 0 || n + m == 0) return (int)cudaGetLastError();
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t vb = ceil_div(ceil_div(n, kSpan), kThreads);
    const int64_t eb = ceil_div(ceil_div(m, kSpan), kThreads);
    for (int64_t w0 = 0; w0 < k; w0 += kWinGroup) {
        WinBounds b{};
        b.kw = (int32_t)(k - w0 < kWinGroup ? k - w0 : kWinGroup);
        for (int w = 0; w < b.kw; ++w) {
            b.lo[w] = bounds[w0 + w];
            if (bounds[k + w0 + w]) b.nowin |= 1u << w;
        }
        uint8_t* vo = static_cast<uint8_t*>(v_out) + w0 * n;
        uint8_t* eo = static_cast<uint8_t*>(e_out) + w0 * m;
        if (tbytes == 4)
            window_masks_kernel<int32_t><<<vb + eb, kThreads, 0, s>>>(
                n, m, vb, static_cast<const int32_t*>(v_lat),
                static_cast<const uint8_t*>(v_alive),
                static_cast<const int32_t*>(e_lat),
                static_cast<const uint8_t*>(e_alive), vo, eo, b);
        else
            window_masks_kernel<int64_t><<<vb + eb, kThreads, 0, s>>>(
                n, m, vb, static_cast<const int64_t*>(v_lat),
                static_cast<const uint8_t*>(v_alive),
                static_cast<const int64_t*>(e_lat),
                static_cast<const uint8_t*>(e_alive), vo, eo, b);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        ++*launched;
    }
    return (int)cudaSuccess;
}

// K8u. vbits = k*n vertex and ebits = k*m edge mask bits | packed: the
// View's bits (view_offsets), 16-byte aligned, on the card; out: bool, the
// vertex masks from byte 0 and the edge masks from view_offsets' e_out,
// 16-byte aligned, on the card. One launch.
int rtpu_unpack_view_masks(int64_t vbits, int64_t ebits, const void* packed,
                           void* out, void* stream) {
    if (vbits < 0 || ebits < 0) return (int)cudaErrorInvalidValue;
    const int64_t vb = ceil_div(ceil_div(vbits, 8), kBitsBlock);
    const int64_t eb = ceil_div(ceil_div(ebits, 8), kBitsBlock);
    if (vb + eb == 0) return (int)cudaGetLastError();
    if (vb + eb > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    unpack_view_kernel<<<vb + eb, kThreads, 0, s>>>(
        vbits, ebits, vb, static_cast<const uint8_t*>(packed),
        static_cast<uint8_t*>(out));
    return (int)cudaGetLastError();
}

}  // extern "C"
