// K10 and K10-P — one round of the windowed feature aggregation.
//
// K10 `rtpu_feature_propagate` replaces the unbinned round of
// raphtory_tpu/engine/features.py:36 `_compiled_propagate` (`:79-95`,
// `:111-131`), a chunked lax.scan of row gathers and segment sums:
//
//     mask[e] = e_alive[e] && (nowin || e_lat[e] >= lo)
//     agg[r]  = sum over the in-edges e of r with mask[e] of H[src[e]]
//     deg[r]  = #{ those e }
//     H2[r]   = sw * H[r] + sw1 * (agg[r] * (1 / max(deg[r], 1)))
//     out[r]  = H2[r] / max(sqrt(sum_f H2[r,f]^2), 1e-12)
//
// H is stored as float32 or bfloat16 (`fdtype` 0 / 1); every sum, product
// and the norm are float32, the self term reads the STORED row, and the
// output rounds to the storage type with round-to-nearest-even
// (__float2bfloat16_rn). The reference's masked degree is computed once a
// call; here each round's walk counts it again (the same number).
//
// Layout: one warp per destination row over the destination CSR
// (`in_indptr`, whose runs are the real (dst, src)-sorted edges; the pad
// edges lie past in_indptr[n_pad]). The warp reads 32 edges' masks and
// sources at a time (one lane each), then walks the set bits in edge
// order, every lane adding its groups of 4 features of the source row —
// F = 128 is one group a lane, a 256-byte (bf16) or 512-byte (f32) row
// read by the whole warp in one go. The sums run in edge order with
// __fadd_rn, with no float atomics, so the result is deterministic; the
// norm is a fixed warp reduction. The rounds double-buffer H: each launch
// writes a new buffer.
//
// What bounds it on the H100: bytes. Per round the row gathers move
// F * sizeof(T) bytes a live edge (2^25 x 256 B = 8.6 GB at the Twitter
// scale shape in bf16, unless rows hit in the 50 MB L2), plus the edge
// tables and masks once and H read and written once (about 1.07 GB each
// at 4.2M x 128 bf16). The design keeps every read a full row segment and
// every edge's metadata a coalesced warp load.
//
// K10-P `rtpu_feature_propagate_binned` — the PCPM round (`:62-77`,
// `:99-110`): a first launch copies each distinct (partition, source)
// row H[u_src[u]] once into the bucket buffer `vals [U, F]` (storage type),
// a second walks each destination row's real slots through the layout's
// destination walk (`in_indptr`/`in_order`: slot s of edge perm[s], in
// source order) and adds vals[slot[s]], then the same epilogue. The walk
// visits a row's edges in the order K10 does, so the two results are equal
// bit for bit. Bound: bytes, as K10, plus the U bucket rows written and
// read.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/features.py).
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // destination rows a block
constexpr int kMaxGroups = 4;    // groups of 4 features a lane: F <= 512

template <typename T> struct Feat;
template <> struct Feat<float> {
    using Vec = float4;
    __device__ static void load(const float* p, float v[4]) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
    __device__ static void store(float* p, const float v[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Feat<__nv_bfloat16> {
    using Vec = uint2;
    __device__ static void load(const __nv_bfloat16* p, float v[4]) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&x.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&x.y));
        v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
    __device__ static void store(__nv_bfloat16* p, const float v[4]) {
        // __floats2bfloat162_rn: each lane __float2bfloat16_rn
        const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
        uint2 x;
        x.x = *reinterpret_cast<const unsigned*>(&a);
        x.y = *reinterpret_cast<const unsigned*>(&b);
        *reinterpret_cast<uint2*>(p) = x;
    }
};

// order == nullptr: the unbinned walk (edge j itself, source row
// e_src[j] of `rows` = H); else the binned one (slot order[j], edge
// perm[slot], bucket row slot_of[slot] of `rows` = vals).
template <typename T, typename TT>
__global__ void propagate_kernel(int64_t n_pad, int F, int64_t lo, int nowin,
                                 float sw, float sw1,
                                 const int64_t* __restrict__ indptr,
                                 const int32_t* __restrict__ order,
                                 const int32_t* __restrict__ perm,
                                 const int32_t* __restrict__ row_of,
                                 const TT* __restrict__ e_lat,
                                 const uint8_t* __restrict__ e_alive,
                                 const T* __restrict__ rows,
                                 const T* __restrict__ H,
                                 T* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int G = F >> 2;
    for (int64_t r = blockIdx.x * (int64_t)kWarps + (threadIdx.x >> 5);
         r < n_pad; r += (int64_t)gridDim.x * kWarps) {
        float acc[kMaxGroups][4];
#pragma unroll
        for (int q = 0; q < kMaxGroups; ++q)
            for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
        int deg = 0;
        const int64_t j0 = indptr[r], j1 = indptr[r + 1];
        for (int64_t b = j0; b < j1; b += 32) {
            const int64_t j = b + lane;
            bool mk = false;
            int src = 0;
            if (j < j1) {
                const int64_t s = order ? (int64_t)order[j] : j;
                const int64_t e = order ? (int64_t)perm[s] : j;
                mk = e_alive[e] && (nowin || (int64_t)e_lat[e] >= lo);
                src = row_of[s];
            }
            unsigned bits = __ballot_sync(0xffffffffu, mk);
            deg += __popc(bits);
            while (bits) {
                const int i = __ffs(bits) - 1;
                bits &= bits - 1;
                const T* row =
                    rows + (int64_t)__shfl_sync(0xffffffffu, src, i) * F;
#pragma unroll
                for (int q = 0; q < kMaxGroups; ++q) {
                    const int g = lane + 32 * q;
                    if (g < G) {
                        float v[4];
                        Feat<T>::load(row + 4 * g, v);
                        for (int c = 0; c < 4; ++c)
                            acc[q][c] = __fadd_rn(acc[q][c], v[c]);
                    }
                }
            }
        }
        // mean, mix with the stored row, L2-normalise
        const float inv = __fdiv_rn(1.0f, fmaxf((float)deg, 1.0f));
        const T* self = H + r * F;
        float ss = 0.0f;
#pragma unroll
        for (int q = 0; q < kMaxGroups; ++q) {
            const int g = lane + 32 * q;
            if (g < G) {
                float h[4];
                Feat<T>::load(self + 4 * g, h);
                for (int c = 0; c < 4; ++c) {
                    const float x = __fadd_rn(
                        __fmul_rn(sw, h[c]),
                        __fmul_rn(sw1, __fmul_rn(acc[q][c], inv)));
                    acc[q][c] = x;
                    ss = __fadd_rn(ss, __fmul_rn(x, x));
                }
            }
        }
        for (int o = 16; o > 0; o >>= 1)
            ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
        const float nrm = fmaxf(__fsqrt_rn(ss), 1e-12f);
#pragma unroll
        for (int q = 0; q < kMaxGroups; ++q) {
            const int g = lane + 32 * q;
            if (g < G) {
                float y[4];
                for (int c = 0; c < 4; ++c) y[c] = __fdiv_rn(acc[q][c], nrm);
                Feat<T>::store(out + r * F + 4 * g, y);
            }
        }
    }
}

// vals[u, :] = H[u_src[u], :] — one thread a group of 4 features.
template <typename T>
__global__ void bucket_fill_kernel(int64_t U, int F,
                                   const int32_t* __restrict__ u_src,
                                   const T* __restrict__ H,
                                   T* __restrict__ vals) {
    using Vec = typename Feat<T>::Vec;
    const int G = F >> 2;
    const int64_t total = U * G;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t u = t / G, g = t % G;
        *reinterpret_cast<Vec*>(vals + u * F + 4 * g) =
            *reinterpret_cast<const Vec*>(H + (int64_t)u_src[u] * F + 4 * g);
    }
}

int64_t row_blocks(int64_t n) {
    int64_t blocks = (n + kWarps - 1) / kWarps;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    return blocks < 1 ? 1 : blocks;
}

template <typename T, typename TT>
void launch(int64_t n_pad, int F, int64_t lo, int nowin, float sw, float sw1,
            const int64_t* indptr, const int32_t* order, const int32_t* perm,
            const int32_t* row_of, const void* e_lat, const uint8_t* e_alive,
            const void* rows, const void* H, void* out, cudaStream_t s) {
    propagate_kernel<T, TT><<<row_blocks(n_pad), kWarps * 32, 0, s>>>(
        n_pad, F, lo, nowin, sw, sw1, indptr, order, perm, row_of,
        static_cast<const TT*>(e_lat), e_alive, static_cast<const T*>(rows),
        static_cast<const T*>(H), static_cast<T*>(out));
}

template <typename T>
void launch_t(int64_t tbytes, int64_t n_pad, int F, int64_t lo, int nowin,
              float sw, float sw1, const int64_t* indptr,
              const int32_t* order, const int32_t* perm,
              const int32_t* row_of, const void* e_lat,
              const uint8_t* e_alive, const void* rows, const void* H,
              void* out, cudaStream_t s) {
    if (tbytes == 4)
        launch<T, int32_t>(n_pad, F, lo, nowin, sw, sw1, indptr, order, perm,
                           row_of, e_lat, e_alive, rows, H, out, s);
    else
        launch<T, int64_t>(n_pad, F, lo, nowin, sw, sw1, indptr, order, perm,
                           row_of, e_lat, e_alive, rows, H, out, s);
}

bool bad_args(int64_t F, int64_t fdtype, int64_t tbytes) {
    return F <= 0 || F % 4 || F > 4 * 32 * kMaxGroups || fdtype < 0
        || fdtype > 1 || (tbytes != 4 && tbytes != 8);
}

}  // namespace

extern "C" {

// K10. n_pad rows, F features (a multiple of 4, at most 512), fdtype 0
// float32 / 1 bfloat16, tbytes 4 / 8 (e_lat's type), lo, nowin | sw,
// 1 - sw | in_indptr [n_pad+1] int64, e_src [m_pad] int32, e_lat, e_alive
// [m_pad] | H [n_pad, F] | out [n_pad, F].
int rtpu_feature_propagate(int64_t n_pad, int64_t F, int64_t fdtype,
                           int64_t tbytes, int64_t lo, int64_t nowin,
                           float sw, float sw1, const void* in_indptr,
                           const void* e_src, const void* e_lat,
                           const void* e_alive, const void* H, void* out,
                           void* stream) {
    if (n_pad == 0) return (int)cudaGetLastError();
    if (bad_args(F, fdtype, tbytes)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t* ip = static_cast<const int64_t*>(in_indptr);
    const int32_t* src = static_cast<const int32_t*>(e_src);
    const uint8_t* al = static_cast<const uint8_t*>(e_alive);
    if (fdtype == 0)
        launch_t<float>(tbytes, n_pad, (int)F, lo, (int)nowin, sw, sw1, ip,
                        nullptr, nullptr, src, e_lat, al, H, H, out, s);
    else
        launch_t<__nv_bfloat16>(tbytes, n_pad, (int)F, lo, (int)nowin, sw,
                                sw1, ip, nullptr, nullptr, src, e_lat, al, H,
                                H, out, s);
    return (int)cudaGetLastError();
}

// K10-P. As K10, plus U buckets | in_indptr [n_pad+1] int64 and in_order
// int32 (the layout's destination walk, real slots only), perm [B] int32,
// slot [B] int32, u_src [U] int32, vals [U, F] scratch | out; reports the
// kernels it launched (2).
int rtpu_feature_propagate_binned(int64_t n_pad, int64_t F, int64_t U,
                                  int64_t fdtype, int64_t tbytes, int64_t lo,
                                  int64_t nowin, float sw, float sw1,
                                  const void* in_indptr, const void* in_order,
                                  const void* perm, const void* slot,
                                  const void* u_src, const void* e_lat,
                                  const void* e_alive, const void* H,
                                  void* vals, void* out, void* stream,
                                  int64_t* launched) {
    *launched = 0;
    if (n_pad == 0) return (int)cudaGetLastError();
    if (bad_args(F, fdtype, tbytes) || U <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t* ip = static_cast<const int64_t*>(in_indptr);
    const int32_t* od = static_cast<const int32_t*>(in_order);
    const int32_t* pm = static_cast<const int32_t*>(perm);
    const int32_t* sl = static_cast<const int32_t*>(slot);
    const int32_t* us = static_cast<const int32_t*>(u_src);
    const uint8_t* al = static_cast<const uint8_t*>(e_alive);
    int64_t blocks = (U * (F / 4) + 255) / 256;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    if (fdtype == 0)
        bucket_fill_kernel<float><<<blocks, 256, 0, s>>>(
            U, (int)F, us, static_cast<const float*>(H),
            static_cast<float*>(vals));
    else
        bucket_fill_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
            U, (int)F, us, static_cast<const __nv_bfloat16*>(H),
            static_cast<__nv_bfloat16*>(vals));
    int err = (int)cudaGetLastError();
    if (err) return err;
    *launched = 1;
    if (fdtype == 0)
        launch_t<float>(tbytes, n_pad, (int)F, lo, (int)nowin, sw, sw1, ip,
                        od, pm, sl, e_lat, al, vals, H, out, s);
    else
        launch_t<__nv_bfloat16>(tbytes, n_pad, (int)F, lo, (int)nowin, sw,
                                sw1, ip, od, pm, sl, e_lat, al, vals, H, out,
                                s);
    err = (int)cudaGetLastError();
    if (!err) *launched = 2;
    return err;
}

}  // extern "C"
