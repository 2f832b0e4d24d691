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
// K10-P `rtpu_feature_propagate_binned` — the PCPM round (`:62-77`,
// `:99-110`). The TPU kernel gathers each distinct (partition, source) row
// once into a VMEM bucket and reduces from there; on this card the copy
// buys nothing (a 0.4 % dedup at the Twitter scale shape, for U bucket
// rows written and read again), and the 50 MB L2 does what dedup there is.
// So K10-P walks each destination row's real slots through the layout's
// destination walk (slot s = in_order[j], in source order) and reads the
// source row straight from H: the walk arrives as `walk [m]`, one (source
// row, edge) int32 pair a slot — u_src[slot[s]] and perm[s], derived once
// per layout on the device (ops/features.py `binned_walk`) — and the mask
// is read at the pair's edge (the kernel does not assume perm[in_order[j]]
// == j). The walk visits a row's edges in the order K10 does, so the two
// results are equal bit for bit.
//
// One kernel, `ring_kernel`, for both: a template over where walk entry j
// comes from. K10 (`EdgeWalk`): entry j of the destination CSR
// (`in_indptr`, whose runs are the real (dst, src)-sorted edges; the pad
// edges lie past in_indptr[n_pad]) is edge j itself, source row e_src[j] —
// one coalesced 4-byte load an entry and the mask read at j, beside it.
// K10-P (`PairWalk`): the 8-byte pair, the mask read through it.
//   One warp per destination row. It reads 32 entries at a time (a lane
// each) and ballots their masks; every lane then adds its groups of 4
// features of each set entry's source row — F = 128 is one group a lane, a
// 256-byte (bf16) or 512-byte (f32) row read by the whole warp in one go.
// Several rows in flight: a ballot with more than D set entries (D = 8 at
// F <= 128, fewer for wider rows) goes through a per-warp ring of D rows in
// shared memory, filled with cp.async — D issued ahead, then one issued
// into each slot as its row is added, so D stay in flight; each lane
// copies and later adds only its own feature groups, so the ring needs no
// barrier. A ballot with at most D set entries (the short rows of a GAB or
// LDBC graph, and every row's tail) issues all its rows as ONE commit group
// and waits for it once, instead of the ring's D groups a ballot, which
// K10-P paid on every ballot before (it lost to the old K10 at GAB: 0.0451
// / 0.0405 against 0.0338 / 0.0305 ms). (Loading a short ballot's rows
// into registers instead was slower at the `features` shape and no faster
// at GAB: more registers a thread, fewer warps in flight.) Rows are added
// in entry order with __fadd_rn, with no float atomics, so the result is
// deterministic and the same on both routes; the degree is the ballots'
// count; the epilogue (`finish_row`) reads the stored row loaded before the
// walk, and the norm is a fixed warp reduction. The rounds double-buffer
// H: each launch writes a new buffer. (A batch of D rows loaded into
// registers and drained before the next, for every ballot, is slower than
// the ring: 3.04 / 4.39 ms a round at the day / month window of the
// `features` shape against 1.64 / 3.17.)
//
// What bounds it on the H100: bytes. Per round the row gathers move
// F * sizeof(T) bytes a live edge (26.9M live edges x 256 B = 6.9 GB at the
// month window of the Twitter scale shape in bf16, unless rows hit in the
// 50 MB L2), plus the walk (4 bytes an entry for K10, 8 for K10-P), the
// edge times and alive flags, and H read and written once (about 1.07 GB
// each at 4.2M x 128 bf16). The design keeps every read a full row segment
// and every entry's metadata a coalesced warp load.
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
    __device__ static Vec raw(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
    __device__ static void widen(const Vec x, float v[4]) {
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
    __device__ static void store(float* p, const float v[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Feat<__nv_bfloat16> {
    using Vec = uint2;
    __device__ static Vec raw(const __nv_bfloat16* p) {
        return *reinterpret_cast<const uint2*>(p);
    }
    __device__ static void widen(const Vec x, float v[4]) {
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

// mean, mix with the stored row `self` (the lane's groups), L2-normalise,
// round to the storage type: the epilogue of K10 and K10-P
template <typename T, int NG>
__device__ __forceinline__ void finish_row(
        float (&acc)[NG][4], const typename Feat<T>::Vec (&self)[NG],
        int deg, int G, int lane, float sw, float sw1, T* __restrict__ row) {
    const float inv = __fdiv_rn(1.0f, fmaxf((float)deg, 1.0f));
    float ss = 0.0f;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
        if (lane + 32 * q < G) {
            float h[4];
            Feat<T>::widen(self[q], h);
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
    for (int q = 0; q < NG; ++q) {
        const int g = lane + 32 * q;
        if (g < G) {
            float y[4];
            for (int c = 0; c < 4; ++c) y[c] = __fdiv_rn(acc[q][c], nrm);
            Feat<T>::store(row + 4 * g, y);
        }
    }
}

template <typename T, int NG>
__device__ __forceinline__ void add_row(float (&acc)[NG][4],
                                        const typename Feat<T>::Vec (&v)[NG],
                                        int G, int lane) {
#pragma unroll
    for (int q = 0; q < NG; ++q) {
        if (lane + 32 * q < G) {
            float x[4];
            Feat<T>::widen(v[q], x);
            for (int c = 0; c < 4; ++c) acc[q][c] = __fadd_rn(acc[q][c], x[c]);
        }
    }
}

// ------------------------------------------------------- the ring walk

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(gmem) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"(s), "l"(gmem), "n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows in flight a warp: 8 at F <= 128, fewer for wider rows
template <int NG> struct Depth {
    static constexpr int D = NG == 1 ? 8 : NG == 2 ? 4 : 2;
};

// the window's mask of edge e
template <typename TT>
struct Window {
    const TT* __restrict__ e_lat;
    const uint8_t* __restrict__ e_alive;
    int64_t lo;
    int nowin;
    __device__ __forceinline__ bool live(int64_t e) const {
        return e_alive[e] && (nowin || (int64_t)e_lat[e] >= lo);
    }
};

// K10's walk: entry j of the destination CSR is edge j, its source row
// e_src[j] — one coalesced 4-byte load, the mask read at j
struct EdgeWalk {
    const int32_t* __restrict__ e_src;
    template <typename W>
    __device__ __forceinline__ bool entry(int64_t j, const W& w,
                                          int& src) const {
        src = e_src[j];
        return w.live(j);
    }
};

// K10-P's walk: entry j's (source row, edge) pair, the mask read at the
// pair's edge
struct PairWalk {
    const int2* __restrict__ pairs;
    template <typename W>
    __device__ __forceinline__ bool entry(int64_t j, const W& w,
                                          int& src) const {
        const int2 p = pairs[j];
        src = p.x;
        return w.live(p.y);
    }
};

// the next set slot of `bits` (warp-uniform): its source row
template <typename T>
__device__ __forceinline__ const T* next_row(unsigned& bits, int src,
                                             const T* H, int F) {
    const int i = __ffs(bits) - 1;
    bits &= bits - 1;
    return H + (int64_t)__shfl_sync(0xffffffffu, src, i) * F;
}

template <typename T, typename TT, int NG, typename Walk>
__global__ void __launch_bounds__(kWarps * 32) ring_kernel(
        int64_t n_pad, int F, float sw, float sw1,
        const int64_t* __restrict__ indptr, const Walk walk,
        const Window<TT> win, const T* __restrict__ H,
        T* __restrict__ out) {
    using Vec = typename Feat<T>::Vec;
    constexpr int D = Depth<NG>::D;
    // a ring of D rows a warp; a lane's own words at
    // [(slot * NG + q) * 32 + lane], so a lane only ever reads what it copied
    extern __shared__ __align__(16) unsigned char ring_bytes[];
    Vec* ring = reinterpret_cast<Vec*>(ring_bytes)
        + (threadIdx.x >> 5) * (D * NG * 32);
    const int lane = threadIdx.x & 31;
    const int G = F >> 2;
    for (int64_t r = blockIdx.x * (int64_t)kWarps + (threadIdx.x >> 5);
         r < n_pad; r += (int64_t)gridDim.x * kWarps) {
        Vec self[NG];
#pragma unroll
        for (int q = 0; q < NG; ++q)
            if (lane + 32 * q < G)
                self[q] = Feat<T>::raw(H + r * F + 4 * (lane + 32 * q));
        float acc[NG][4];
#pragma unroll
        for (int q = 0; q < NG; ++q)
            for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
        int deg = 0;
        const int64_t j0 = indptr[r], j1 = indptr[r + 1];
        for (int64_t b = j0; b < j1; b += 32) {
            const int64_t j = b + lane;
            bool mk = false;
            int src = 0;
            if (j < j1) mk = walk.entry(j, win, src);
            unsigned bits = __ballot_sync(0xffffffffu, mk);
            const int n = __popc(bits);
            deg += n;
            if (n == 0) continue;
            if (n <= D) {
                // a short ballot: all its rows issued into the ring as one
                // commit group and waited for at once (one gather latency),
                // then added in order
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    if (d < n) {
                        const T* row = next_row(bits, src, H, F);
#pragma unroll
                        for (int q = 0; q < NG; ++q)
                            if (lane + 32 * q < G)
                                cp_async<sizeof(Vec)>(
                                    ring + (d * NG + q) * 32 + lane,
                                    row + 4 * (lane + 32 * q));
                    }
                }
                cp_async_commit();
                cp_async_wait<0>();
                for (int k = 0; k < n; ++k) {
                    const Vec* slot = ring + k * NG * 32 + lane;
                    Vec v[NG];
#pragma unroll
                    for (int q = 0; q < NG; ++q) v[q] = slot[q * 32];
                    add_row<T, NG>(acc, v, G, lane);
                }
                continue;
            }
            // a long ballot: issue D rows ahead, then add the oldest and
            // issue the next into its slot; a commit every step keeps the
            // count of groups in flight at D (the empty ones complete at
            // once)
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const T* row = next_row(bits, src, H, F);
#pragma unroll
                for (int q = 0; q < NG; ++q)
                    if (lane + 32 * q < G)
                        cp_async<sizeof(Vec)>(
                            ring + (d * NG + q) * 32 + lane,
                            row + 4 * (lane + 32 * q));
                cp_async_commit();
            }
            for (int k = 0; k < n; ++k) {
                cp_async_wait<D - 1>();
                Vec* slot = ring + (k & (D - 1)) * NG * 32 + lane;
                Vec v[NG];
#pragma unroll
                for (int q = 0; q < NG; ++q) v[q] = slot[q * 32];
                add_row<T, NG>(acc, v, G, lane);
                if (k + D < n) {
                    const T* row = next_row(bits, src, H, F);
#pragma unroll
                    for (int q = 0; q < NG; ++q)
                        if (lane + 32 * q < G)
                            cp_async<sizeof(Vec)>(slot + q * 32,
                                                  row + 4 * (lane + 32 * q));
                }
                cp_async_commit();
            }
        }
        finish_row<T, NG>(acc, self, deg, G, lane, sw, sw1, out + r * F);
    }
}

int64_t row_blocks(int64_t n) {
    int64_t blocks = (n + kWarps - 1) / kWarps;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    return blocks < 1 ? 1 : blocks;
}

template <typename T, typename TT, int NG, typename Walk>
void launch_ng(int64_t n_pad, int F, float sw, float sw1,
               const int64_t* indptr, Walk walk, Window<TT> win,
               const void* H, void* out, cudaStream_t s) {
    using Vec = typename Feat<T>::Vec;
    constexpr size_t smem = (size_t)kWarps * Depth<NG>::D * NG * 32
                            * sizeof(Vec);
    // the ring stays within the 48 KB a launch takes without opting in:
    // at most 32 KB for float32, 16 KB for bfloat16 (D falls as rows widen)
    static_assert(smem <= 48 * 1024, "K10 ring over 48 KB");
    ring_kernel<T, TT, NG, Walk><<<row_blocks(n_pad), kWarps * 32, smem,
                                   s>>>(n_pad, F, sw, sw1, indptr, walk, win,
                                        static_cast<const T*>(H),
                                        static_cast<T*>(out));
}

template <typename T, typename TT, typename Walk>
void launch(int64_t n_pad, int F, float sw, float sw1, const int64_t* indptr,
            Walk walk, Window<TT> win, const void* H, void* out,
            cudaStream_t s) {
    switch ((F / 4 + 31) / 32) {    // groups of 4 features a lane
    case 1:
        launch_ng<T, TT, 1>(n_pad, F, sw, sw1, indptr, walk, win, H, out, s);
        break;
    case 2:
        launch_ng<T, TT, 2>(n_pad, F, sw, sw1, indptr, walk, win, H, out, s);
        break;
    case 3:
        launch_ng<T, TT, 3>(n_pad, F, sw, sw1, indptr, walk, win, H, out, s);
        break;
    default:
        launch_ng<T, TT, 4>(n_pad, F, sw, sw1, indptr, walk, win, H, out, s);
    }
}

// one round over `walk` for the storage type (fdtype) and time type
// (tbytes) of the call
template <typename Walk>
void launch_round(int64_t n_pad, int64_t F, int64_t fdtype, int64_t tbytes,
                  int64_t lo, int64_t nowin, float sw, float sw1,
                  const void* in_indptr, Walk walk, const void* e_lat,
                  const void* e_alive, const void* H, void* out,
                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t* ip = static_cast<const int64_t*>(in_indptr);
    const uint8_t* al = static_cast<const uint8_t*>(e_alive);
    if (tbytes == 4) {
        const Window<int32_t> w{static_cast<const int32_t*>(e_lat), al, lo,
                                (int)nowin};
        if (fdtype == 0)
            launch<float>(n_pad, (int)F, sw, sw1, ip, walk, w, H, out, s);
        else
            launch<__nv_bfloat16>(n_pad, (int)F, sw, sw1, ip, walk, w, H,
                                  out, s);
    } else {
        const Window<int64_t> w{static_cast<const int64_t*>(e_lat), al, lo,
                                (int)nowin};
        if (fdtype == 0)
            launch<float>(n_pad, (int)F, sw, sw1, ip, walk, w, H, out, s);
        else
            launch<__nv_bfloat16>(n_pad, (int)F, sw, sw1, ip, walk, w, H,
                                  out, s);
    }
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
// [m_pad] | H [n_pad, F] | out [n_pad, F]. One launch.
int rtpu_feature_propagate(int64_t n_pad, int64_t F, int64_t fdtype,
                           int64_t tbytes, int64_t lo, int64_t nowin,
                           float sw, float sw1, const void* in_indptr,
                           const void* e_src, const void* e_lat,
                           const void* e_alive, const void* H, void* out,
                           void* stream) {
    if (n_pad == 0) return (int)cudaGetLastError();
    if (bad_args(F, fdtype, tbytes)) return (int)cudaErrorInvalidValue;
    launch_round(n_pad, F, fdtype, tbytes, lo, nowin, sw, sw1, in_indptr,
                 EdgeWalk{static_cast<const int32_t*>(e_src)}, e_lat,
                 e_alive, H, out, stream);
    return (int)cudaGetLastError();
}

// K10-P. As K10 | in_indptr [n_pad+1] int64 (the layout's destination
// walk: each row's real slots, in source order), walk [m, 2] int32 (each
// walk entry's source row u_src[slot[s]] and edge perm[s]) | e_lat,
// e_alive [m_pad] | H | out. One launch.
int rtpu_feature_propagate_binned(int64_t n_pad, int64_t F, int64_t fdtype,
                                  int64_t tbytes, int64_t lo, int64_t nowin,
                                  float sw, float sw1,
                                  const void* in_indptr, const void* walk,
                                  const void* e_lat, const void* e_alive,
                                  const void* H, void* out, void* stream) {
    if (n_pad == 0) return (int)cudaGetLastError();
    if (bad_args(F, fdtype, tbytes)) return (int)cudaErrorInvalidValue;
    launch_round(n_pad, F, fdtype, tbytes, lo, nowin, sw, sw1, in_indptr,
                 PairWalk{static_cast<const int2*>(walk)}, e_lat, e_alive, H,
                 out, stream);
    return (int)cudaGetLastError();
}

}  // extern "C"
