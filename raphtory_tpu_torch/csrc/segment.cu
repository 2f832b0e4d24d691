// K7 — the masked segment combine of the generic superstep engine.
//
// Replaces raphtory_tpu/ops/segment.py:35 `segment_combine` on the route
// the superstep runner takes off the TPU (engine/bsp.py:145,152,154: the
// per-window degrees and the message combine at each destination or, for
// the reverse direction, each source). For k windows laid out flat
// (window-major, window w's edges at w*m .. w*m+m-1):
//
//     out[w, r, f] = op over e in the CSR run of r of
//                    (mask[w*m + e] ? x[(w*m + e), f] : neutral)
//
// with op in {sum, min, max} and neutral 0 / the type's max (+inf) / the
// type's min (-inf). Empty and fully masked runs give the neutral value, as
// the reference's masked segment ops do.
//
// The reference scatters each edge's payload into its segment. Here the
// edges of a row are found through a CSR over the REAL edges: the
// destination direction walks `indptr` over the (dst, src)-sorted edges
// (perm = null, the edge itself), the source direction walks the source-
// ordered index (`perm[j]` = engine position of the j-th edge in source
// order). Pad edges lie outside both CSRs; they are masked in every window
// anyway. One thread owns one (window, row, feature) and walks its run in
// CSR order, so there are no atomics and the sum order is fixed: the
// result is deterministic and, in the destination direction, adds in the
// same order as a sequential scatter over the sorted edges. Floats add
// with __fadd_rn so no contraction can move them.
//
// What bounds it on the H100: bytes — the mask and the payload of every
// edge read once per window, the CSR once, the output written once; one
// operation per masked edge. A row's thread walks its whole run, so a
// very high degree (Bitcoin's Pareto senders in the source direction)
// serialises that thread; a row split is an open item.
//
// K7-P `rtpu_partition_reduce` — the destination-binned (PCPM) combine,
// raphtory_tpu/ops/segment.py:116 `partition_segment_reduce` as the
// superstep runner calls it (engine/bsp.py:127-141): each window's
// per-edge payload is read through the layout permutation and its mask
// through perm & valid, and every destination partition reduces into its
// own dense n_per-row block (rows p*n_per .. (p+1)*n_per-1), the blocks
// sliced to the first n rows:
//
//     out[w, r, f] = op over j in [indptr[r], indptr[r+1]) of
//                    (valid[s] && mask[w*m + perm[s]] ?
//                     x[(w*m + perm[s]), f] : neutral),   s = order[j]
//
// `indptr`/`order` is the layout's destination walk (each row's real slots
// in source order, built once on the host), so a block of neighbouring
// threads covers neighbouring rows of one partition's block. perm null:
// slot s is payload row s (the [P, cap] payload of the reference's
// signature); valid null: every slot real. One thread per (window, row,
// feature), fixed order, no atomics: the sums add in the order K7 adds the
// same edges, min/max are order-exact. Bound: bytes — the payload and mask
// of every real edge once per window through perm, the walk once, the
// output written once.
//
// Plain C interface, loaded with ctypes (raphtory_tpu_torch/ops/segment.py).
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Lim;
template <> struct Lim<float> {
    __device__ static float hi() { return __int_as_float(0x7f800000); }
    __device__ static float lo() { return __int_as_float(0xff800000); }
    __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Lim<int32_t> {
    __device__ static int32_t hi() { return INT32_MAX; }
    __device__ static int32_t lo() { return INT32_MIN; }
    __device__ static int32_t add(int32_t a, int32_t b) { return a + b; }
};

template <typename T, int OP>
__device__ inline T neutral() {
    if (OP == kSum) return T(0);
    if (OP == kMin) return Lim<T>::hi();
    return Lim<T>::lo();
}

template <typename T, int OP>
__device__ inline T combine(T a, T b) {
    if (OP == kSum) return Lim<T>::add(a, b);
    if (OP == kMin) return b < a ? b : a;
    return b > a ? b : a;
}

template <typename T, int OP>
__global__ void segment_combine_kernel(int64_t k, int64_t n, int64_t m,
                                       int64_t F,
                                       const int64_t* __restrict__ indptr,
                                       const int32_t* __restrict__ perm,
                                       const T* __restrict__ x,
                                       const uint8_t* __restrict__ mask,
                                       T* __restrict__ out) {
    const int64_t total = k * n * F;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t f = t % F;
        const int64_t r = (t / F) % n;
        const int64_t w = t / (F * n);
        const int64_t base = w * m;
        T acc = neutral<T, OP>();
        const int64_t j1 = indptr[r + 1];
        for (int64_t j = indptr[r]; j < j1; ++j) {
            const int64_t e = base + (perm ? (int64_t)perm[j] : j);
            if (mask[e]) acc = combine<T, OP>(acc, x[e * F + f]);
        }
        out[t] = acc;
    }
}

template <typename T, int OP>
__global__ void partition_reduce_kernel(int64_t k, int64_t n, int64_t m,
                                        int64_t F,
                                        const int64_t* __restrict__ indptr,
                                        const int32_t* __restrict__ order,
                                        const int32_t* __restrict__ perm,
                                        const uint8_t* __restrict__ valid,
                                        const T* __restrict__ x,
                                        const uint8_t* __restrict__ mask,
                                        T* __restrict__ out) {
    const int64_t total = k * n * F;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < total; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t f = t % F;
        const int64_t r = (t / F) % n;
        const int64_t w = t / (F * n);
        const int64_t base = w * m;
        T acc = neutral<T, OP>();
        const int64_t j1 = indptr[r + 1];
        for (int64_t j = indptr[r]; j < j1; ++j) {
            const int64_t s = order[j];
            if (valid && !valid[s]) continue;
            const int64_t e = base + (perm ? (int64_t)perm[s] : s);
            if (mask[e]) acc = combine<T, OP>(acc, x[e * F + f]);
        }
        out[t] = acc;
    }
}

template <typename T>
void launch_partition(int op, int64_t k, int64_t n, int64_t m, int64_t F,
                      const int64_t* indptr, const int32_t* order,
                      const int32_t* perm, const uint8_t* valid,
                      const void* x, const uint8_t* mask, void* out,
                      cudaStream_t s) {
    const int64_t total = k * n * F;
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    if (blocks < 1) blocks = 1;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (op == kSum)
        partition_reduce_kernel<T, kSum><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, order, perm, valid, xt, mask, ot);
    else if (op == kMin)
        partition_reduce_kernel<T, kMin><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, order, perm, valid, xt, mask, ot);
    else
        partition_reduce_kernel<T, kMax><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, order, perm, valid, xt, mask, ot);
}

template <typename T>
void launch(int op, int64_t k, int64_t n, int64_t m, int64_t F,
            const int64_t* indptr, const int32_t* perm, const void* x,
            const uint8_t* mask, void* out, cudaStream_t s) {
    const int64_t total = k * n * F;
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 65535 * 8) blocks = 65535 * 8;
    if (blocks < 1) blocks = 1;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (op == kSum)
        segment_combine_kernel<T, kSum><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, perm, xt, mask, ot);
    else if (op == kMin)
        segment_combine_kernel<T, kMin><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, perm, xt, mask, ot);
    else
        segment_combine_kernel<T, kMax><<<blocks, kThreads, 0, s>>>(
            k, n, m, F, indptr, perm, xt, mask, ot);
}

}  // namespace

extern "C" {

// op: 0 sum, 1 min, 2 max; dtype: 0 float32, 1 int32. perm may be null
// (the destination direction: the CSR runs are the edges themselves).
int rtpu_segment_combine(int64_t k, int64_t n, int64_t m, int64_t F,
                         int64_t op, int64_t dtype, const void* indptr,
                         const void* perm, const void* x, const void* mask,
                         void* out, void* stream) {
    if (k * n * F == 0) return (int)cudaGetLastError();
    if (op < 0 || op > 2 || dtype < 0 || dtype > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t* ip = static_cast<const int64_t*>(indptr);
    const int32_t* pp = static_cast<const int32_t*>(perm);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    if (dtype == 0)
        launch<float>((int)op, k, n, m, F, ip, pp, x, mk, out, s);
    else
        launch<int32_t>((int)op, k, n, m, F, ip, pp, x, mk, out, s);
    return (int)cudaGetLastError();
}

// K7-P. k windows, n rows, m payload rows per window, F features; op and
// dtype as rtpu_segment_combine | indptr [n+1] int64, order int32 (the
// destination walk), perm [B] int32 or null, valid [B] bool or null,
// x [k*m, F], mask [k*m] | out [k*n, F].
int rtpu_partition_reduce(int64_t k, int64_t n, int64_t m, int64_t F,
                          int64_t op, int64_t dtype, const void* indptr,
                          const void* order, const void* perm,
                          const void* valid, const void* x, const void* mask,
                          void* out, void* stream) {
    if (k * n * F == 0) return (int)cudaGetLastError();
    if (op < 0 || op > 2 || dtype < 0 || dtype > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t* ip = static_cast<const int64_t*>(indptr);
    const int32_t* od = static_cast<const int32_t*>(order);
    const int32_t* pp = static_cast<const int32_t*>(perm);
    const uint8_t* vd = static_cast<const uint8_t*>(valid);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    if (dtype == 0)
        launch_partition<float>((int)op, k, n, m, F, ip, od, pp, vd, x, mk,
                                out, s);
    else
        launch_partition<int32_t>((int)op, k, n, m, F, ip, od, pp, vd, x, mk,
                                  out, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
