// Fused residual add + RMSNorm, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:31
// (fused_rmsnorm_tpu, body _rmsnorm_kernel at :19-28).
//
// What bounds it on the card: bytes.  Per element it reads x (and the
// residual) once and writes the normed output and the residual stream
// once, with a handful of operations in between.  Design: one block per
// row.  The row's f32 sum x (+ r) stays in shared memory between the
// sum-of-squares reduction and the writes, so device memory is read
// once; neighbouring threads touch neighbouring elements.
//
// The operands' dtypes are the caller's, as in the Pallas kernel, which
// casts each to f32 as it loads it: x and the outputs in T, the
// residual in R (float32, bfloat16 or float16 each), scale in f32 (the
// wrapper widens it, exactly).
//
// The arithmetic is the Pallas kernel's, not the oracle's:
//   x   = f32(x) [+ f32(r)]                 residual added in f32 (:22-23)
//   var = sum(x * x) / D ;  y = x / sqrt(var + eps)
//   out = T(f32(T(y)) * f32(T(scale)))      y cast before the multiply
//                                           (:26-27); the product of two
//                                           bf16 or f16 values is exact in
//                                           f32, so one rounding equals a
//                                           multiply in T
//   res = T(x)                              written even without r (:28)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
    return __float2half_rn(v);
}

// The block's sum of v; every thread gets the same bits (the partials
// are added in one order).
__device__ float block_sum(float v) {
    __shared__ float part[THREADS / 32];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) t += part[i];
    return t;
}

template <typename T, typename R>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T *__restrict__ x, const R *__restrict__ r,
               const float *__restrict__ scale, T *__restrict__ y,
               T *__restrict__ res, int D, float eps) {
    extern __shared__ float row[];          // D floats: x (+ r) in f32
    const size_t base = (size_t)blockIdx.x * D;
    float ss = 0.f;
    for (int j = threadIdx.x; j < D; j += THREADS) {
        float v = to_f32(x[base + j]);
        if (r != nullptr) v += to_f32(r[base + j]);
        row[j] = v;
        ss += v * v;
    }
    const float var = block_sum(ss) / (float)D;
    const float inv = 1.0f / sqrtf(var + eps);
    // each thread reads back only the elements it wrote
    for (int j = threadIdx.x; j < D; j += THREADS) {
        const float v = row[j];
        res[base + j] = from_f32<T>(v);
        const float yo = to_f32(from_f32<T>(v * inv));
        const float so = to_f32(from_f32<T>(scale[j]));
        y[base + j] = from_f32<T>(yo * so);
    }
}

template <typename T, typename R>
cudaError_t launch(const void *x, const void *r, const float *scale,
                   void *y, void *res, int rows, int D, float eps,
                   cudaStream_t stream) {
    const size_t smem = (size_t)D * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rmsnorm_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    rmsnorm_kernel<T, R><<<rows, THREADS, smem, stream>>>(
        (const T *)x, (const R *)r, scale, (T *)y, (T *)res, D, eps);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_r(const void *x, const void *r, const float *scale,
                     void *y, void *res, int rows, int D, float eps,
                     int rdtype, cudaStream_t s) {
    switch (rdtype) {
    case 0: return launch<T, float>(x, r, scale, y, res, rows, D, eps, s);
    case 1:
        return launch<T, __nv_bfloat16>(x, r, scale, y, res, rows, D, eps, s);
    case 2: return launch<T, __half>(x, r, scale, y, res, rows, D, eps, s);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// x, y, res: (rows, D) of dtype; r (nullable): (rows, D) of rdtype (each
// 0 float32, 1 bfloat16, 2 float16; rdtype is read only with r);
// scale: (D,) float32.
extern "C" int rmsnorm_launch(const void *x, const void *r,
                              const void *scale, void *y, void *res,
                              int rows, int D, float eps, int dtype,
                              int rdtype, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const float *sc = (const float *)scale;
    if (r == nullptr) rdtype = dtype;
    cudaError_t e = cudaErrorInvalidValue;
    switch (dtype) {
    case 0:
        e = launch_r<float>(x, r, sc, y, res, rows, D, eps, rdtype, s);
        break;
    case 1:
        e = launch_r<__nv_bfloat16>(x, r, sc, y, res, rows, D, eps, rdtype,
                                    s);
        break;
    case 2:
        e = launch_r<__half>(x, r, sc, y, res, rows, D, eps, rdtype, s);
        break;
    }
    return (int)e;
}
