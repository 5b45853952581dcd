// Fused residual add + RMSNorm, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:31
// (fused_rmsnorm_tpu, body _rmsnorm_kernel at :19-28).
//
// What bounds it on the card: bytes.  Per element it reads x (and the
// residual) once and writes y (and, with a residual, the residual
// stream) once, with a handful of operations in between.  Without a
// residual the stream is T(f32(x)), which is x bit for bit: the kernel
// writes no copy of it and the wrapper returns x itself.
//
// Design: move each byte once and keep many loads in flight.
//   vector  (every operand's base pointer 16-byte aligned, D a
//           multiple of one 16-byte vector of x, the row held by at most
//           16 warps of 4 vectors a thread): W warps (1-16) hold a row,
//           each thread NV (1, 2 or 4) vectors of 16 bytes of x and the
//           residual's same elements in registers as loaded; all of a
//           row's loads are issued before its reduction, and the next
//           row's before this row reduces, so they fly while it reduces
//           and stores.
//   smem    (any other D or base pointer): a 256-thread block a row, one
//           element a load, the f32 row staged through shared memory
//           between the reduction and the writes.
// kernel.py's rms_plan picks the route and the grid: the blocks the card
// keeps resident, each walking rows and reading T(scale) for its
// columns into registers once, where reading T(scale) per row would
// move as many bytes as the row itself (no residual); else one block a
// row group, which the card balances as blocks finish.  Loads and
// stores take the default cache policy: y is what the next op reads.
// The warp sum is a xor butterfly, so every lane gets the same bits, and
// a row's warp partials are added in one fixed order.
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
//   res = T(x)                              (:28) written with r only

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_THREADS = 256;   // the smem route's block
constexpr int REG_THREADS = 512;    // at most, a vector-route block
constexpr int ROW_THREADS = 256;    // a block holds whole rows up to these
constexpr int MAX_WARPS = 16;       // warps a row, vector route

// Vector-route blocks of REG_THREADS an SM keeps resident
// (__launch_bounds__' minimum: at most 64 registers a thread for 2, 128
// for 1): kernel.py's rms_plan sizes the persistent grid by it.
__host__ __device__ constexpr int min_blocks(int NV) { return NV <= 2 ? 2 : 1; }

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

// A 2-byte type's 16 bits to f32, and f32 rounded to its 16 bits.
template <typename E> __device__ __forceinline__ float from_bits16(unsigned h);
template <> __device__ __forceinline__ float
from_bits16<__nv_bfloat16>(unsigned h) {
    return __uint_as_float(h << 16);
}
template <> __device__ __forceinline__ float from_bits16<__half>(unsigned h) {
    return __half2float(__ushort_as_half((unsigned short)h));
}
template <typename E> __device__ __forceinline__ unsigned bits16(float v);
template <> __device__ __forceinline__ unsigned
bits16<__nv_bfloat16>(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ unsigned bits16<__half>(float v) {
    return __half_as_ushort(__float2half_rn(v));
}

// The 32-bit words U elements of E occupy.
template <typename E, int U>
__host__ __device__ constexpr int words() {
    return U * (int)sizeof(E) / 4;
}

// U f32 values rounded to E, as 32-bit words (little-endian halves for
// 2-byte E).
template <typename E, int U>
__device__ __forceinline__ void encode(const float *f, unsigned *w) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
        if constexpr (sizeof(E) == 4) {
            w[i] = __float_as_uint(f[i]);
        } else if (i & 1) {
            w[i >> 1] |= bits16<E>(f[i]) << 16;
        } else {
            w[i >> 1] = bits16<E>(f[i]);
        }
    }
}

// U elements of E at p (aligned to their size, 8, 16 or 32 bytes) as
// loaded: one 8-byte load, or 16-byte loads.  words_f32 turns them, or
// encode's words, into f32 (exact).
template <typename E, int U>
__device__ __forceinline__ void load_words(const E *__restrict__ p,
                                           unsigned *w) {
    constexpr int NW = words<E, U>();
    if constexpr (NW == 2) {
        const uint2 q = *reinterpret_cast<const uint2 *>(p);
        w[0] = q.x;
        w[1] = q.y;
    } else {
#pragma unroll
        for (int j = 0; j < NW / 4; ++j) {
            const uint4 q = reinterpret_cast<const uint4 *>(p)[j];
            w[4 * j] = q.x;
            w[4 * j + 1] = q.y;
            w[4 * j + 2] = q.z;
            w[4 * j + 3] = q.w;
        }
    }
}
template <typename E, int U>
__device__ __forceinline__ void words_f32(const unsigned *w, float *f) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
        if constexpr (sizeof(E) == 4) {
            f[i] = __uint_as_float(w[i]);
        } else {
            f[i] = from_bits16<E>((i & 1) ? w[i >> 1] >> 16
                                          : w[i >> 1] & 0xffffu);
        }
    }
}

// U f32 values rounded to T and stored at p in one 16-byte store
// (U * sizeof(T) == 16).
template <typename T, int U>
__device__ __forceinline__ void store_unit(T *__restrict__ p, const float *f) {
    unsigned w[4];
    encode<T, U>(f, w);
    *reinterpret_cast<uint4 *>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// One row's units of a thread as loaded: x's words and the residual's.
template <typename T, typename R, int U, int NV> struct RowWords {
    unsigned x[NV][words<T, U>()], r[NV][words<R, U>()];
};

// The vector route: U elements of T a unit (16 bytes), NV units a
// thread, `warps` warps a row, blockDim.x / (32 * warps) rows a block at
// once (whole rows up to ROW_THREADS threads, else one).  Thread t of a
// row holds units t, t + 32 * warps, ... so neighbouring threads touch
// neighbouring 16 bytes.  A thread's row stays in registers as loaded;
// the next row's loads are issued before this row's reduction, so they
// fly while it reduces and stores.
template <typename T, typename R, int NV>
__global__ void __launch_bounds__(REG_THREADS, min_blocks(NV))
rmsnorm_reg_kernel(const T *__restrict__ x, const R *__restrict__ r,
                   const float *__restrict__ scale, T *__restrict__ y,
                   T *__restrict__ res, int rows, int D, float eps,
                   int warps) {
    constexpr int U = 16 / (int)sizeof(T);
    // the warps' partial sums, two sets used in turn: one barrier a row
    __shared__ float part[2][REG_THREADS / 32];
    const int nt = 32 * warps;
    const int per_block = blockDim.x / nt;
    const int g = threadIdx.x / nt, t = threadIdx.x % nt;
    const int units = D / U;
    const int stride = gridDim.x * per_block;
    // T(scale) of this thread's columns, once, as T's words
    unsigned sw[NV][words<T, U>()];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int u = t + k * nt;
        float f[U];
        if (u < units) {
            unsigned w[words<float, U>()];
            load_words<float, U>(scale + (size_t)u * U, w);
            words_f32<float, U>(w, f);
        } else {
#pragma unroll
            for (int i = 0; i < U; ++i) f[i] = 0.f;
        }
        encode<T, U>(f, sw[k]);
    }
    auto fetch = [&](RowWords<T, R, U, NV> &w, int row) {
        const size_t base = (size_t)row * D;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const int u = t + k * nt;
            if (u < units) {
                load_words<T, U>(x + base + (size_t)u * U, w.x[k]);
                if (r != nullptr)
                    load_words<R, U>(r + base + (size_t)u * U, w.r[k]);
            }
        }
    };
    // x (+ r) in f32 of unit k
    auto sum = [&](const RowWords<T, R, U, NV> &w, int k, float *v) {
        words_f32<T, U>(w.x[k], v);
        if (r != nullptr) {
            float q[U];
            words_f32<R, U>(w.r[k], q);
#pragma unroll
            for (int i = 0; i < U; ++i) v[i] += q[i];
        }
    };
    RowWords<T, R, U, NV> cur, next;
    int turn = 0;
    if (blockIdx.x * per_block + g < rows)
        fetch(cur, blockIdx.x * per_block + g);
    for (int first = blockIdx.x * per_block; first < rows;
         first += stride, turn ^= 1) {
        const int row = first + g;
        const bool live = row < rows;
        if (row + stride < rows) fetch(next, row + stride);
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            if (live && t + k * nt < units) {
                float v[U];
                sum(cur, k, v);
#pragma unroll
                for (int i = 0; i < U; ++i) ss += v[i] * v[i];
            }
        }
        ss = warp_sum(ss);
        if (warps > 1) {
            float *p = part[turn];
            if ((threadIdx.x & 31) == 0) p[threadIdx.x >> 5] = ss;
            __syncthreads();
            ss = 0.f;
            for (int i = 0; i < warps; ++i) ss += p[g * warps + i];
        }
        const float var = ss / (float)D;
        const float inv = 1.0f / sqrtf(var + eps);
        if (live) {
            const size_t base = (size_t)row * D;
#pragma unroll
            for (int k = 0; k < NV; ++k) {
                const int u = t + k * nt;
                if (u >= units) continue;
                float v[U], s[U], o[U];
                sum(cur, k, v);
                words_f32<T, U>(sw[k], s);
#pragma unroll
                for (int i = 0; i < U; ++i)
                    o[i] = to_f32(from_f32<T>(v[i] * inv)) * s[i];
                store_unit<T, U>(y + base + (size_t)u * U, o);
                if (res != nullptr)
                    store_unit<T, U>(res + base + (size_t)u * U, v);
            }
        }
        cur = next;
    }
}

// The block's sum of v; every thread gets the same bits (the partials
// are added in one order).
__device__ float block_sum(float v) {
    __shared__ float part[SMEM_THREADS / 32];
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < SMEM_THREADS / 32; ++i) t += part[i];
    return t;
}

// The smem route: a block a row at a time, the row's f32 sum x (+ r) in
// shared memory between the reduction and the writes.
template <typename T, typename R>
__global__ void __launch_bounds__(SMEM_THREADS)
rmsnorm_smem_kernel(const T *__restrict__ x, const R *__restrict__ r,
                    const float *__restrict__ scale, T *__restrict__ y,
                    T *__restrict__ res, int rows, int D, float eps) {
    extern __shared__ float row[];          // D floats: x (+ r) in f32
    for (int i = blockIdx.x; i < rows; i += gridDim.x) {
        const size_t base = (size_t)i * D;
        float ss = 0.f;
        for (int j = threadIdx.x; j < D; j += SMEM_THREADS) {
            float v = to_f32(x[base + j]);
            if (r != nullptr) v += to_f32(r[base + j]);
            row[j] = v;
            ss += v * v;
        }
        const float var = block_sum(ss) / (float)D;
        const float inv = 1.0f / sqrtf(var + eps);
        // each thread reads back only the elements it wrote
        for (int j = threadIdx.x; j < D; j += SMEM_THREADS) {
            const float v = row[j];
            if (res != nullptr) res[base + j] = from_f32<T>(v);
            const float yo = to_f32(from_f32<T>(v * inv));
            const float so = to_f32(from_f32<T>(scale[j]));
            y[base + j] = from_f32<T>(yo * so);
        }
        __syncthreads();    // block_sum's partials are written again
    }
}

// route codes: kernel.py RMS_ROUTES
enum { VECTOR = 0, SMEM = 1 };

bool aligned16(const void *p) {
    return p == nullptr || ((unsigned long long)p & 15) == 0;
}

template <typename T, typename R>
cudaError_t launch(const void *x, const void *r, const float *scale,
                   void *y, void *res, int rows, int D, float eps, int route,
                   int warps, int nv, int blocks, cudaStream_t stream) {
    const T *xt = (const T *)x;
    const R *rt = (const R *)r;
    T *yt = (T *)y, *rs = (T *)res;
    if (blocks < 1) return cudaErrorInvalidValue;
    if (route == SMEM) {
        const size_t smem = (size_t)D * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                rmsnorm_smem_kernel<T, R>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return e;
        }
        rmsnorm_smem_kernel<T, R><<<blocks, SMEM_THREADS, smem, stream>>>(
            xt, rt, scale, yt, rs, rows, D, eps);
        return cudaGetLastError();
    }
    constexpr int U = 16 / (int)sizeof(T);
    const int nt = 32 * warps;
    if (route != VECTOR || warps < 1 || warps > MAX_WARPS || D % U ||
        (long long)nt * nv * U < D || !aligned16(x) || !aligned16(r) ||
        !aligned16(scale) || !aligned16(y) || !aligned16(res))
        return cudaErrorInvalidValue;
    const int threads = nt * (nt < ROW_THREADS ? ROW_THREADS / nt : 1);
    switch (nv) {
#define RMS_NV(n)                                                           \
    case n:                                                                 \
        rmsnorm_reg_kernel<T, R, n><<<blocks, threads, 0, stream>>>(        \
            xt, rt, scale, yt, rs, rows, D, eps, warps);                    \
        return cudaGetLastError();
        RMS_NV(1) RMS_NV(2) RMS_NV(4)
#undef RMS_NV
    }
    return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_r(const void *x, const void *r, const float *scale,
                     void *y, void *res, int rows, int D, float eps,
                     int rdtype, int route, int warps, int nv, int blocks,
                     cudaStream_t s) {
    switch (rdtype) {
    case 0:
        return launch<T, float>(x, r, scale, y, res, rows, D, eps, route,
                                warps, nv, blocks, s);
    case 1:
        return launch<T, __nv_bfloat16>(x, r, scale, y, res, rows, D, eps,
                                        route, warps, nv, blocks, s);
    case 2:
        return launch<T, __half>(x, r, scale, y, res, rows, D, eps, route,
                                 warps, nv, blocks, s);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (rows, D) of dtype; r (nullable): (rows, D) of rdtype (each 0
// float32, 1 bfloat16, 2 float16; rdtype is read only with r); res:
// (rows, D) of dtype, nullable (null exactly when r is: the stream is
// then x); scale: (D,) float32.  route (0 vector, 1 smem), warps a row,
// units a thread and blocks as kernel.py's rms_plan states them; a plan
// the route cannot run returns cudaErrorInvalidValue.
extern "C" int rmsnorm_launch(const void *x, const void *r,
                              const void *scale, void *y, void *res,
                              int rows, int D, float eps, int route,
                              int warps, int nv, int blocks, int dtype,
                              int rdtype, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const float *sc = (const float *)scale;
    if ((r == nullptr) != (res == nullptr)) return (int)cudaErrorInvalidValue;
    if (r == nullptr) rdtype = dtype;
    cudaError_t e = cudaErrorInvalidValue;
    switch (dtype) {
    case 0:
        e = launch_r<float>(x, r, sc, y, res, rows, D, eps, rdtype, route,
                            warps, nv, blocks, s);
        break;
    case 1:
        e = launch_r<__nv_bfloat16>(x, r, sc, y, res, rows, D, eps, rdtype,
                                    route, warps, nv, blocks, s);
        break;
    case 2:
        e = launch_r<__half>(x, r, sc, y, res, rows, D, eps, rdtype, route,
                             warps, nv, blocks, s);
        break;
    }
    return (int)e;
}
