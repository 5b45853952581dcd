// MoE grouped matmul, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul/kernel.py:39
// (grouped_matmul_tpu, body _gmm_kernel at :22-36): per expert e,
// out[e] = x[e] (C, D) @ w[e] (D, F), accumulated in f32 across D and
// cast to the output dtype once.
//
// What bounds it on the card: operations (2*E*C*D*F, far above the
// bytes of x, w and out at the MoE shapes).  Both kernels walk D
// innermost through shared memory, as _gmm_kernel walks its D grid
// axis, keep f32 sums and cast once; edges are masked, so any C, D and
// F work (the wrapper checks the reference's tiling contract).
//
// float32, gmm_kernel: on the CUDA cores, because float32 must stay
// float32 (no TF32; the reference's tolerance is 2e-5).  Grid (F tiles,
// C tiles, E); 256 threads own a 64 x 64 output tile in registers (4 x 4
// a thread, rows ty + 16 i, columns tx + 16 j, so shared-memory reads
// are conflict-free and stores coalesced), D in steps of 16.
//
// bfloat16, gmm_bf16_kernel: on the tensor cores through WMMA (mma.sync,
// 16 x 16 x 16 bf16 with f32 accumulators: a product of two bf16 values
// is exact in f32).  Grid (F tiles, C tiles, E) of 128 x 128 output
// tiles; 8 warps as 4 x 2, each a 32 x 64 tile of 2 x 4 accumulator
// fragments; D in steps of 32, the tiles loaded 16 bytes a thread where
// rows allow.  Loads are not pipelined yet (no cp.async / TMA), and
// wgmma would reach the card's full bf16 rate: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gmm_kernel(const float *__restrict__ x, const float *__restrict__ w,
           float *__restrict__ out, int C, int D, int F) {
    __shared__ float As[BK][BM + 1];        // x tile, transposed: [d][c]
    __shared__ float Bs[BK][BN];            // w tile: [d][f]
    const int e = blockIdx.z;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const float *xe = x + (size_t)e * C * D;
    const float *we = w + (size_t)e * D * F;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int m = i / BK, k = i % BK;
            As[k][m] = (m0 + m < C && k0 + k < D)
                           ? xe[(size_t)(m0 + m) * D + k0 + k]
                           : 0.f;
        }
#pragma unroll
        for (int i = tid; i < BK * BN; i += THREADS) {
            const int k = i / BN, n = i % BN;
            Bs[k][n] = (k0 + k < D && n0 + n < F)
                           ? we[(size_t)(k0 + k) * F + n0 + n]
                           : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    float *oe = out + (size_t)e * C * F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= C) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n < F) oe[(size_t)m * F + n] = acc[i][j];
        }
    }
}

constexpr int TBM = 128, TBN = 128, TBK = 32;
constexpr int LDA = TBK + 8, LDB = TBN + 8;     // pads, multiples of 8

__global__ void __launch_bounds__(THREADS)
gmm_bf16_kernel(const __nv_bfloat16 *__restrict__ x,
                const __nv_bfloat16 *__restrict__ w,
                __nv_bfloat16 *__restrict__ out, int C, int D, int F) {
    __shared__ __align__(32) __nv_bfloat16 As[TBM * LDA];
    __shared__ __align__(32) __nv_bfloat16 Bs[TBK * LDB];
    __shared__ __align__(32) float stage[THREADS / 32][16 * 16];
    const int e = blockIdx.z;
    const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
    const __nv_bfloat16 *xe = x + (size_t)e * C * D;
    const __nv_bfloat16 *we = w + (size_t)e * D * F;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int wm = warp / 2, wn = warp % 2;
    // 16-byte loads need 8-element rows (the tensors are contiguous)
    const bool vec_x = D % 8 == 0, vec_w = F % 8 == 0;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += TBK) {
        for (int c = tid; c < TBM * TBK / 8; c += THREADS) {
            const int r = c / (TBK / 8), kc = (c % (TBK / 8)) * 8;
            const int gm = m0 + r, gk = k0 + kc;
            __nv_bfloat16 *dst = &As[r * LDA + kc];
            const __nv_bfloat16 *src = xe + (size_t)gm * D + gk;
            if (vec_x && gm < C && gk + 8 <= D) {
                *reinterpret_cast<uint4 *>(dst) =
                    *reinterpret_cast<const uint4 *>(src);
            } else {
                for (int t = 0; t < 8; ++t)
                    dst[t] = gm < C && gk + t < D ? src[t] : zero;
            }
        }
        for (int c = tid; c < TBK * TBN / 8; c += THREADS) {
            const int r = c / (TBN / 8), nc = (c % (TBN / 8)) * 8;
            const int gk = k0 + r, gn = n0 + nc;
            __nv_bfloat16 *dst = &Bs[r * LDB + nc];
            const __nv_bfloat16 *src = we + (size_t)gk * F + gn;
            if (vec_w && gk < D && gn + 8 <= F) {
                *reinterpret_cast<uint4 *>(dst) =
                    *reinterpret_cast<const uint4 *>(src);
            } else {
                for (int t = 0; t < 8; ++t)
                    dst[t] = gk < D && gn + t < F ? src[t] : zero;
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b[4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * LDA + kk],
                                       LDA);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn * 64 + j * 16],
                                       LDB);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    // each accumulator tile through the warp's staging tile: cast once,
    // masked at the edges
    __nv_bfloat16 *oe = out + (size_t)e * C * F;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(stage[warp], acc[i][j], 16,
                                    wmma::mem_row_major);
            __syncwarp();
            for (int t = lane; t < 256; t += 32) {
                const int gm = m0 + wm * 32 + i * 16 + t / 16;
                const int gn = n0 + wn * 64 + j * 16 + t % 16;
                if (gm < C && gn < F)
                    oe[(size_t)gm * F + gn] = __float2bfloat16_rn(stage[warp][t]);
            }
            __syncwarp();
        }
}

cudaError_t launch_f32(const void *x, const void *w, void *out, int E, int C,
                       int D, int F, cudaStream_t stream) {
    const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
    gmm_kernel<<<grid, THREADS, 0, stream>>>(
        (const float *)x, (const float *)w, (float *)out, C, D, F);
    return cudaGetLastError();
}

cudaError_t launch_bf16(const void *x, const void *w, void *out, int E,
                        int C, int D, int F, cudaStream_t stream) {
    const dim3 grid((F + TBN - 1) / TBN, (C + TBM - 1) / TBM, E);
    gmm_bf16_kernel<<<grid, THREADS, 0, stream>>>(
        (const __nv_bfloat16 *)x, (const __nv_bfloat16 *)w,
        (__nv_bfloat16 *)out, C, D, F);
    return cudaGetLastError();
}

}  // namespace

// x: (E, C, D), w: (E, D, F), out: (E, C, F), one dtype
// (0 float32, 1 bfloat16).
extern "C" int gmm_launch(const void *x, const void *w, void *out, int E,
                          int C, int D, int F, int dtype, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(dtype == 1 ? launch_bf16(x, w, out, E, C, D, F, s)
                            : launch_f32(x, w, out, E, C, D, F, s));
}
