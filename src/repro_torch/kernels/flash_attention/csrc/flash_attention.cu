// Flash attention (causal / sliding window), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:79
// (flash_attention_tpu, body _attn_kernel at :30-76).  q: (BH, S, d),
// k and v: (BH, T, d), heads already flattened and kv-expanded.
//
// What bounds it on the card: operations at prefill (4 d per unmasked
// query-key pair), bytes at decode (S = 1: every k and v row read once
// for one query row).  The Pallas kernel walks kv tiles as sequential
// grid steps and carries m, l and acc in VMEM scratch; Hopper's blocks
// run in no order, so here one block owns a tile of BQ = 64 query rows
// of one head and loops over the kv tiles itself, with m, l and acc in
// registers.  The kv loop covers only the tiles the causal and window
// masks leave open; a skipped tile would change nothing (its rows get
// alpha = 1 and p = 0).  This first kernel runs on the CUDA cores in
// f32 for both input types; tensor cores are later work.
//
// Block: 256 threads as 16 x 16 (ty, tx).  Thread (ty, tx) holds query
// rows ty + 16 i (i < 4): in the logits phase the keys tx + 16 j
// (j < 4) of the tile, in the output phase the columns tx + 16 jj
// (jj < NJ, NJ * 16 >= d).  The 16 threads of one row group are one
// half warp, so the row max and sum are shuffles within it.  Shared
// memory (f32): Q (BQ x d+1), K (BK x d+1), V (BK x d), P (BQ x BK+1);
// the +1 pads keep column reads across rows off one bank.  At d = 256
// that is 209 KiB, above the 48 KiB default, so the launcher raises
// the block's dynamic shared-memory limit first.
//
// Every detail of _attn_kernel is kept:
//   q_pos = q index + (T - S)          queries aligned to the end (:50-51)
//   mask  = k_pos <= q_pos (causal), k_pos > q_pos - window (:53-57)
//   s     = dot(q, k) * scale, NEG_INF = -1e30 where masked
//   m_new = max(m, max_row(s)); alpha = exp(min(m - m_new, 0)) (:64)
//   p     = exp(s - m_new), 0 where masked (:66)
//   l     = alpha l + sum_row(p);  acc = alpha acc + p v
//   out   = acc / max(l, 1e-30)    so a row that sees no key is 0 (:75)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// reductions over the 16 lanes of a half warp (one query row's keys)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__host__ __device__ constexpr size_t smem_floats(int d) {
    return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
           (size_t)BQ * (BK + 1);
}

template <typename T>
__device__ __forceinline__ void load_tile(float *dst, int ld,
                                          const T *__restrict__ src,
                                          int row0, int rows, int d) {
    // rows [row0, row0 + 64) of a (rows x d) matrix; zero past its end
    for (int i = threadIdx.x; i < 64 * d; i += THREADS) {
        const int r = i / d, c = i % d;
        dst[r * ld + c] =
            row0 + r < rows ? to_f32(src[(size_t)(row0 + r) * d + c]) : 0.f;
    }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T *__restrict__ q, const T *__restrict__ k,
            const T *__restrict__ v, T *__restrict__ out, int S, int T_,
            int d, float scale, int causal, int window) {
    extern __shared__ float sm[];
    const int ldq = d + 1, ldk = d + 1, ldv = d, ldp = BK + 1;
    float *Qs = sm;
    float *Ks = Qs + BQ * ldq;
    float *Vs = Ks + BK * ldk;
    float *Ps = Vs + BK * ldv;

    // the longest query tiles (latest under causal) start first
    const int n_qt = (S + BQ - 1) / BQ;
    const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
    const size_t bh = blockIdx.x / n_qt;
    const int q0 = qt * BQ;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int off = T_ - S;
    const T *qh = q + bh * S * d;
    const T *kh = k + bh * T_ * d;
    const T *vh = v + bh * T_ * d;

    // the kv range the block's valid rows can see
    const int q_hi = min(q0 + BQ, S) - 1 + off;   // last query position
    const int q_lo = q0 + off;
    const int kv_end = causal ? min(T_, q_hi + 1) : T_;
    const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

    load_tile(Qs, ldq, qh, q0, S, d);

    float m[4], l[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
    }

    for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
        __syncthreads();            // the previous tile's reads are done
        load_tile(Ks, ldk, kh, k0, T_, d);
        load_tile(Vs, ldv, vh, k0, T_, d);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int c = 0; c < d; ++c) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ldq + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ldk + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q_pos = q0 + ty + 16 * i + off;
            bool ok[4];
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k_pos = k0 + tx + 16 * j;
                ok[j] = k_pos < T_ && (!causal || k_pos <= q_pos) &&
                        (window <= 0 || k_pos > q_pos - window);
                s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], row_max(mx));
            const float alpha = expf(fminf(m[i] - m_new, 0.f));
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
                Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
                psum += p;
            }
            l[i] = alpha * l[i] + row_sum(psum);
            m[i] = m_new;
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
        }
        __syncthreads();            // P complete

        for (int kk = 0; kk < BK; ++kk) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * ldp + kk];
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
                const int c = tx + 16 * jj;
                const float vv = c < d ? Vs[kk * ldv + c] : 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
            }
        }
    }

    T *oh = out + bh * S * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
        const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
            const int c = tx + 16 * jj;
            if (c < d) oh[(size_t)row * d + c] = from_f32<T>(acc[i][jj] / denom);
        }
    }
}

template <typename T, int NJ>
cudaError_t launch(const void *q, const void *k, const void *v, void *out,
                   int BH, int S, int T_, int d, float scale, int causal,
                   int window, cudaStream_t stream) {
    const size_t smem = smem_floats(d) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            attn_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    const unsigned blocks = (unsigned)BH * (unsigned)((S + BQ - 1) / BQ);
    attn_kernel<T, NJ><<<blocks, THREADS, smem, stream>>>(
        (const T *)q, (const T *)k, (const T *)v, (T *)out, S, T_, d, scale,
        causal, window);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void *q, const void *k, const void *v, void *out,
                     int BH, int S, int T_, int d, float scale, int causal,
                     int window, cudaStream_t s) {
    const int nj = (d + 15) / 16;
    if (nj <= 2) return launch<T, 2>(q, k, v, out, BH, S, T_, d, scale, causal, window, s);
    if (nj <= 4) return launch<T, 4>(q, k, v, out, BH, S, T_, d, scale, causal, window, s);
    if (nj <= 8) return launch<T, 8>(q, k, v, out, BH, S, T_, d, scale, causal, window, s);
    if (nj <= 10) return launch<T, 10>(q, k, v, out, BH, S, T_, d, scale, causal, window, s);
    if (nj <= 16) return launch<T, 16>(q, k, v, out, BH, S, T_, d, scale, causal, window, s);
    return cudaErrorInvalidValue;       // d > 256: the wrapper refuses it
}

}  // namespace

// q: (BH, S, d), k and v: (BH, T, d), out: (BH, S, d), one dtype
// (0 float32, 1 bfloat16); d <= 256.
extern "C" int attn_launch(const void *q, const void *k, const void *v,
                           void *out, int BH, int S, int T_, int d,
                           float scale, int causal, int window, int dtype,
                           void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(dtype == 1 ? launch_d<__nv_bfloat16>(q, k, v, out, BH, S,
                                                      T_, d, scale, causal,
                                                      window, s)
                            : launch_d<float>(q, k, v, out, BH, S, T_, d,
                                              scale, causal, window, s));
}
