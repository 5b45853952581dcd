// Flash attention (causal / sliding window), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:79
// (flash_attention_tpu, body _attn_kernel at :30-76).  q: (BH, S, d) with
// query head b H + h at row block b H + h; k and v: (BH / group, T, d),
// the kv heads of the reference's jnp.repeat order, so query head qh
// reads kv head qh / group.  Nothing is expanded: each k and v row is
// read from device memory for its own kv head only.
//
// What bounds it on the card: operations at prefill (4 d per query-key
// pair the masks leave open), bytes at decode (S = 1: every k and v row
// read once for a few query rows).  The Pallas kernel walks kv tiles as
// sequential grid steps and carries m, l and acc in VMEM scratch;
// Hopper's blocks run in no order, so here one block owns a tile of 64
// or 128 query rows and loops over the kv tiles the masks leave open,
// with m, l and acc in registers.  A kv tile that a row cannot see
// changes nothing for it (alpha = 1, p = 0), so skipping it is exact.
//
// bfloat16, attn_tc_kernel, on the tensor cores (mma.sync m16n8k16,
// bf16 inputs, f32 accumulators):
//   * rows: the group query heads of one kv head are packed into the
//     rows of one tile, row r = s * group + (qh % group) for query
//     position s, so a block reads each k and v row once for all of
//     them; 4 warps, each owning MT m-tiles of 16 rows (Tiles: two where
//     the registers hold their accumulators and the rows fill them, so
//     each K and V fragment feeds two products);
//   * k and v tiles of 64 or 32 keys come into shared memory by
//     cp.async, 16 bytes a copy, double-buffered: tile j + 1 loads while
//     tile j computes.  Rows are padded by 16 bytes so the 8 rows an
//     ldmatrix phase reads fall on distinct banks; head dims are padded
//     with zeros up to DP (64, 128, 160 or 256);
//   * S = Q K^T into f32 registers (Q fragments loaded once by ldmatrix
//     and held in registers where they take at most 32, else re-read
//     from shared memory per kv tile), scaled by scale * log2 e so each
//     exp is one ex2; the row max and sum across the 4 lanes that share
//     a row by quad shuffles; a kv tile open to every row of a warp skips
//     the mask arithmetic, and a warp whose row maxima all held skips
//     the rescale of acc (alpha = 1);
//   * P goes from the accumulator layout straight into A fragments as
//     two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), each
//     multiplied by V (ldmatrix.trans) into the same f32 accumulator:
//     p keeps about 16 significant bits, where one bf16 rounding of P
//     misses the full-width limit (the reference computes p in f32);
//     l sums the f32 p;
//   * split-KV: where the row tiles are too few to fill the card
//     (decode), the wrapper splits each block's kv tiles into nsplit
//     chunks (a function of the shapes only, kernel.py kv_splits); each
//     block writes its chunk's (m, l, acc) in f32 to scratch and
//     attn_combine_kernel merges them: m = max m_i, l = sum e^(m_i - m)
//     l_i, acc = sum e^(m_i - m) acc_i.  A chunk with no open key has
//     m_i = NEG_INF, l_i = 0, acc_i = 0 and adds nothing.
//
// float32, attn_f32_kernel, on the CUDA cores in f32 (no TF32: the
// reference's float32 tolerance is 2e-5): one block of 256 threads as
// 16 x 16 per 64 query rows of one query head, which reads kv head
// bh / group; no split-KV; shared memory (f32) Q
// (64 x d+1), K (64 x d+1), V (64 x d), P (64 x 65), up to 209 KiB at
// d = 256, so the launcher raises the block's dynamic shared-memory
// limit first.
//
// Every detail of _attn_kernel is kept by both:
//   q_pos = q index + (T - S)          queries aligned to the end (:50-51)
//   mask  = k_pos <= q_pos (causal), k_pos > q_pos - window (:53-57)
//   s     = dot(q, k) * scale in f32, NEG_INF = -1e30 where masked
//   m_new = max(m, max_row(s)); alpha = exp(min(m - m_new, 0)) (:64)
//   p     = exp(s - m_new), 0 where masked (:66)
//   l     = alpha l + sum_row(p);  acc = alpha acc + p v
//   out   = acc / max(l, 1e-30)    so a row that sees no key is 0 (:75)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64, BK = 64, THREADS = 256;

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

__device__ __forceinline__ void load_tile(float *dst, int ld,
                                          const float *__restrict__ src,
                                          int row0, int rows, int d) {
    // rows [row0, row0 + 64) of a (rows x d) matrix; zero past its end
    for (int i = threadIdx.x; i < 64 * d; i += THREADS) {
        const int r = i / d, c = i % d;
        dst[r * ld + c] = row0 + r < rows ? src[(size_t)(row0 + r) * d + c]
                                          : 0.f;
    }
}

template <int NJ>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(const float *__restrict__ q, const float *__restrict__ k,
                const float *__restrict__ v, float *__restrict__ out, int BH,
                int S, int T_, int d, int group, float scale, int causal,
                int window) {
    extern __shared__ float sm[];
    const int ldq = d + 1, ldk = d + 1, ldv = d, ldp = BK + 1;
    float *Qs = sm;
    float *Ks = Qs + BQ * ldq;
    float *Vs = Ks + BK * ldk;
    float *Ps = Vs + BK * ldv;

    // the longest query tiles (latest under causal) start first
    const int n_qt = (S + BQ - 1) / BQ;
    const int qt = n_qt - 1 - (int)(blockIdx.x / BH);
    const size_t bh = blockIdx.x % BH;
    const int q0 = qt * BQ;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int off = T_ - S;
    const float *qh = q + bh * S * d;
    const float *kh = k + bh / group * T_ * d;
    const float *vh = v + bh / group * T_ * d;

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

    float *oh = out + bh * S * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
        const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
            const int c = tx + 16 * jj;
            if (c < d) oh[(size_t)row * d + c] = acc[i][jj] / denom;
        }
    }
}

// ---------------------------------------------------------------------------
// tensor-core primitives (inline PTX; tests/cuda_emu/ptx.h holds their CPU
// twins, lane by lane after the PTX ISA's fragment layouts)
// ---------------------------------------------------------------------------

#ifndef REPRO_PTX_TWINS
__device__ __forceinline__ unsigned smem_u32(const void *p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32.
// Lane l = 4 g + t holds a[0..3] = A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]; b0, b1 = B[2t..][g], B[2t+8..][g]; d = D[g][2t, 2t+1],
// D[g+8][2t, 2t+1]; the lower half of a register is the lower index.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
    // registers only, so not volatile: the compiler may interleave it
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the rows of matrix i,
// r[i] of lane l = 4 g + t holds its row g, columns 2t and 2t + 1
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void *row) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(row)));
}

// the same, each matrix transposed: r[i] holds rows 2t and 2t + 1,
// column g
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void *row) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(row)));
}

// two floats as a bf16 pair rounded to nearest even, lo in the lower half
__device__ __forceinline__ unsigned cvt_bf16x2(float lo, float hi) {
    unsigned r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// 2^x, to about 2^-22 relative (denormals flushed to zero)
__device__ __forceinline__ float ex2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are zero
__device__ __forceinline__ void cp_async16(void *dst, const void *src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
#endif

// p as hi = bf16(p) and lo = bf16(p - hi), packed in pairs
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned &hi,
                                           unsigned &lo) {
    hi = cvt_bf16x2(p0, p1);
    lo = cvt_bf16x2(p0 - __uint_as_float(hi << 16),
                    p1 - __uint_as_float(hi & 0xffff0000u));
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel and the split-KV combine
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128, TC_PAD = 8;

// The tiles of one head dim (d padded up to DP): a block of 4 warps and
// kv tiles of BK keys.  Rows: either each warp owns MT 16-row m-tiles
// (BQ = 64 MT rows), so every K and V fragment it loads feeds MT
// products, or (WK = 4) the 4 warps share one m-tile of 16 rows and each
// takes a quarter of every kv tile's keys, their states merged at the
// end: decode, where a block has a few rows and one warp alone would
// hold up the loads.  The launcher (launch_dp) takes WK = 4 where the
// rows of a kv head fit one m-tile (S group <= 16), MT = 2 where the
// accumulator leaves the registers for it (DP <= 160) and the rows fill
// such tiles (S group >= 128), else MT = 1.  BK is 32 where the
// accumulator or the tiles would not fit beside 64 (DP = 256; DP = 160
// with two m-tiles), never below 64 for WK = 4 (16 keys a warp).
template <int DP, int MT, int WK> struct Tiles {
    static_assert(WK == 1 || MT == 1, "warps share keys or own rows");
    static constexpr int BQ = WK > 1 ? 16 : 64 * MT;
    static constexpr int BK =
        WK == 1 && (DP > 160 || (DP == 160 && MT == 2)) ? 32 : 64;
    static constexpr int LD = DP + TC_PAD;          // bf16 per smem row
    // Q fragments held in registers where they take at most 32 of them
    static constexpr bool QREG = DP * MT <= 128;
    static constexpr int ROWS = 4 * BK + BQ;        // K, V twice; Q
    static constexpr size_t SMEM = (size_t)ROWS * LD * 2;
};

struct AttnArgs {
    const __nv_bfloat16 *q, *k, *v;
    __nv_bfloat16 *out;
    // split-KV partials (nsplit > 1); m in units of log2 e
    float *part_m, *part_l, *part_acc;
    int S, T, d, group, n_kvh, nsplit, causal, window, vec;
    float scale;
};

// rows [0, rows) of a tile: row i from src(i) (null: zeros), columns
// [0, d) of it, zeros up to DP.  vec: 16-byte cp.async copies (d % 8 ==
// 0 and 16-byte aligned rows; the columns [d, DP) were zeroed once; a
// zero row copies 0 bytes from base, a valid address); else element by
// element.
template <int DP, class Src>
__device__ __forceinline__ void load_rows(__nv_bfloat16 *dst, int rows,
                                          int d, int vec,
                                          const __nv_bfloat16 *base,
                                          Src src) {
    constexpr int LD = DP + TC_PAD;
    if (vec) {
        // chunk c = i per_row + j of the tile, c = threadIdx.x + 128 n
        const int per_row = d / 8;
        const int di = TC_THREADS / per_row, dj = TC_THREADS % per_row;
        for (int i = threadIdx.x / per_row, j = threadIdx.x % per_row;
             i < rows; i += di, j += dj) {
            if (j >= per_row) {
                j -= per_row;
                if (++i >= rows) break;
            }
            const __nv_bfloat16 *s = src(i);
            cp_async16(dst + i * LD + 8 * j, s ? s + 8 * j : base,
                       s ? 16 : 0);
        }
    } else {
        for (int c = threadIdx.x; c < rows * DP; c += TC_THREADS) {
            const int i = c / DP, j = c % DP;
            const __nv_bfloat16 *s = src(i);
            dst[i * LD + j] = s && j < d ? s[j] : __float2bfloat16_rn(0.f);
        }
    }
}

// One kv tile's online-softmax step on a lane's two rows h = 0, 1 (rows
// g and g + 8 of one m-tile, at query positions qp[h]): scale and mask s,
// the row max across the quad (the 4 lanes that share a row), alpha, and
// p in place of s (0 where masked) with its partial row sums.  s and m
// are kept in units of log2 e (s = dot * scale * log2 e), so that
// exp(s - m) is one ex2; the row max and every p are the reference's.
// MASK false: every key of the tile is open to every row of the warp.
template <bool MASK, int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NB][4],
                                             float (&m)[2],
                                             float (&alpha)[2],
                                             float (&sum)[2], int k0,
                                             const int (&qp)[2],
                                             const AttnArgs &a) {
    const int t = threadIdx.x % 4;
    const float scale = a.scale * LOG2E;
    unsigned ok[2] = {0u, 0u};
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kp = k0 + 8 * j + 2 * t + e;
                bool open = true;
                if constexpr (MASK)
                    open = kp < a.T && (!a.causal || kp <= qp[h]) &&
                           (a.window <= 0 || kp > qp[h] - a.window);
                float &x = s[j][2 * h + e];
                x = open ? x * scale : NEG_INF;
                ok[h] |= (unsigned)open << (2 * j + e);
                mx[h] = fmaxf(mx[h], x);
            }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = ex2_approx(fminf(m[h] - m_new, 0.f));
        m[h] = m_new;
        sum[h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float &x = s[j][2 * h + e];
                x = !MASK || (ok[h] >> (2 * j + e)) & 1u
                        ? ex2_approx(x - m[h]) : 0.f;
                sum[h] += x;
            }
}

template <int DP, int MT, int WK>
__global__ void __launch_bounds__(TC_THREADS)
attn_tc_kernel(const AttnArgs a) {
    using TL = Tiles<DP, MT, WK>;
    constexpr int BQ = TL::BQ, BKT = TL::BK, LD = TL::LD;
    constexpr int NB = BKT / 8 / WK;     // 8-key column blocks of S a warp
    constexpr int ND = DP / 8;           // 8-wide column blocks of acc
    constexpr int KD = DP / 16;          // 16-deep steps of Q K^T
    static_assert(NB % 2 == 0, "a warp takes whole 16-key steps");
    extern __shared__ __align__(16) unsigned char tc_smem[];
    __nv_bfloat16 *Ks = (__nv_bfloat16 *)tc_smem;   // two buffers
    __nv_bfloat16 *Vs = Ks + 2 * BKT * LD;            // two buffers
    __nv_bfloat16 *Qs = Vs + 2 * BKT * LD;

    const int S = a.S, T_ = a.T, d = a.d, group = a.group;
    const int R = S * group;             // packed rows of one kv head
    const int n_rt = (R + BQ - 1) / BQ;
    // the longest row tiles (latest under causal) start first
    const int kh = blockIdx.x % a.n_kvh;
    const int rest = blockIdx.x / a.n_kvh;
    const int split = rest % a.nsplit;
    const int r0 = (n_rt - 1 - rest / a.nsplit) * BQ;
    const int off = T_ - S;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const __nv_bfloat16 *kbase = a.k + (size_t)kh * T_ * d;
    const __nv_bfloat16 *vbase = a.v + (size_t)kh * T_ * d;
    // packed row r: query head kh group + r % group at position r / group
    auto q_row = [&](int r) -> size_t {
        return ((size_t)(kh * group + r % group) * S + r / group) * d;
    };

    // the kv tiles the block's rows can see, and this split's share
    const int q_lo = r0 / group + off;
    const int q_hi = (min(r0 + BQ, R) - 1) / group + off;
    const int kv_end = a.causal ? min(T_, q_hi + 1) : T_;
    const int kv_begin = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
    const int tb = kv_begin / BKT;
    const int te = kv_end > kv_begin ? (kv_end + BKT - 1) / BKT : tb;
    const int per = (te - tb + a.nsplit - 1) / a.nsplit;
    const int kt0 = tb + split * per;
    const int kt1 = min(te, kt0 + per);

    // the warp's 16 MT rows, the keys they can see, its m-tiles with
    // rows; with WK = 4 the block's 16 rows and the warp's first key of
    // each kv tile
    const int wrow = WK > 1 ? 0 : 16 * MT * warp;
    const int kw = WK > 1 ? warp * (BKT / WK) : 0;
    const int wr0 = r0 + wrow;
    const int wq_lo = wr0 / group + off;
    const int wq_hi = (min(wr0 + 16 * MT, R) - 1) / group + off;
    const int wk_end = a.causal ? min(T_, wq_hi + 1) : T_;
    const int wk_begin = a.window > 0 ? max(0, wq_lo - a.window + 1) : 0;
    bool act[MT];
    // each lane's two rows of each m-tile (g and g + 8 of its 16)
    int qp[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        act[mt] = wr0 + 16 * mt < R;
        qp[mt][0] = (wr0 + 16 * mt + g) / group + off;
        qp[mt][1] = (wr0 + 16 * mt + g + 8) / group + off;
    }

    // the padding columns [d, DP) stay zero; cp.async writes only [0, d)
    if (a.vec && DP > d)
        for (int i = threadIdx.x; i < TL::ROWS * (DP - d); i += TC_THREADS)
            Ks[(i / (DP - d)) * LD + d + i % (DP - d)] =
                __float2bfloat16_rn(0.f);

    auto load_kv = [&](int kt, int buf) {
        const int k0 = kt * BKT;
        const size_t o = (size_t)k0 * d;
        load_rows<DP>(Ks + buf * BKT * LD, BKT, d, a.vec, kbase,
                      [&](int i) -> const __nv_bfloat16 * {
                          return k0 + i < T_ ? kbase + o + (size_t)i * d
                                             : nullptr;
                      });
        load_rows<DP>(Vs + buf * BKT * LD, BKT, d, a.vec, vbase,
                      [&](int i) -> const __nv_bfloat16 * {
                          return k0 + i < T_ ? vbase + o + (size_t)i * d
                                             : nullptr;
                      });
    };

    load_rows<DP>(Qs, BQ, d, a.vec, a.q,
                  [&](int i) -> const __nv_bfloat16 * {
                      return r0 + i < R ? a.q + q_row(r0 + i) : nullptr;
                  });
    cp_async_commit();
    if (kt0 < kt1) load_kv(kt0, 0);
    cp_async_commit();
    cp_async_wait<1>();                  // Q has landed
    __syncthreads();

    // A fragments of Q: lane l reads row l % 16 of an m-tile, columns
    // 8 (l / 16) on
    const __nv_bfloat16 *q_frag = Qs + (wrow + lane % 16) * LD +
                                  (lane / 16) * 8;
    unsigned qf[TL::QREG ? MT : 1][TL::QREG ? KD : 1][4];
    if constexpr (TL::QREG) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int kc = 0; kc < KD; ++kc)
                ldmatrix_x4(qf[mt][kc], q_frag + 16 * mt * LD + kc * 16);
    }

    float o[MT][ND][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
    float m[MT][2], l[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            m[mt][h] = NEG_INF;
            l[mt][h] = 0.f;
        }

    for (int kt = kt0; kt < kt1; ++kt) {
        const int buf = (kt - kt0) & 1;
        if (kt + 1 < kt1) load_kv(kt + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();              // tile kt has landed
        __syncthreads();

        const int k0 = kt * BKT, kk0 = k0 + kw;   // the warp's keys
        if (act[0] && kk0 < wk_end && kk0 + 8 * NB > wk_begin) {
            const __nv_bfloat16 *Kb = Ks + buf * BKT * LD;
            const __nv_bfloat16 *Vb = Vs + buf * BKT * LD;
            float s[MT][NB][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int j = 0; j < NB; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
            // S = Q K^T: B fragments of two 8-key blocks per ldmatrix
            // (lane l reads key 8 (l / 16) + l % 8, columns 8 (l / 8 % 2))
            const __nv_bfloat16 *k_frag =
                Kb + (kw + (lane / 16) * 8 + lane % 8) * LD +
                ((lane / 8) % 2) * 8;
#pragma unroll
            for (int kc = 0; kc < KD; ++kc) {
                unsigned aq[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    if constexpr (TL::QREG) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) aq[mt][e] = qf[mt][kc][e];
                    } else {
                        ldmatrix_x4(aq[mt], q_frag + 16 * mt * LD + kc * 16);
                    }
                }
#pragma unroll
                for (int j = 0; j < NB; j += 2) {
                    unsigned b[4];
                    ldmatrix_x4(b, k_frag + j * 8 * LD + kc * 16);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                        if (act[mt]) {
                            mma_bf16_16816(s[mt][j], aq[mt], b[0], b[1]);
                            mma_bf16_16816(s[mt][j + 1], aq[mt], b[2], b[3]);
                        }
                }
            }

            const bool open = k0 + BKT <= T_ &&
                              (!a.causal || k0 + BKT - 1 <= wq_lo) &&
                              (a.window <= 0 || k0 > wq_hi - a.window);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                if (!act[mt]) continue;
                float alpha[2], sum[2];
                if (open)
                    softmax_tile<false>(s[mt], m[mt], alpha, sum, kk0,
                                        qp[mt], a);
                else
                    softmax_tile<true>(s[mt], m[mt], alpha, sum, kk0,
                                       qp[mt], a);
                // per-lane partial sums of l; the quad adds up at the end
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    l[mt][h] = alpha[h] * l[mt][h] + sum[h];
                // alpha is 1 where the row max held: skip the product
                if (__any_sync(0xffffffffu,
                               alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
                for (int n = 0; n < ND; ++n) {
                    o[mt][n][0] *= alpha[0];
                    o[mt][n][1] *= alpha[0];
                    o[mt][n][2] *= alpha[1];
                    o[mt][n][3] *= alpha[1];
                }
            }

            // acc += P V, P as hi and lo bf16 halves: the S accumulator of
            // key blocks 2c and 2c + 1 is the A fragment of key step c;
            // V's B fragments by ldmatrix.trans (lane l reads key
            // 16 c + 8 (l / 8 % 2) + l % 8, columns 8 (l / 16) on)
            const __nv_bfloat16 *v_frag =
                Vb + (kw + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                (lane / 16) * 8;
#pragma unroll
            for (int c = 0; c < NB / 2; ++c) {
                unsigned ph[MT][4], pl[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const float(&x)[NB][4] = s[mt];
                    split_bf16(x[2 * c][0], x[2 * c][1], ph[mt][0], pl[mt][0]);
                    split_bf16(x[2 * c][2], x[2 * c][3], ph[mt][1], pl[mt][1]);
                    split_bf16(x[2 * c + 1][0], x[2 * c + 1][1], ph[mt][2],
                               pl[mt][2]);
                    split_bf16(x[2 * c + 1][2], x[2 * c + 1][3], ph[mt][3],
                               pl[mt][3]);
                }
#pragma unroll
                for (int n = 0; n < ND; n += 2) {
                    unsigned b[4];
                    ldmatrix_x4_trans(b, v_frag + c * 16 * LD + n * 8);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                        if (act[mt]) {
                            mma_bf16_16816(o[mt][n], ph[mt], b[0], b[1]);
                            mma_bf16_16816(o[mt][n + 1], ph[mt], b[2], b[3]);
                        }
                    // lo after every hi: no product waits on the one before
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                        if (act[mt]) {
                            mma_bf16_16816(o[mt][n], pl[mt], b[0], b[1]);
                            mma_bf16_16816(o[mt][n + 1], pl[mt], b[2], b[3]);
                        }
                }
            }
        }
        __syncthreads();                 // buffer buf is free again
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
            l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
        }
    if constexpr (WK > 1) {
        // merge the warps' (m, l, acc) of the shared rows into warp 0's,
        // as the combine kernel merges chunks; the kv buffers are free
        // (the loop ends on a barrier, and no copy is in flight)
        float *red = (float *)tc_smem;               // [WK][ND][32][4]
        float *red_m = red + WK * ND * 128, *red_l = red_m + WK * 16;
        if (warp > 0) {
#pragma unroll
            for (int n = 0; n < ND; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    red[((warp * ND + n) * 32 + lane) * 4 + e] = o[0][n][e];
            if (t == 0)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    red_m[warp * 16 + g + 8 * h] = m[0][h];
                    red_l[warp * 16 + g + 8 * h] = l[0][h];
                }
        }
        __syncthreads();
        if (warp > 0) return;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = m[0][h];
            for (int w = 1; w < WK; ++w)
                mx = fmaxf(mx, red_m[w * 16 + g + 8 * h]);
            const float w0 = ex2_approx(m[0][h] - mx);
            float lw = w0 * l[0][h];
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                o[0][n][2 * h] *= w0;
                o[0][n][2 * h + 1] *= w0;
            }
            for (int w = 1; w < WK; ++w) {
                const float f = ex2_approx(red_m[w * 16 + g + 8 * h] - mx);
                lw += f * red_l[w * 16 + g + 8 * h];
#pragma unroll
                for (int n = 0; n < ND; ++n) {
                    const float *x = red + ((w * ND + n) * 32 + lane) * 4;
                    o[0][n][2 * h] += f * x[2 * h];
                    o[0][n][2 * h + 1] += f * x[2 * h + 1];
                }
            }
            m[0][h] = mx;
            l[0][h] = lw;
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = wr0 + 16 * mt + g + 8 * h;
            if (r >= R) continue;
            const float(&acc)[ND][4] = o[mt];
            if (a.nsplit == 1) {
                const float inv = 1.f / fmaxf(l[mt][h], 1e-30f);
                __nv_bfloat16 *orow = a.out + q_row(r);
#pragma unroll
                for (int n = 0; n < ND; ++n) {
                    const int c = 8 * n + 2 * t;
                    const float v0 = acc[n][2 * h] * inv;
                    const float v1 = acc[n][2 * h + 1] * inv;
                    if (a.vec) {
                        if (c < d)
                            *(unsigned *)(orow + c) = cvt_bf16x2(v0, v1);
                    } else {
                        if (c < d) orow[c] = __float2bfloat16_rn(v0);
                        if (c + 1 < d) orow[c + 1] = __float2bfloat16_rn(v1);
                    }
                }
            } else {
                const size_t pr = ((size_t)split * a.n_kvh + kh) * R + r;
                if (t == 0) {
                    a.part_m[pr] = m[mt][h];
                    a.part_l[pr] = l[mt][h];
                }
                float *prow = a.part_acc + pr * d;
#pragma unroll
                for (int n = 0; n < ND; ++n) {
                    const int c = 8 * n + 2 * t;
                    if (c < d) prow[c] = acc[n][2 * h];
                    if (c + 1 < d) prow[c + 1] = acc[n][2 * h + 1];
                }
            }
        }
}

constexpr int COMBINE_THREADS = 64;

// one block per packed row: merge the nsplit chunks' (m, l, acc)
__global__ void __launch_bounds__(COMBINE_THREADS)
attn_combine_kernel(const float *__restrict__ part_m,
                    const float *__restrict__ part_l,
                    const float *__restrict__ part_acc,
                    __nv_bfloat16 *__restrict__ out, int n_rows, int R,
                    int group, int S, int d, int nsplit) {
    const int row = blockIdx.x;
    const int kh = row / R, r = row % R;
    float m = NEG_INF;
    for (int i = 0; i < nsplit; ++i)
        m = fmaxf(m, part_m[(size_t)i * n_rows + row]);
    float l = 0.f;
    for (int i = 0; i < nsplit; ++i)
        l += ex2_approx(part_m[(size_t)i * n_rows + row] - m) *
             part_l[(size_t)i * n_rows + row];
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16 *orow =
        out + ((size_t)(kh * group + r % group) * S + r / group) * d;
    for (int c = threadIdx.x; c < d; c += COMBINE_THREADS) {
        float acc = 0.f;
        for (int i = 0; i < nsplit; ++i) {
            const size_t pr = (size_t)i * n_rows + row;
            acc += ex2_approx(part_m[pr] - m) * part_acc[pr * d + c];
        }
        orow[c] = __float2bfloat16_rn(acc * inv);
    }
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NJ>
cudaError_t launch_f32(const void *q, const void *k, const void *v,
                       void *out, int BH, int S, int T_, int d, int group,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
    const size_t smem = smem_floats(d) * sizeof(float);
    cudaError_t e = allow_smem(attn_f32_kernel<NJ>, smem);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)BH * (unsigned)((S + BQ - 1) / BQ);
    attn_f32_kernel<NJ><<<blocks, THREADS, smem, stream>>>(
        (const float *)q, (const float *)k, (const float *)v, (float *)out,
        BH, S, T_, d, group, scale, causal, window);
    return cudaGetLastError();
}

template <int DP, int MT, int WK>
cudaError_t launch_tc(const AttnArgs &a, cudaStream_t stream) {
    using TL = Tiles<DP, MT, WK>;
    cudaError_t e = allow_smem(attn_tc_kernel<DP, MT, WK>, TL::SMEM);
    if (e != cudaSuccess) return e;
    const int n_rt = (a.S * a.group + TL::BQ - 1) / TL::BQ;
    const unsigned blocks =
        (unsigned)a.n_kvh * (unsigned)a.nsplit * (unsigned)n_rt;
    attn_tc_kernel<DP, MT, WK><<<blocks, TC_THREADS, TL::SMEM, stream>>>(a);
    return cudaGetLastError();
}

// the rows of a block as Tiles states (kernel.py tc_tiles)
template <int DP>
cudaError_t launch_dp(const AttnArgs &a, cudaStream_t stream) {
    const int rows = a.S * a.group;
    if (rows <= 16) return launch_tc<DP, 1, 4>(a, stream);
    if constexpr (DP <= 160)
        if (rows >= 128) return launch_tc<DP, 2, 1>(a, stream);
    return launch_tc<DP, 1, 1>(a, stream);
}

}  // namespace

// q: (BH, S, d); k and v: (BH / group, T, d); out: (BH, S, d); one dtype
// (0 float32, 1 bfloat16); d <= 256.  bfloat16 with nsplit > 1 writes
// the partials (nsplit, BH / group, S group) of m and l and (..., d) of
// acc instead of out; attn_combine_launch then writes out.  vec: d % 8
// == 0 and every pointer 16-byte aligned (bfloat16 only).
extern "C" int attn_launch(const void *q, const void *k, const void *v,
                           void *out, void *part_m, void *part_l,
                           void *part_acc, int BH, int S, int T_, int d,
                           float scale, int causal, int window, int group,
                           int nsplit, int vec, int dtype, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (group < 1 || BH % group || nsplit < 1) return cudaErrorInvalidValue;
    if (dtype != 1) {
        if (nsplit != 1) return cudaErrorInvalidValue;
        const int nj = (d + 15) / 16;
        if (nj <= 2) return launch_f32<2>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 4) return launch_f32<4>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 8) return launch_f32<8>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 10) return launch_f32<10>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 16) return launch_f32<16>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        return cudaErrorInvalidValue;   // d > 256: the wrapper refuses it
    }
    AttnArgs a;
    a.q = (const __nv_bfloat16 *)q;
    a.k = (const __nv_bfloat16 *)k;
    a.v = (const __nv_bfloat16 *)v;
    a.out = (__nv_bfloat16 *)out;
    a.part_m = (float *)part_m;
    a.part_l = (float *)part_l;
    a.part_acc = (float *)part_acc;
    a.S = S;
    a.T = T_;
    a.d = d;
    a.group = group;
    a.n_kvh = BH / group;
    a.nsplit = nsplit;
    a.causal = causal;
    a.window = window;
    a.vec = vec;
    a.scale = scale;
    // d padded to the next of 64, 128, 160, 256 (kernel.py tc_tiles)
    if (d <= 64) return launch_dp<64>(a, s);
    if (d <= 128) return launch_dp<128>(a, s);
    if (d <= 160) return launch_dp<160>(a, s);
    if (d <= 256) return launch_dp<256>(a, s);
    return cudaErrorInvalidValue;       // the wrapper refuses it
}

// out (bfloat16) from attn_launch's partials; n_rows = BH / group * S group
extern "C" int attn_combine_launch(const void *part_m, const void *part_l,
                                   const void *part_acc, void *out,
                                   int n_rows, int S, int d, int group,
                                   int nsplit, void *stream) {
    attn_combine_kernel<<<n_rows, COMBINE_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float *)part_m, (const float *)part_l,
        (const float *)part_acc, (__nv_bfloat16 *)out, n_rows, S * group,
        group, S, d, nsplit);
    return cudaGetLastError();
}
