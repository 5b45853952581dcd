// Flash attention (causal / sliding window), hand-written for Hopper
// (sm_90a): the forward, and for bfloat16 a backward.
//
// The forward replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:79 (flash_attention_tpu,
// body _attn_kernel at :30-76).  q: (BH, S, d) with query head b H + h at
// row block b H + h; k: (BH / group, T, d) and v: (BH / group, T, dv),
// the kv heads of the reference's jnp.repeat order, so query head qh
// reads kv head qh / group.  Nothing is expanded: each k and v row is
// read from device memory for its own kv head only.  v has its own width
// (latent attention: q and k 192 wide, v 128).
//
// What bounds it on the card: operations at prefill (2 (d + dv) per
// query-key pair the masks leave open), bytes at decode (S = 1: every k
// and v row read once for a few query rows).  The Pallas kernel walks kv
// tiles as sequential grid steps and carries m, l and acc in VMEM
// scratch; Hopper's blocks run in no order, so here one block owns a tile
// of 64 or 128 query rows and loops over the kv tiles the masks leave
// open, with m, l and acc in registers.  A kv tile that a row cannot see
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
//     ldmatrix phase reads fall on distinct banks; q and k are padded
//     with zeros up to DP (64, 128, 160 or 256, or 192 beside a DV of
//     128: with_widths), v up to DV (DP, or 128 beside 192);
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
//   * where the wrapper passes an lse buffer (the training forward),
//     each row's log-sum-exp m + log(l) in f32, natural units, for the
//     backward; without one nothing else changes;
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
//
// The backward (bfloat16: attn_bwd_dq_kernel, then attn_bwd_dkv_kernel)
// replaces nothing in the JAX package: the TPU kernel has no backward,
// and the reference's models train through plain attention.  It was
// added so that training runs attention through B5 and never writes the
// S x S logits, which plain attention holds in f32 for every layer
// (2.15 GB a layer at B 2 x H 16 x S 4096) and walks three times more
// in its backward.  Inputs q, k, v, o, dO and the forward's lse; outputs
// dQ, dK, dV in bfloat16.  What bounds it: the operations the masks
// leave open, 2 (6 d + 4 dv) a pair over the two passes (S and dP
// twice; dS K, dS^T Q and P^T dO as hi and lo halves), some 3.5 to 4
// times the forward's.  Its design:
//   * P = exp(s scale - lse) is recomputed from the forward's lse in
//     f32 (one ex2 in units of log2 e), never stored; dP = dO V^T in
//     f32, D = rowsum(dO o) in f32, dS = P (dP - D) in f32;
//   * no float atomics, so a run repeats its bits: pass 1, one block a
//     row tile as the forward's (packed rows, 4 warps of 16 rows),
//     writes D and accumulates dQ = scale dS K over the kv tiles its
//     rows see; pass 2, one block a 64-key kv tile (4 warps of 16 keys,
//     CS blocks a tile where the widths would not fit the registers,
//     each owning a share of dK's and dV's columns), walks the row tiles
//     that see its keys, the group's query heads packed as in the
//     forward, and accumulates dV = P^T dO and dK = scale dS^T Q: a kv
//     head's dK and dV gather every query head of its group inside one
//     block, with nothing expanded;
//   * precision: bf16 q, k, v and dO enter the tensor cores with f32
//     accumulation; P and dS enter P^T dO, dS K and dS^T Q as hi and lo
//     bf16 halves, about 16 bits, as the forward's P V (plain attention
//     rounds P once to bf16 and multiplies f32 dS); no TF32, no fp8;
//   * the tiles the causal and window masks close are skipped, as in
//     the forward; q/k, v and dO tiles come by cp.async,
//     double-buffered (pass 1 the kv tiles, pass 2 the row tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// The tiles of one pair of widths (q and k padded up to DP, v up to DV):
// a block of 4 warps and kv tiles of BK keys.  Rows: either each warp
// owns MT 16-row m-tiles (BQ = 64 MT rows), so every K and V fragment it
// loads feeds MT
// products, or (WK = 4) the 4 warps share one m-tile of 16 rows and each
// takes a quarter of every kv tile's keys, their states merged at the
// end: decode, where a block has a few rows and one warp alone would
// hold up the loads.  The launcher (launch_dp) takes WK = 4 where the
// rows of a kv head fit one m-tile (S group <= 16), MT = 2 where the
// accumulator leaves the registers for it (DP <= 160, so DV <= 160) and
// the rows fill such tiles (S group >= 128), else MT = 1.  BK is 32 where
// the accumulator or the tiles would not fit beside 64 (DV > 160; DV =
// 160 with two m-tiles), never below 64 for WK = 4 (16 keys a warp).
template <int DP, int DV, int MT, int WK> struct Tiles {
    static_assert(WK == 1 || MT == 1, "warps share keys or own rows");
    static constexpr int BQ = WK > 1 ? 16 : 64 * MT;
    static constexpr int BK =
        WK == 1 && (DV > 160 || (DV == 160 && MT == 2)) ? 32 : 64;
    // bf16 per smem row of K and Q, and of V
    static constexpr int LDK = DP + TC_PAD, LDV = DV + TC_PAD;
    // Q fragments held in registers where they take at most 32 of them
    static constexpr bool QREG = DP * MT <= 128;
    // K and V twice, Q
    static constexpr size_t SMEM =
        (size_t)(2 * BK * LDK + 2 * BK * LDV + BQ * LDK) * 2;
};

struct AttnArgs {
    const __nv_bfloat16 *q, *k, *v;
    __nv_bfloat16 *out;
    // split-KV partials (nsplit > 1); m in units of log2 e
    float *part_m, *part_l, *part_acc;
    float *lse;                 // each row's log-sum-exp, or null
    int S, T, d, dv, group, n_kvh, nsplit, causal, window, vec;
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

// columns [c0, DP) of rows [0, rows) of a tile with rows of LD bf16: zero
template <int DP>
__device__ __forceinline__ void zero_cols(__nv_bfloat16 *base, int rows,
                                          int c0) {
    constexpr int LD = DP + TC_PAD;
    const int w = DP - c0;
    if (w <= 0) return;
    for (int i = threadIdx.x; i < rows * w; i += TC_THREADS)
        base[(i / w) * LD + c0 + i % w] = __float2bfloat16_rn(0.f);
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

template <int DP, int DV, int MT, int WK>
__global__ void __launch_bounds__(TC_THREADS)
attn_tc_kernel(const AttnArgs a) {
    using TL = Tiles<DP, DV, MT, WK>;
    constexpr int BQ = TL::BQ, BKT = TL::BK, LD = TL::LDK, LDV = TL::LDV;
    constexpr int NB = BKT / 8 / WK;     // 8-key column blocks of S a warp
    constexpr int ND = DV / 8;           // 8-wide column blocks of acc
    constexpr int KD = DP / 16;          // 16-deep steps of Q K^T
    static_assert(NB % 2 == 0, "a warp takes whole 16-key steps");
    extern __shared__ __align__(16) unsigned char tc_smem[];
    __nv_bfloat16 *Ks = (__nv_bfloat16 *)tc_smem;   // two buffers
    __nv_bfloat16 *Vs = Ks + 2 * BKT * LD;            // two buffers
    __nv_bfloat16 *Qs = Vs + 2 * BKT * LDV;

    const int S = a.S, T_ = a.T, d = a.d, dv = a.dv, group = a.group;
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
    const __nv_bfloat16 *vbase = a.v + (size_t)kh * T_ * dv;
    // packed row r: query head kh group + r % group at position r / group
    auto row_of = [&](int r) -> size_t {
        return (size_t)(kh * group + r % group) * S + r / group;
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

    // the padding columns stay zero; cp.async writes only [0, d) and
    // [0, dv)
    if (a.vec) {
        zero_cols<DP>(Ks, 2 * BKT, d);
        zero_cols<DV>(Vs, 2 * BKT, dv);
        zero_cols<DP>(Qs, BQ, d);
    }

    auto load_kv = [&](int kt, int buf) {
        const int k0 = kt * BKT;
        load_rows<DP>(Ks + buf * BKT * LD, BKT, d, a.vec, kbase,
                      [&](int i) -> const __nv_bfloat16 * {
                          return k0 + i < T_ ? kbase + (size_t)(k0 + i) * d
                                             : nullptr;
                      });
        load_rows<DV>(Vs + buf * BKT * LDV, BKT, dv, a.vec, vbase,
                      [&](int i) -> const __nv_bfloat16 * {
                          return k0 + i < T_ ? vbase + (size_t)(k0 + i) * dv
                                             : nullptr;
                      });
    };

    load_rows<DP>(Qs, BQ, d, a.vec, a.q,
                  [&](int i) -> const __nv_bfloat16 * {
                      return r0 + i < R ? a.q + row_of(r0 + i) * d
                                        : nullptr;
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
            const __nv_bfloat16 *Vb = Vs + buf * BKT * LDV;
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
                Vb + (kw + ((lane / 8) % 2) * 8 + lane % 8) * LDV +
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
                    ldmatrix_x4_trans(b, v_frag + c * 16 * LDV + n * 8);
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
                const float lf = fmaxf(l[mt][h], 1e-30f);
                const float inv = 1.f / lf;
                __nv_bfloat16 *orow = a.out + row_of(r) * dv;
#pragma unroll
                for (int n = 0; n < ND; ++n) {
                    const int c = 8 * n + 2 * t;
                    const float v0 = acc[n][2 * h] * inv;
                    const float v1 = acc[n][2 * h + 1] * inv;
                    if (a.vec) {
                        if (c < dv)
                            *(unsigned *)(orow + c) = cvt_bf16x2(v0, v1);
                    } else {
                        if (c < dv) orow[c] = __float2bfloat16_rn(v0);
                        if (c + 1 < dv)
                            orow[c + 1] = __float2bfloat16_rn(v1);
                    }
                }
                if (a.lse && t == 0)
                    a.lse[row_of(r)] = (m[mt][h] + log2f(lf)) * LN2;
            } else {
                const size_t pr = ((size_t)split * a.n_kvh + kh) * R + r;
                if (t == 0) {
                    a.part_m[pr] = m[mt][h];
                    a.part_l[pr] = l[mt][h];
                }
                float *prow = a.part_acc + pr * dv;
#pragma unroll
                for (int n = 0; n < ND; ++n) {
                    const int c = 8 * n + 2 * t;
                    if (c < dv) prow[c] = acc[n][2 * h];
                    if (c + 1 < dv) prow[c + 1] = acc[n][2 * h + 1];
                }
            }
        }
}

constexpr int COMBINE_THREADS = 64;

// one block per packed row: merge the nsplit chunks' (m, l, acc); d is
// v's width
__global__ void __launch_bounds__(COMBINE_THREADS)
attn_combine_kernel(const float *__restrict__ part_m,
                    const float *__restrict__ part_l,
                    const float *__restrict__ part_acc,
                    __nv_bfloat16 *__restrict__ out, float *__restrict__ lse,
                    int n_rows, int R, int group, int S, int d, int nsplit) {
    const int row = blockIdx.x;
    const int kh = row / R, r = row % R;
    float m = NEG_INF;
    for (int i = 0; i < nsplit; ++i)
        m = fmaxf(m, part_m[(size_t)i * n_rows + row]);
    float l = 0.f;
    for (int i = 0; i < nsplit; ++i)
        l += ex2_approx(part_m[(size_t)i * n_rows + row] - m) *
             part_l[(size_t)i * n_rows + row];
    const float lf = fmaxf(l, 1e-30f);
    const float inv = 1.f / lf;
    const size_t orow_i = (size_t)(kh * group + r % group) * S + r / group;
    __nv_bfloat16 *orow = out + orow_i * d;
    if (lse && threadIdx.x == 0) lse[orow_i] = (m + log2f(lf)) * LN2;
    for (int c = threadIdx.x; c < d; c += COMBINE_THREADS) {
        float acc = 0.f;
        for (int i = 0; i < nsplit; ++i) {
            const size_t pr = (size_t)i * n_rows + row;
            acc += ex2_approx(part_m[pr] - m) * part_acc[pr * d + c];
        }
        orow[c] = __float2bfloat16_rn(acc * inv);
    }
}

// ---------------------------------------------------------------------------
// bfloat16: the backward, two passes and no atomics
// ---------------------------------------------------------------------------

// The tiles of one pair of widths.  Pass 1 (dQ): 4 warps of 16 packed
// rows, kv tiles of BK keys (32 where the widths would crowd the
// registers and keep one block an SM).  Pass 2 (dK, dV): 4 warps of 16
// keys of a 64-key kv tile, row tiles of BR packed rows; where dK's and
// dV's accumulators together would pass 160 registers a thread
// (DP + DV > 320), CS = 2 blocks share a kv tile, each accumulating
// half of dK's and of dV's columns.
template <int DP, int DV> struct BwdTiles {
    static constexpr int LDK = DP + TC_PAD, LDV = DV + TC_PAD;
    static constexpr int BQ = 64;
    static constexpr int BK = DP + DV > 256 ? 32 : 64;
    // K and V twice, Q, dO
    static constexpr size_t SMEM_DQ =
        (size_t)(2 * BK * LDK + 2 * BK * LDV + BQ * LDK + BQ * LDV) * 2;
    static constexpr int BKV = 64;
    static constexpr int BR = DP + DV > 256 ? 32 : 64;
    static constexpr int CS = DP + DV > 320 ? 2 : 1;
    // K, V, Q and dO twice, lse and D twice
    static constexpr size_t SMEM_DKV =
        (size_t)(BKV * LDK + BKV * LDV + 2 * BR * LDK + 2 * BR * LDV) * 2 +
        4 * BR * sizeof(float);
};

struct BwdArgs {
    const __nv_bfloat16 *q, *k, *v, *o, *dout;
    const float *lse;           // the forward's, natural units
    float *delta;               // D = rowsum(dO o): pass 1 writes it
    __nv_bfloat16 *gq, *gk, *gv;
    int S, T, d, dv, group, n_kvh, causal, window, vec;
    float scale;
};

// One kv tile's dS on a lane's two rows h (g and g + 8 of the warp's 16,
// query positions qp[h]): p = 2^(s scale log2 e - lse log2 e), 0 where
// masked, and dS = p (dP - D) in place of s.
template <bool MASK, int NB>
__device__ __forceinline__ void ds_rows(float (&s)[NB][4],
                                        const float (&dp)[NB][4],
                                        const float (&l2)[2],
                                        const float (&D)[2], int k0,
                                        const int (&qp)[2], float scale2,
                                        const BwdArgs &a) {
    const int t = threadIdx.x % 4;
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
                const float p = open ? ex2_approx(x * scale2 - l2[h]) : 0.f;
                x = p * (dp[j][2 * h + e] - D[h]);
            }
}

template <int DP, int DV>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_dq_kernel(const BwdArgs a) {
    using TL = BwdTiles<DP, DV>;
    constexpr int BQ = TL::BQ, BK = TL::BK, LDK = TL::LDK, LDV = TL::LDV;
    constexpr int NB = BK / 8;           // 8-key column blocks of S a warp
    constexpr int KD = DP / 16;          // 16-deep steps of Q K^T
    constexpr int KE = DV / 16;          // 16-deep steps of dO V^T
    constexpr int NQ = DP / 8;           // 8-wide column blocks of dQ
    extern __shared__ __align__(16) unsigned char tc_smem[];
    __nv_bfloat16 *Ks = (__nv_bfloat16 *)tc_smem;   // two buffers
    __nv_bfloat16 *Vs = Ks + 2 * BK * LDK;            // two buffers
    __nv_bfloat16 *Qs = Vs + 2 * BK * LDV;
    __nv_bfloat16 *Os = Qs + BQ * LDK;                // dO

    const int S = a.S, T_ = a.T, d = a.d, dv = a.dv, group = a.group;
    const int R = S * group;
    const int n_rt = (R + BQ - 1) / BQ;
    // the longest row tiles (latest under causal) start first
    const int kh = blockIdx.x % a.n_kvh;
    const int r0 = (n_rt - 1 - (int)(blockIdx.x / a.n_kvh)) * BQ;
    const int off = T_ - S;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const __nv_bfloat16 *kbase = a.k + (size_t)kh * T_ * d;
    const __nv_bfloat16 *vbase = a.v + (size_t)kh * T_ * dv;
    auto row_of = [&](int r) -> size_t {
        return (size_t)(kh * group + r % group) * S + r / group;
    };

    const int q_lo = r0 / group + off;
    const int q_hi = (min(r0 + BQ, R) - 1) / group + off;
    const int kv_end = a.causal ? min(T_, q_hi + 1) : T_;
    const int kv_begin = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
    const int kt0 = kv_begin / BK;
    const int kt1 = kv_end > kv_begin ? (kv_end + BK - 1) / BK : kt0;

    const int wr0 = r0 + 16 * warp;
    const bool act = wr0 < R;
    const int wq_lo = wr0 / group + off;
    const int wq_hi = (min(wr0 + 16, R) - 1) / group + off;
    const int wk_end = a.causal ? min(T_, wq_hi + 1) : T_;
    const int wk_begin = a.window > 0 ? max(0, wq_lo - a.window + 1) : 0;
    const int qp[2] = {(wr0 + g) / group + off, (wr0 + g + 8) / group + off};

    if (a.vec) {
        zero_cols<DP>(Ks, 2 * BK, d);
        zero_cols<DV>(Vs, 2 * BK, dv);
        zero_cols<DP>(Qs, BQ, d);
        zero_cols<DV>(Os, BQ, dv);
    }
    auto load_kv = [&](int kt, int buf) {
        const int k0 = kt * BK;
        load_rows<DP>(Ks + buf * BK * LDK, BK, d, a.vec, kbase,
                      [&](int i) -> const __nv_bfloat16 * {
                          return k0 + i < T_ ? kbase + (size_t)(k0 + i) * d
                                             : nullptr;
                      });
        load_rows<DV>(Vs + buf * BK * LDV, BK, dv, a.vec, vbase,
                      [&](int i) -> const __nv_bfloat16 * {
                          return k0 + i < T_ ? vbase + (size_t)(k0 + i) * dv
                                             : nullptr;
                      });
    };
    load_rows<DP>(Qs, BQ, d, a.vec, a.q,
                  [&](int i) -> const __nv_bfloat16 * {
                      return r0 + i < R ? a.q + row_of(r0 + i) * d
                                        : nullptr;
                  });
    load_rows<DV>(Os, BQ, dv, a.vec, a.dout,
                  [&](int i) -> const __nv_bfloat16 * {
                      return r0 + i < R ? a.dout + row_of(r0 + i) * dv
                                        : nullptr;
                  });
    cp_async_commit();
    if (kt0 < kt1) load_kv(kt0, 0);
    cp_async_commit();

    // D = rowsum(dO o) of the warp's rows in f32, written for pass 2;
    // each lane keeps its rows g and g + 8, and their lse in units of
    // log2 e (rows past R: 0, so their p and dS stay finite)
    float D[2] = {0.f, 0.f}, l2[2] = {0.f, 0.f};
    for (int i = 0; i < 16 && wr0 + i < R; ++i) {
        const size_t row = row_of(wr0 + i);
        const __nv_bfloat16 *orow = a.o + row * dv;
        const __nv_bfloat16 *grow = a.dout + row * dv;
        float x = 0.f;
        for (int c = lane; c < dv; c += 32)
            x += __bfloat162float(orow[c]) * __bfloat162float(grow[c]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
        if (i == g) D[0] = x;
        if (i == g + 8) D[1] = x;
        if (lane == 0) a.delta[row] = x;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
        if (wr0 + g + 8 * h < R)
            l2[h] = a.lse[row_of(wr0 + g + 8 * h)] * LOG2E;
    const float scale2 = a.scale * LOG2E;

    float acc[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int kt = kt0; kt < kt1; ++kt) {
        const int buf = (kt - kt0) & 1;
        if (kt + 1 < kt1) load_kv(kt + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();              // tile kt (and Q, dO) landed
        __syncthreads();

        const int k0 = kt * BK;
        if (act && k0 < wk_end && k0 + BK > wk_begin) {
            const __nv_bfloat16 *Kb = Ks + buf * BK * LDK;
            const __nv_bfloat16 *Vb = Vs + buf * BK * LDV;
            float s[NB][4], dp[NB][4];
#pragma unroll
            for (int j = 0; j < NB; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            // S = Q K^T and dP = dO V^T: A fragments of the warp's rows
            // (lane l reads row l % 16, columns 8 (l / 16) on), B
            // fragments of two 8-key blocks per ldmatrix (lane l reads
            // key 8 (l / 16) + l % 8, columns 8 (l / 8 % 2) on)
            const __nv_bfloat16 *q_frag =
                Qs + (16 * warp + lane % 16) * LDK + (lane / 16) * 8;
            const __nv_bfloat16 *k_frag =
                Kb + ((lane / 16) * 8 + lane % 8) * LDK + ((lane / 8) % 2) * 8;
#pragma unroll
            for (int kc = 0; kc < KD; ++kc) {
                unsigned aq[4];
                ldmatrix_x4(aq, q_frag + kc * 16);
#pragma unroll
                for (int j = 0; j < NB; j += 2) {
                    unsigned b[4];
                    ldmatrix_x4(b, k_frag + j * 8 * LDK + kc * 16);
                    mma_bf16_16816(s[j], aq, b[0], b[1]);
                    mma_bf16_16816(s[j + 1], aq, b[2], b[3]);
                }
            }
            const __nv_bfloat16 *o_frag =
                Os + (16 * warp + lane % 16) * LDV + (lane / 16) * 8;
            const __nv_bfloat16 *v_frag =
                Vb + ((lane / 16) * 8 + lane % 8) * LDV + ((lane / 8) % 2) * 8;
#pragma unroll
            for (int kc = 0; kc < KE; ++kc) {
                unsigned ao[4];
                ldmatrix_x4(ao, o_frag + kc * 16);
#pragma unroll
                for (int j = 0; j < NB; j += 2) {
                    unsigned b[4];
                    ldmatrix_x4(b, v_frag + j * 8 * LDV + kc * 16);
                    mma_bf16_16816(dp[j], ao, b[0], b[1]);
                    mma_bf16_16816(dp[j + 1], ao, b[2], b[3]);
                }
            }
            const bool open = k0 + BK <= T_ &&
                              (!a.causal || k0 + BK - 1 <= wq_lo) &&
                              (a.window <= 0 || k0 > wq_hi - a.window);
            if (open)
                ds_rows<false>(s, dp, l2, D, k0, qp, scale2, a);
            else
                ds_rows<true>(s, dp, l2, D, k0, qp, scale2, a);

            // dQ += dS K, dS as hi and lo bf16 halves (the accumulator
            // of key blocks 2c and 2c + 1 is the A fragment of key step
            // c); K's B fragments by ldmatrix.trans (lane l reads key
            // 16 c + 8 (l / 8 % 2) + l % 8, columns 8 (l / 16) on)
            const __nv_bfloat16 *kt_frag =
                Kb + (((lane / 8) % 2) * 8 + lane % 8) * LDK + (lane / 16) * 8;
#pragma unroll
            for (int c = 0; c < NB / 2; ++c) {
                unsigned hi[4], lo[4];
                split_bf16(s[2 * c][0], s[2 * c][1], hi[0], lo[0]);
                split_bf16(s[2 * c][2], s[2 * c][3], hi[1], lo[1]);
                split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], hi[2], lo[2]);
                split_bf16(s[2 * c + 1][2], s[2 * c + 1][3], hi[3], lo[3]);
#pragma unroll
                for (int n = 0; n < NQ; n += 2) {
                    unsigned b[4];
                    ldmatrix_x4_trans(b, kt_frag + c * 16 * LDK + n * 8);
                    mma_bf16_16816(acc[n], hi, b[0], b[1]);
                    mma_bf16_16816(acc[n + 1], hi, b[2], b[3]);
                    mma_bf16_16816(acc[n], lo, b[0], b[1]);
                    mma_bf16_16816(acc[n + 1], lo, b[2], b[3]);
                }
            }
        }
        __syncthreads();                 // buffer buf is free again
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = wr0 + g + 8 * h;
        if (r >= R) continue;
        __nv_bfloat16 *row = a.gq + row_of(r) * d;
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
            const int c = 8 * n + 2 * t;
            const float v0 = acc[n][2 * h] * a.scale;
            const float v1 = acc[n][2 * h + 1] * a.scale;
            if (a.vec) {
                if (c < d) *(unsigned *)(row + c) = cvt_bf16x2(v0, v1);
            } else {
                if (c < d) row[c] = __float2bfloat16_rn(v0);
                if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(v1);
            }
        }
    }
}

// One row tile's P^T and dS^T on a lane's two keys h (g and g + 8 of the
// warp's 16, positions kp[h]) and its columns 8 j + 2 t + e of the tile
// (packed rows r0 + ..., lse in units of log2 e and D from shared
// memory): P^T in place of s, dS^T in place of dp.
template <bool MASK, int NR>
__device__ __forceinline__ void ds_keys(float (&s)[NR][4],
                                        float (&dp)[NR][4],
                                        const float *l2, const float *D,
                                        int r0, int R, const int (&kp)[2],
                                        float scale2, const BwdArgs &a) {
    const int t = threadIdx.x % 4;
    const int off = a.T - a.S;
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            int qpos = 0;
            if constexpr (MASK) qpos = (r0 + col) / a.group + off;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                bool open = true;
                if constexpr (MASK)
                    open = r0 + col < R && kp[h] < a.T &&
                           (!a.causal || kp[h] <= qpos) &&
                           (a.window <= 0 || kp[h] > qpos - a.window);
                float &x = s[j][2 * h + e];
                x = open ? ex2_approx(x * scale2 - l2[col]) : 0.f;
                float &y = dp[j][2 * h + e];
                y = x * (y - D[col]);
            }
        }
}

template <int DP, int DV>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_dkv_kernel(const BwdArgs a) {
    using TL = BwdTiles<DP, DV>;
    constexpr int BKV = TL::BKV, BR = TL::BR, CS = TL::CS;
    constexpr int LDK = TL::LDK, LDV = TL::LDV;
    constexpr int NR = BR / 8;           // 8-row column blocks of S^T a warp
    constexpr int KD = DP / 16, KE = DV / 16;
    // 8-wide column blocks of dK and of dV a block accumulates
    constexpr int NK = DP / 8 / CS, NV = DV / 8 / CS;
    static_assert(NR % 2 == 0 && NK % 2 == 0 && NV % 2 == 0,
                  "whole 16-wide steps");
    extern __shared__ __align__(16) unsigned char tc_smem[];
    __nv_bfloat16 *Ks = (__nv_bfloat16 *)tc_smem;
    __nv_bfloat16 *Vs = Ks + BKV * LDK;
    __nv_bfloat16 *Qs = Vs + BKV * LDV;               // two buffers
    __nv_bfloat16 *Os = Qs + 2 * BR * LDK;            // dO, two buffers
    float *Ls = (float *)(Os + 2 * BR * LDV);         // lse log2 e, two
    float *Ds = Ls + 2 * BR;                          // D, two

    const int S = a.S, T_ = a.T, d = a.d, dv = a.dv, group = a.group;
    const int R = S * group;
    const int off = T_ - S;
    // kv tile 0 (seen by the most rows under causal) first
    const int kh = blockIdx.x % a.n_kvh;
    const int rest = blockIdx.x / a.n_kvh;
    const int cs = rest % CS;
    const int k0 = rest / CS * BKV;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw0 = k0 + 16 * warp;      // the warp's first key
    const int kp[2] = {kw0 + g, kw0 + g + 8};
    const int kw1 = min(kw0 + 15, T_ - 1);
    auto row_of = [&](int r) -> size_t {
        return (size_t)(kh * group + r % group) * S + r / group;
    };

    // the packed rows that see a key of the tile
    const int k_last = min(k0 + BKV, T_) - 1;
    const int r_lo = a.causal ? max(0, (k0 - off) * group) : 0;
    const int r_hi = a.window > 0
                         ? min(R, max(0, (k_last + a.window - off) * group))
                         : R;
    const int rt0 = r_lo / BR;
    const int rt1 = r_hi > r_lo ? (r_hi + BR - 1) / BR : rt0;

    if (a.vec) {
        zero_cols<DP>(Ks, BKV, d);
        zero_cols<DV>(Vs, BKV, dv);
        zero_cols<DP>(Qs, 2 * BR, d);
        zero_cols<DV>(Os, 2 * BR, dv);
    }
    const __nv_bfloat16 *kbase = a.k + ((size_t)kh * T_ + k0) * d;
    const __nv_bfloat16 *vbase = a.v + ((size_t)kh * T_ + k0) * dv;
    load_rows<DP>(Ks, BKV, d, a.vec, kbase,
                  [&](int i) -> const __nv_bfloat16 * {
                      return k0 + i < T_ ? kbase + (size_t)i * d : nullptr;
                  });
    load_rows<DV>(Vs, BKV, dv, a.vec, vbase,
                  [&](int i) -> const __nv_bfloat16 * {
                      return k0 + i < T_ ? vbase + (size_t)i * dv : nullptr;
                  });
    auto load_rt = [&](int rt, int buf) {
        const int rr0 = rt * BR;
        load_rows<DP>(Qs + buf * BR * LDK, BR, d, a.vec, a.q,
                      [&](int i) -> const __nv_bfloat16 * {
                          return rr0 + i < R ? a.q + row_of(rr0 + i) * d
                                             : nullptr;
                      });
        load_rows<DV>(Os + buf * BR * LDV, BR, dv, a.vec, a.dout,
                      [&](int i) -> const __nv_bfloat16 * {
                          return rr0 + i < R ? a.dout + row_of(rr0 + i) * dv
                                             : nullptr;
                      });
        for (int i = threadIdx.x; i < BR; i += TC_THREADS) {
            const bool in = rr0 + i < R;
            const size_t row = in ? row_of(rr0 + i) : 0;
            Ls[buf * BR + i] = in ? a.lse[row] * LOG2E : 0.f;
            Ds[buf * BR + i] = in ? a.delta[row] : 0.f;
        }
    };
    cp_async_commit();
    if (rt0 < rt1) load_rt(rt0, 0);
    cp_async_commit();

    const float scale2 = a.scale * LOG2E;
    float gk[NK][4], gv[NV][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gk[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[n][e] = 0.f;
    // A fragments of the warp's 16 keys (lane l reads key l % 16,
    // columns 8 (l / 16) on)
    const __nv_bfloat16 *k_frag =
        Ks + (16 * warp + lane % 16) * LDK + (lane / 16) * 8;
    const __nv_bfloat16 *v_frag =
        Vs + (16 * warp + lane % 16) * LDV + (lane / 16) * 8;

    for (int rt = rt0; rt < rt1; ++rt) {
        const int buf = (rt - rt0) & 1;
        if (rt + 1 < rt1) load_rt(rt + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();              // row tile rt (and K, V) landed
        __syncthreads();

        const int rr0 = rt * BR;
        const int tq_lo = rr0 / group + off;
        const int tq_hi = (min(rr0 + BR, R) - 1) / group + off;
        if (kw0 < T_ && (!a.causal || kw0 <= tq_hi) &&
            (a.window <= 0 || kw1 > tq_lo - a.window)) {
            const __nv_bfloat16 *Qb = Qs + buf * BR * LDK;
            const __nv_bfloat16 *Ob = Os + buf * BR * LDV;
            float s[NR][4], dp[NR][4];
#pragma unroll
            for (int j = 0; j < NR; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            // S^T = K Q^T and dP^T = V dO^T: B fragments of two 8-row
            // blocks per ldmatrix (lane l reads row 8 (l / 16) + l % 8,
            // columns 8 (l / 8 % 2) on)
            const __nv_bfloat16 *q_frag =
                Qb + ((lane / 16) * 8 + lane % 8) * LDK + ((lane / 8) % 2) * 8;
#pragma unroll
            for (int kc = 0; kc < KD; ++kc) {
                unsigned ak[4];
                ldmatrix_x4(ak, k_frag + kc * 16);
#pragma unroll
                for (int j = 0; j < NR; j += 2) {
                    unsigned b[4];
                    ldmatrix_x4(b, q_frag + j * 8 * LDK + kc * 16);
                    mma_bf16_16816(s[j], ak, b[0], b[1]);
                    mma_bf16_16816(s[j + 1], ak, b[2], b[3]);
                }
            }
            const __nv_bfloat16 *o_frag =
                Ob + ((lane / 16) * 8 + lane % 8) * LDV + ((lane / 8) % 2) * 8;
#pragma unroll
            for (int kc = 0; kc < KE; ++kc) {
                unsigned av[4];
                ldmatrix_x4(av, v_frag + kc * 16);
#pragma unroll
                for (int j = 0; j < NR; j += 2) {
                    unsigned b[4];
                    ldmatrix_x4(b, o_frag + j * 8 * LDV + kc * 16);
                    mma_bf16_16816(dp[j], av, b[0], b[1]);
                    mma_bf16_16816(dp[j + 1], av, b[2], b[3]);
                }
            }
            const bool open = rr0 + BR <= R && kw0 + 15 < T_ &&
                              (!a.causal || kw0 + 15 <= tq_lo) &&
                              (a.window <= 0 || kw0 > tq_hi - a.window);
            if (open)
                ds_keys<false>(s, dp, Ls + buf * BR, Ds + buf * BR, rr0, R,
                               kp, scale2, a);
            else
                ds_keys<true>(s, dp, Ls + buf * BR, Ds + buf * BR, rr0, R,
                              kp, scale2, a);

            // dV += P^T dO and dK += dS^T Q, P^T and dS^T as hi and lo
            // bf16 halves: the accumulator of row blocks 2c and 2c + 1 is
            // the A fragment of row step c; dO's and Q's B
            // fragments by ldmatrix.trans (lane l reads row 16 c + 8 (l /
            // 8 % 2) + l % 8, columns 8 (l / 16) on), this block's share
            // of the columns
            const __nv_bfloat16 *ot_frag =
                Ob + (((lane / 8) % 2) * 8 + lane % 8) * LDV +
                (lane / 16) * 8 + cs * 8 * NV;
            const __nv_bfloat16 *qt_frag =
                Qb + (((lane / 8) % 2) * 8 + lane % 8) * LDK +
                (lane / 16) * 8 + cs * 8 * NK;
#pragma unroll
            for (int c = 0; c < NR / 2; ++c) {
                unsigned hi[4], lo[4];
                split_bf16(s[2 * c][0], s[2 * c][1], hi[0], lo[0]);
                split_bf16(s[2 * c][2], s[2 * c][3], hi[1], lo[1]);
                split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], hi[2], lo[2]);
                split_bf16(s[2 * c + 1][2], s[2 * c + 1][3], hi[3], lo[3]);
#pragma unroll
                for (int n = 0; n < NV; n += 2) {
                    unsigned b[4];
                    ldmatrix_x4_trans(b, ot_frag + c * 16 * LDV + n * 8);
                    mma_bf16_16816(gv[n], hi, b[0], b[1]);
                    mma_bf16_16816(gv[n + 1], hi, b[2], b[3]);
                    mma_bf16_16816(gv[n], lo, b[0], b[1]);
                    mma_bf16_16816(gv[n + 1], lo, b[2], b[3]);
                }
                split_bf16(dp[2 * c][0], dp[2 * c][1], hi[0], lo[0]);
                split_bf16(dp[2 * c][2], dp[2 * c][3], hi[1], lo[1]);
                split_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1], hi[2], lo[2]);
                split_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3], hi[3], lo[3]);
#pragma unroll
                for (int n = 0; n < NK; n += 2) {
                    unsigned b[4];
                    ldmatrix_x4_trans(b, qt_frag + c * 16 * LDK + n * 8);
                    mma_bf16_16816(gk[n], hi, b[0], b[1]);
                    mma_bf16_16816(gk[n + 1], hi, b[2], b[3]);
                    mma_bf16_16816(gk[n], lo, b[0], b[1]);
                    mma_bf16_16816(gk[n + 1], lo, b[2], b[3]);
                }
            }
        }
        __syncthreads();                 // buffer buf is free again
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int key = kp[h];
        if (key >= T_) continue;
        __nv_bfloat16 *krow = a.gk + ((size_t)kh * T_ + key) * d;
        __nv_bfloat16 *vrow = a.gv + ((size_t)kh * T_ + key) * dv;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
            const int c = cs * 8 * NK + 8 * n + 2 * t;
            const float v0 = gk[n][2 * h] * a.scale;
            const float v1 = gk[n][2 * h + 1] * a.scale;
            if (a.vec) {
                if (c < d) *(unsigned *)(krow + c) = cvt_bf16x2(v0, v1);
            } else {
                if (c < d) krow[c] = __float2bfloat16_rn(v0);
                if (c + 1 < d) krow[c + 1] = __float2bfloat16_rn(v1);
            }
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
            const int c = cs * 8 * NV + 8 * n + 2 * t;
            const float v0 = gv[n][2 * h], v1 = gv[n][2 * h + 1];
            if (a.vec) {
                if (c < dv) *(unsigned *)(vrow + c) = cvt_bf16x2(v0, v1);
            } else {
                if (c < dv) vrow[c] = __float2bfloat16_rn(v0);
                if (c + 1 < dv) vrow[c + 1] = __float2bfloat16_rn(v1);
            }
        }
    }
}

// The launchers' widths (kernel.py tc_widths), the ones the configs
// take: q/k and v both at the smallest of 64, 128, 160, 256 that holds
// the wider, except latent attention's q/k of 161-192 beside v of
// 65-128, which runs at 192 / 128.
template <int N> struct Width {
    static constexpr int value = N;
};
template <class F> cudaError_t with_widths(int d, int dv, F f) {
    if (d > 160 && d <= 192 && dv > 64 && dv <= 128)
        return f(Width<192>(), Width<128>());
    const int w = d > dv ? d : dv;
    if (w <= 64) return f(Width<64>(), Width<64>());
    if (w <= 128) return f(Width<128>(), Width<128>());
    if (w <= 160) return f(Width<160>(), Width<160>());
    return f(Width<256>(), Width<256>());
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

template <int DP, int DV, int MT, int WK>
cudaError_t launch_tc(const AttnArgs &a, cudaStream_t stream) {
    using TL = Tiles<DP, DV, MT, WK>;
    cudaError_t e = allow_smem(attn_tc_kernel<DP, DV, MT, WK>, TL::SMEM);
    if (e != cudaSuccess) return e;
    const int n_rt = (a.S * a.group + TL::BQ - 1) / TL::BQ;
    const unsigned blocks =
        (unsigned)a.n_kvh * (unsigned)a.nsplit * (unsigned)n_rt;
    attn_tc_kernel<DP, DV, MT, WK>
        <<<blocks, TC_THREADS, TL::SMEM, stream>>>(a);
    return cudaGetLastError();
}

// the rows of a block as Tiles states (kernel.py tc_tiles)
template <int DP, int DV>
cudaError_t launch_dp(const AttnArgs &a, cudaStream_t stream) {
    const int rows = a.S * a.group;
    if (rows <= 16) return launch_tc<DP, DV, 1, 4>(a, stream);
    if constexpr (DP <= 160)
        if (rows >= 128) return launch_tc<DP, DV, 2, 1>(a, stream);
    return launch_tc<DP, DV, 1, 1>(a, stream);
}

template <int DP, int DV>
cudaError_t launch_bwd(const BwdArgs &a, int pass, cudaStream_t stream) {
    using TL = BwdTiles<DP, DV>;
    if (pass == 0) {
        cudaError_t e = allow_smem(attn_bwd_dq_kernel<DP, DV>, TL::SMEM_DQ);
        if (e != cudaSuccess) return e;
        const int n_rt = (a.S * a.group + TL::BQ - 1) / TL::BQ;
        attn_bwd_dq_kernel<DP, DV>
            <<<(unsigned)a.n_kvh * (unsigned)n_rt, TC_THREADS, TL::SMEM_DQ,
               stream>>>(a);
    } else {
        cudaError_t e =
            allow_smem(attn_bwd_dkv_kernel<DP, DV>, TL::SMEM_DKV);
        if (e != cudaSuccess) return e;
        const int n_kt = (a.T + TL::BKV - 1) / TL::BKV;
        attn_bwd_dkv_kernel<DP, DV>
            <<<(unsigned)a.n_kvh * (unsigned)n_kt * TL::CS, TC_THREADS,
               TL::SMEM_DKV, stream>>>(a);
    }
    return cudaGetLastError();
}

}  // namespace

// q: (BH, S, d); k: (BH / group, T, d), v: (BH / group, T, dv); out:
// (BH, S, dv); one dtype (0 float32, 1 bfloat16); d, dv <= 256, dv == d
// for float32.  bfloat16 with nsplit > 1 writes the partials (nsplit,
// BH / group, S group) of m and l and (..., dv) of acc instead of out;
// attn_combine_launch then writes out.  lse (bfloat16 only; may be
// null): (BH, S) f32, each row's log-sum-exp.  vec: d % 8 == dv % 8 == 0
// and every pointer 16-byte aligned (bfloat16 only).
extern "C" int attn_launch(const void *q, const void *k, const void *v,
                           void *out, void *part_m, void *part_l,
                           void *part_acc, void *lse, int BH, int S, int T_,
                           int d, int dv, float scale, int causal,
                           int window, int group, int nsplit, int vec,
                           int dtype, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (group < 1 || BH % group || nsplit < 1) return cudaErrorInvalidValue;
    if (dtype != 1) {
        if (nsplit != 1 || dv != d || lse) return cudaErrorInvalidValue;
        const int nj = (d + 15) / 16;
        if (nj <= 2) return launch_f32<2>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 4) return launch_f32<4>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 8) return launch_f32<8>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 10) return launch_f32<10>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        if (nj <= 16) return launch_f32<16>(q, k, v, out, BH, S, T_, d, group, scale, causal, window, s);
        return cudaErrorInvalidValue;   // d > 256: the wrapper refuses it
    }
    if (d > 256 || dv > 256) return cudaErrorInvalidValue;
    AttnArgs a;
    a.q = (const __nv_bfloat16 *)q;
    a.k = (const __nv_bfloat16 *)k;
    a.v = (const __nv_bfloat16 *)v;
    a.out = (__nv_bfloat16 *)out;
    a.part_m = (float *)part_m;
    a.part_l = (float *)part_l;
    a.part_acc = (float *)part_acc;
    a.lse = (float *)lse;
    a.S = S;
    a.T = T_;
    a.d = d;
    a.dv = dv;
    a.group = group;
    a.n_kvh = BH / group;
    a.nsplit = nsplit;
    a.causal = causal;
    a.window = window;
    a.vec = vec;
    a.scale = scale;
    return with_widths(d, dv, [&](auto dp, auto dvp) {
        return launch_dp<decltype(dp)::value, decltype(dvp)::value>(a, s);
    });
}

// out (bfloat16) from attn_launch's partials; n_rows = BH / group * S
// group, d v's width; lse as attn_launch's
extern "C" int attn_combine_launch(const void *part_m, const void *part_l,
                                   const void *part_acc, void *out,
                                   void *lse, int n_rows, int S, int d,
                                   int group, int nsplit, void *stream) {
    attn_combine_kernel<<<n_rows, COMBINE_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float *)part_m, (const float *)part_l,
        (const float *)part_acc, (__nv_bfloat16 *)out, (float *)lse, n_rows,
        S * group, group, S, d, nsplit);
    return cudaGetLastError();
}

static int bwd_launch(int pass, const void *q, const void *k, const void *v,
                      const void *o, const void *dout, const void *lse,
                      void *delta, void *gq, void *gk, void *gv, int BH,
                      int S, int T_, int d, int dv, float scale, int causal,
                      int window, int group, int vec, void *stream) {
    if (group < 1 || BH % group || d > 256 || dv > 256)
        return cudaErrorInvalidValue;
    BwdArgs a;
    a.q = (const __nv_bfloat16 *)q;
    a.k = (const __nv_bfloat16 *)k;
    a.v = (const __nv_bfloat16 *)v;
    a.o = (const __nv_bfloat16 *)o;
    a.dout = (const __nv_bfloat16 *)dout;
    a.lse = (const float *)lse;
    a.delta = (float *)delta;
    a.gq = (__nv_bfloat16 *)gq;
    a.gk = (__nv_bfloat16 *)gk;
    a.gv = (__nv_bfloat16 *)gv;
    a.S = S;
    a.T = T_;
    a.d = d;
    a.dv = dv;
    a.group = group;
    a.n_kvh = BH / group;
    a.causal = causal;
    a.window = window;
    a.vec = vec;
    a.scale = scale;
    return with_widths(d, dv, [&](auto dp, auto dvp) {
        return launch_bwd<decltype(dp)::value, decltype(dvp)::value>(
            a, pass, (cudaStream_t)stream);
    });
}

// The backward, bfloat16: q, gq (BH, S, d); k, gk (BH / group, T, d); v,
// gv (BH / group, T, dv); o, dout (BH, S, dv); lse, delta (BH, S) f32.
// Pass 1 writes gq and delta (D = rowsum(dout o)); pass 2 reads delta
// and writes gk and gv.  vec as attn_launch's.
extern "C" int attn_bwd_dq_launch(const void *q, const void *k,
                                  const void *v, const void *o,
                                  const void *dout, const void *lse,
                                  void *delta, void *gq, void *gk, void *gv,
                                  int BH, int S, int T_, int d, int dv,
                                  float scale, int causal, int window,
                                  int group, int vec, void *stream) {
    return bwd_launch(0, q, k, v, o, dout, lse, delta, gq, gk, gv, BH, S, T_,
                      d, dv, scale, causal, window, group, vec, stream);
}

extern "C" int attn_bwd_dkv_launch(const void *q, const void *k,
                                   const void *v, const void *o,
                                   const void *dout, const void *lse,
                                   void *delta, void *gq, void *gk, void *gv,
                                   int BH, int S, int T_, int d, int dv,
                                   float scale, int causal, int window,
                                   int group, int vec, void *stream) {
    return bwd_launch(1, q, k, v, o, dout, lse, delta, gq, gk, gv, BH, S, T_,
                      d, dv, scale, causal, window, group, vec, stream);
}
