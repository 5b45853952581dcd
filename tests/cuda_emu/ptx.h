// CPU twins of the inline-PTX primitives of flash_attention.cu (mma.sync
// m16n8k16 bf16, ldmatrix x4 plain and transposed, cvt.rn.bf16x2.f32,
// ex2.approx.ftz.f32, cp.async), which the kernel compiles only where
// REPRO_PTX_TWINS is not defined; hopper.h, included at the end, twins
// grouped_matmul.cu's (mbarrier, TMA, wgmma).  Each twin follows the PTX ISA's
// fragment layout lane by lane, as the warp shuffles of cuda_runtime.h
// do: every lane writes its registers (or its row address) to a per-warp
// stage, the warp meets at a barrier, each lane reads its own part of the
// result, and the warp meets again before the stage is reused.  cp.async
// is a plain copy that completes at once, so its commit and wait are
// no-ops.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

#define REPRO_PTX_TWINS 1

namespace emu {
inline unsigned stage_a[1024][4], stage_b[1024][2];
inline const void *stage_row[1024];

inline void warp_barrier() { warp_bars[threadIdx.x / 32]->arrive_and_wait(); }

inline float bf16_half(unsigned reg, int k) {
    return __bfloat162float({(uint16_t)(k % 2 ? reg >> 16 : reg & 0xFFFFu)});
}
}  // namespace emu

// d += a b.  A (16 x 16): element (r, k) in lane 4 (r % 8) + (k % 8) / 2,
// register r / 8 + 2 (k / 8), half k % 2.  B (16 x 8): element (k, n) in
// lane 4 n + (k % 8) / 2, register k / 8, half k % 2.  D: lane 4 g + t
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  Sums in f32,
// in k order, after the lane's own d.
inline void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                           unsigned b0, unsigned b1) {
    const unsigned tid = threadIdx.x, base = tid / 32 * 32, lane = tid % 32;
    for (int i = 0; i < 4; ++i) emu::stage_a[tid][i] = a[i];
    emu::stage_b[tid][0] = b0;
    emu::stage_b[tid][1] = b1;
    emu::warp_barrier();
    auto A = [&](int r, int k) {
        return emu::bf16_half(
            emu::stage_a[base + 4 * (r % 8) + (k % 8) / 2][r / 8 + 2 * (k / 8)],
            k);
    };
    auto B = [&](int k, int n) {
        return emu::bf16_half(emu::stage_b[base + 4 * n + (k % 8) / 2][k / 8],
                              k);
    };
    const int g = lane / 4, t = lane % 4;
    float out[4];
    for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i / 2), n = 2 * t + i % 2;
        float s = d[i];
        for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
        out[i] = s;
    }
    emu::warp_barrier();
    for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// Lanes 8i .. 8i+7 give the rows of matrix i (8 b16 each, 16 bytes).
// Plain: r[i] of lane 4 g + t = row g, columns 2t (low half) and 2t + 1.
// Transposed: r[i] = rows 2t (low half) and 2t + 1, column g.
inline void ldmatrix_x4_any(unsigned (&r)[4], const void *row, bool trans) {
    const unsigned tid = threadIdx.x, base = tid / 32 * 32, lane = tid % 32;
    emu::stage_row[tid] = row;
    emu::warp_barrier();
    const int g = lane / 4, t = lane % 4;
    for (int i = 0; i < 4; ++i) {
        uint16_t lo, hi;
        if (trans) {
            lo = ((const uint16_t *)emu::stage_row[base + 8 * i + 2 * t])[g];
            hi = ((const uint16_t *)emu::stage_row[base + 8 * i + 2 * t + 1])[g];
        } else {
            const uint16_t *p = (const uint16_t *)emu::stage_row[base + 8 * i + g];
            lo = p[2 * t];
            hi = p[2 * t + 1];
        }
        r[i] = (unsigned)lo | ((unsigned)hi << 16);
    }
    emu::warp_barrier();
}
inline void ldmatrix_x4(unsigned (&r)[4], const void *row) {
    ldmatrix_x4_any(r, row, false);
}
inline void ldmatrix_x4_trans(unsigned (&r)[4], const void *row) {
    ldmatrix_x4_any(r, row, true);
}

// round to nearest even, lo in the lower half
inline unsigned cvt_bf16x2(float lo, float hi) {
    return (unsigned)__float2bfloat16_rn(lo).x |
           ((unsigned)__float2bfloat16_rn(hi).x << 16);
}

// 2^x (the card's is within about 2^-22 of it)
inline float ex2_approx(float x) { return std::exp2(x); }

inline void cp_async16(void *dst, const void *src, int src_bytes) {
    std::memcpy(dst, src, src_bytes);
    std::memset((char *)dst + src_bytes, 0, 16 - src_bytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

#include "hopper.h"
