// CPU twins of the Hopper primitives of grouped_matmul.cu (mbarriers, the
// 3-D TMA tile load, wgmma.mma_async m64nNk16 bf16 -> f32 and its fence,
// commit and wait, setmaxnreg), which the kernel compiles only where
// REPRO_PTX_TWINS is not defined (ptx.h defines it and includes this).
//
// Shared memory is one array whose first byte is shared address 0
// (emu::smem_base, set by the caller), so the addresses in descriptors,
// and the address bits the swizzles read, are the card's.
//
// * mbarriers block for real across the std::threads: the phase flips
//   when the pending arrivals and the transaction count both reach zero;
//   try_wait.parity(p) is true once the phase of parity p has completed,
//   that is while the current phase's parity is not p.  A wait that
//   lasts longer than a minute ends the process (a deadlock in the
//   kernel under test).
// * The TMA load copies its box at once, applies the swizzle to the
//   destination address bits, zero-fills every element outside the
//   tensor and then completes the box's bytes on the barrier.
// * wgmma reads A and B through their descriptors as the PTX ISA lays
//   out the canonical layouts, K-major or MN-major (the transpose bit),
//   swizzled or not, and writes D in the ISA's accumulator layout.  It is
//   asynchronous as on the card: a product runs when wait_group retires
//   its group, reading shared memory then and writing the accumulators
//   then, so a kernel that frees a stage or reads its sums before the
//   wait sees the wrong values.  The 128 threads of the warpgroup meet at
//   one barrier to issue and check they issue the same descriptors.
#pragma once
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace emu {
inline unsigned char *smem_base = nullptr;     // shared address 0

[[noreturn]] inline void fail(const char *what) {
    std::fprintf(stderr, "hopper twin: %s\n", what);
    std::fflush(stderr);
    std::_Exit(7);
}
}  // namespace emu

inline unsigned smem_u32(const void *p) {
    return (unsigned)((const unsigned char *)p - emu::smem_base);
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

namespace emu {
struct Mbar {
    unsigned count, pending, phase;
    long long tx;
};
inline std::mutex mbar_mu;
inline std::condition_variable mbar_cv;
inline std::map<const void *, Mbar> mbars;

inline Mbar &mbar(const void *bar) {
    auto it = mbars.find(bar);
    if (it == mbars.end()) fail("mbarrier used before init");
    return it->second;
}
inline void mbar_maybe_complete(Mbar &b) {
    if (b.pending == 0 && b.tx == 0) {
        b.phase ^= 1;
        b.pending = b.count;
        mbar_cv.notify_all();
    }
}
inline void mbar_arrive_locked(Mbar &b) {
    if (b.pending == 0) fail("mbarrier arrival beyond its count");
    --b.pending;
    mbar_maybe_complete(b);
}
}  // namespace emu

inline void mbar_init(unsigned long long *bar, unsigned count) {
    std::lock_guard<std::mutex> lk(emu::mbar_mu);
    emu::mbars[bar] = emu::Mbar{count, count, 0, 0};
}
inline void mbar_fence_init() {}
inline void mbar_arrive(unsigned long long *bar) {
    std::lock_guard<std::mutex> lk(emu::mbar_mu);
    emu::mbar_arrive_locked(emu::mbar(bar));
}
inline void mbar_arrive_expect_tx(unsigned long long *bar, unsigned bytes) {
    std::lock_guard<std::mutex> lk(emu::mbar_mu);
    emu::Mbar &b = emu::mbar(bar);
    b.tx += bytes;
    emu::mbar_arrive_locked(b);
}
// what a finished copy does to the barrier it names
inline void mbar_complete_tx(unsigned long long *bar, unsigned bytes) {
    std::lock_guard<std::mutex> lk(emu::mbar_mu);
    emu::Mbar &b = emu::mbar(bar);
    b.tx -= bytes;
    emu::mbar_maybe_complete(b);
}
inline bool mbar_try_wait_parity(unsigned long long *bar, unsigned parity) {
    std::lock_guard<std::mutex> lk(emu::mbar_mu);
    return emu::mbar(bar).phase != (parity & 1);
}
inline void mbar_wait(unsigned long long *bar, unsigned parity) {
    std::unique_lock<std::mutex> lk(emu::mbar_mu);
    if (!emu::mbar_cv.wait_for(lk, std::chrono::seconds(60), [&] {
            return emu::mbar(bar).phase != (parity & 1);
        }))
        emu::fail("mbarrier wait timed out (deadlock)");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// the address bits 4 .. 4+b XORed with bits 7 .. 7+b, for a swizzle span
// of 32, 64 or 128 bytes (b = 1, 2, 3); no swizzle below 32
inline unsigned swizzle_addr(unsigned addr, unsigned span) {
    if (span < 32) return addr;
    return addr ^ (((addr >> 7) & (span / 16 - 1)) << 4);
}

inline void tma_load_3d(void *dst, const CUtensorMap *map,
                        unsigned long long *bar, int c0, int c1, int c2) {
    emu::TensorMap m;
    std::memcpy(&m, map, sizeof m);
    if (m.rank != 3) emu::fail("tma_load_3d on a map that is not 3-D");
    const unsigned a0 = smem_u32(dst);
    if (a0 % 128) emu::fail("TMA destination not 128-byte aligned");
    const long long c[3] = {c0, c1, c2};
    unsigned off = 0;
    for (unsigned i2 = 0; i2 < m.box[2]; ++i2)
        for (unsigned i1 = 0; i1 < m.box[1]; ++i1)
            for (unsigned i0 = 0; i0 < m.box[0]; ++i0, off += m.esize) {
                const long long g[3] = {c[0] + i0, c[1] + i1, c[2] + i2};
                bool in = true;
                size_t src = 0;
                for (int d = 0; d < 3; ++d) {
                    in = in && g[d] >= 0 && g[d] < (long long)m.dims[d];
                    src += (size_t)g[d] * m.strides[d];
                }
                unsigned char *to =
                    emu::smem_base + swizzle_addr(a0 + off, m.swizzle);
                if (in) std::memcpy(to, m.base + src, m.esize);
                else std::memset(to, 0, m.esize);
            }
    mbar_complete_tx(bar, off);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The fields of a shared-memory matrix descriptor: start address,
// leading and stride byte offsets (each stored >> 4 in bits 0-13, 16-29,
// 32-45), base offset (bits 49-51), layout (bits 62-63: 0 none, 1 128-,
// 2 64-, 3 32-byte swizzle).
struct SmemDesc {
    unsigned start, lbo, sbo, base_offset, span;
};
inline SmemDesc smem_desc_fields(unsigned long long d) {
    const unsigned layout = (unsigned)(d >> 62);
    return {(unsigned)(d & 0x3FFF) << 4, (unsigned)(d >> 16 & 0x3FFF) << 4,
            (unsigned)(d >> 32 & 0x3FFF) << 4, (unsigned)(d >> 49 & 7),
            layout == 1 ? 128u : layout == 2 ? 64u : layout == 3 ? 32u : 16u};
}

// The shared address of element (mn, k), k < 16, of a 16-bit operand (mn
// a row of A or a column of B), in the PTX ISA's canonical layouts; W is
// the swizzle span (16 for none), in bytes:
//   K-major, swizzled:  row mn % 8 at W bytes, groups of 8 rows at SBO;
//                       k contiguous (16 values, 32 bytes, within W);
//   K-major, none:      8 x 16-byte core matrices: row mn % 8 at 16
//                       bytes, groups of 8 rows at SBO, k % 8 contiguous,
//                       the second 8 of k at LBO;
//   MN-major, swizzled: W / 2 values of mn contiguous, the next W / 2 at
//                       LBO; row k % 8 at W bytes, groups of 8 k at SBO;
//   MN-major, none:     8 values of mn contiguous, the next 8 at SBO; row
//                       k % 8 at 16 bytes, the second 8 of k at LBO;
// then the swizzle of the span on the address bits.
inline unsigned smem_desc_addr(const SmemDesc &s, bool mn_major, int mn,
                               int k) {
    if (s.base_offset != 0) emu::fail("descriptor base offset not modelled");
    const unsigned W = s.span;
    unsigned off;
    if (!mn_major && W > 16)
        off = mn % 8 * W + mn / 8 * s.sbo + 2 * k;
    else if (!mn_major)
        off = mn % 8 * 16 + mn / 8 * s.sbo + k % 8 * 2 + k / 8 * s.lbo;
    else if (W > 16)
        off = mn % (W / 2) * 2 + mn / (W / 2) * s.lbo + k % 8 * W +
              k / 8 * s.sbo;
    else
        off = mn % 8 * 2 + mn / 8 * s.sbo + k % 8 * 16 + k / 8 * s.lbo;
    return swizzle_addr(s.start + off, W);
}

namespace emu {
struct WgmmaOp {
    float *d;
    int n;
    unsigned long long da, db;
    int scale_d, trans_b;
};
inline thread_local std::vector<WgmmaOp> wg_open;
inline thread_local std::vector<std::vector<WgmmaOp>> wg_groups;
inline unsigned long long wg_stage[1024][3];

inline void wg_barrier() { wg_bars[threadIdx.x / 128]->arrive_and_wait(); }

inline float smem_bf16(unsigned addr) {
    __nv_bfloat16 v;
    std::memcpy(&v, smem_base + addr, 2);
    return __bfloat162float(v);
}

// This thread's part of D: register i of lane 4 g + t in warp w of the
// warpgroup is row 16 w + g + 8 (i % 4 / 2), column 8 (i / 4) + 2 t + i % 2.
inline void wgmma_run(const WgmmaOp &op) {
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const SmemDesc a = smem_desc_fields(op.da), b = smem_desc_fields(op.db);
    for (int i = 0; i < op.n / 2; ++i) {
        const int row = 16 * w + g + 8 * (i % 4 / 2);
        const int col = 8 * (i / 4) + 2 * t + i % 2;
        float s = op.scale_d ? op.d[i] : 0.f;
        for (int k = 0; k < 16; ++k)
            s += smem_bf16(smem_desc_addr(a, false, row, k)) *
                 smem_bf16(smem_desc_addr(b, op.trans_b, col, k));
        op.d[i] = s;
    }
}
}  // namespace emu

inline void wgmma_fence() {}

// Issue d = A B + (scale_d ? d : 0), A 64 x 16 K-major, B 16 x N
// (MN-major when trans_b); the product runs at the wait that retires its
// group.
template <int N>
inline void wgmma_m64nNk16(float (&d)[N / 2], unsigned long long da,
                           unsigned long long db, int scale_d, int trans_b) {
    const unsigned tid = threadIdx.x, lead = tid / 128 * 128;
    emu::wg_stage[tid][0] = da;
    emu::wg_stage[tid][1] = db;
    emu::wg_stage[tid][2] = (unsigned long long)(scale_d != 0);
    emu::wg_barrier();
    for (int i = 0; i < 3; ++i)
        if (emu::wg_stage[tid][i] != emu::wg_stage[lead][i])
            emu::fail("the warpgroup issued wgmma with different operands");
    emu::wg_barrier();
    emu::wg_open.push_back({d, N, da, db, scale_d != 0, trans_b});
}

inline void wgmma_m64n256k16(float (&d)[128], unsigned long long da,
                             unsigned long long db, int scale_d) {
    wgmma_m64nNk16<256>(d, da, db, scale_d, 1);
}

inline void wgmma_commit() {
    emu::wg_groups.push_back(std::move(emu::wg_open));
    emu::wg_open.clear();
}

// retire committed groups, oldest first, until at most N are in flight;
// a product is the warpgroup's, so no thread returns before every thread
// has written its part of it (and read shared memory for it)
template <int N> inline void wgmma_wait() {
    emu::wg_barrier();
    while (emu::wg_groups.size() > (size_t)N) {
        for (const emu::WgmmaOp &op : emu::wg_groups.front())
            emu::wgmma_run(op);
        emu::wg_groups.erase(emu::wg_groups.begin());
    }
    emu::wg_barrier();
}

inline void fence_acc(float (&)[128]) {}
template <int N> inline void setmaxnreg_inc() {}
template <int N> inline void setmaxnreg_dec() {}
