// MoE grouped matmul, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul/kernel.py:39
// (grouped_matmul_tpu, body _gmm_kernel at :22-36): per expert e,
// out[e] = x[e] (C, D) @ w[e] (D, F), accumulated in f32 across D and
// cast to the output dtype once.
//
// What bounds it on the card: operations (2*E*C*D*F, far above the
// bytes of x, w and out at the MoE shapes).  Every kernel walks D
// innermost, as _gmm_kernel walks its D grid axis, keeps f32 sums and
// casts once; edges are masked or zero-filled, so any C, D and F work
// (the wrapper checks the reference's tiling contract).  Three kernels,
// one launch per call, the route chosen by kernel.py gmm_plan:
//
// bfloat16 where TMA can describe the operands (D % 8 == F % 8 == 0 and
// both base pointers 16-byte aligned), gmm_wgmma_kernel: Hopper's
// warpgroup products fed by the Tensor Memory Accelerator.
//   * A persistent grid of one block per SM walks the (E, C/128, F/256)
//     output tiles, C fastest, then F, then E: the blocks in flight share
//     an expert and a strip of w, so a weight tile loaded for one
//     128-row tile of C is read from L2 by the other C tiles.  At
//     olmoe-1b-7b (E 64, C 640, F 1024) that is 1280 tiles, 9.70 waves of
//     132: the last wave holds 92 tiles, so the call lasts 10 tile times
//     where 9.70 would do, 3.1% lost; llama4-scout (E 16, C 640, F 8192)
//     has 2560 tiles, 19.39 waves, 3.1% lost the same way.
//   * 384 threads: warpgroup 0 produces, and one thread of it issues
//     every copy; warpgroups 1 and 2 consume, each owning 64 rows of the
//     128 x 256 tile in 128 f32 accumulators a thread.  setmaxnreg gives
//     the producer's registers to the consumers (40 and 232 a thread).
//   * A ring of 4 stages in dynamic shared memory, 48 KiB each: x as a
//     128 x 64 box of a 3-D tensor map (D, C, E) and w as four 64 x 64
//     boxes of a 3-D map (F, D, E), all with the 128-byte swizzle.  The
//     maps are 3-D so that a box never reads past its expert: past C, D
//     or F the copy is zero-filled (a 2-D map over (E*D, F) would put
//     the next expert's rows into the K tail of a tile).  Each stage has
//     a full mbarrier (one arrival with expect_tx of the stage's 48 KiB,
//     then the copies' bytes) and an empty one (one arrival from each of
//     the 8 consumer warps); the phases flip each time the ring wraps,
//     across tile boundaries.
//   * Each stage is four wgmma.mma_async.m64n256k16.f32.bf16.bf16 a
//     warpgroup: A K-major (the 128-byte swizzled rows of x, the start
//     address moved 32 bytes a k-step), B MN-major through the transpose
//     bit (w's rows of F are contiguous; leading byte offset 8 KiB
//     between the 64-column boxes, stride byte offset 1 KiB between
//     groups of 8 rows of D, the start moved 2 KiB a k-step).  One group
//     stays in flight: stage s is committed, then wait_group 1 retires
//     stage s - 1 and frees its slot, so the tensor cores never wait for
//     the release, and the epilogue of one tile overlaps the producer's
//     copies for the next.
//   * The epilogue rounds each f32 sum to bf16 once and stores pairs
//     (bf16x2) straight from the accumulator layout: thread 4 g + t of
//     warp w holds rows 16 w + g and + 8, columns 8 j + 2 t and + 1,
//     masked at the C and F edges.
//
// bfloat16 otherwise, gmm_bf16_kernel: on the tensor cores through WMMA
// (mma.sync, 16 x 16 x 16 bf16 with f32 accumulators: a product of two
// bf16 values is exact in f32).  Grid (F tiles, C tiles, E) of 128 x 128
// output tiles; 8 warps as 4 x 2, each a 32 x 64 tile of 2 x 4
// accumulator fragments; D in steps of 32, the tiles loaded 16 bytes a
// thread where rows and alignment allow, not pipelined.
//
// float32, gmm_kernel: on the CUDA cores, because float32 must stay
// float32 (no TF32; the reference's tolerance is 2e-5).  Grid (F tiles,
// C tiles, E); 256 threads own a 64 x 64 output tile in registers (4 x 4
// a thread, rows ty + 16 i, columns tx + 16 j, so shared-memory reads
// are conflict-free and stores coalesced), D in steps of 16.

#include <cuda.h>
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
    // 16-byte loads need 8-element rows of a 16-byte-aligned tensor (the
    // tensors are contiguous, but a view may start anywhere)
    const bool vec_x = D % 8 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
    const bool vec_w = F % 8 == 0 && reinterpret_cast<size_t>(w) % 16 == 0;
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

// ---------------------------------------------------------------------------
// Hopper primitives (inline PTX; tests/cuda_emu/hopper.h holds their CPU
// twins, after the PTX ISA)
// ---------------------------------------------------------------------------

#ifndef REPRO_PTX_TWINS
__device__ __forceinline__ unsigned smem_u32(const void *p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// an mbarrier expecting `count` arrivals a phase; the init is made
// visible to the block's other threads (and the async proxy) by the fence
__device__ __forceinline__ void mbar_init(unsigned long long *bar,
                                          unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long *bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}
// one arrival that also adds `bytes` to the transactions the phase waits
// for (the copies' complete_tx count them down)
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long *bar,
                                                      unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long *bar,
                                          unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// the box of `map` at (c0, c1, c2), innermost first, into shared memory
// at dst; its bytes complete a transaction of bar's phase
__device__ __forceinline__ void tma_load_3d(void *dst, const CUtensorMap *map,
                                            unsigned long long *bar, int c0,
                                            int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<size_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across a wgmma fence or wait (they are not operands of those)
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC8(i)                                                          \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
        "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256, f32) = A (64 x 16) B (16 x 256) + (scale_d ? d : 0) for the
// warpgroup, A and B bf16 in shared memory through their descriptors, A
// K-major, B MN-major (the transpose bit); d in the accumulator layout
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 unsigned long long da,
                                                 unsigned long long db,
                                                 int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40),
          ACC8(48), ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88),
          ACC8(96), ACC8(104), ACC8(112), ACC8(120)
        : "l"(da), "l"(db), "r"(scale_d));
}
#undef ACC8

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
#endif

// ---------------------------------------------------------------------------
// bfloat16 on wgmma, fed by TMA
// ---------------------------------------------------------------------------

constexpr int GM = 128, GN = 256, GK = 64, STAGES = 4;
constexpr int WG = 128, GTHREADS = 3 * WG;
constexpr int SW = 64;                          // bf16 in a 128-byte row
constexpr int A_BYTES = GM * GK * 2;            // 16 KiB
constexpr int B_BOX = GK * SW * 2;              // 8 KiB: 64 of D x 64 of F
constexpr int STAGE_BYTES = A_BYTES + GN / SW * B_BOX;     // 48 KiB
// the ring, its barriers, and room to align the ring to 1 KiB (the
// 128-byte swizzle's period, which TMA and wgmma both apply to address
// bits 4-9)
constexpr int GMM_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

// The box, stride and swizzle arithmetic of both tensor maps, for the
// launcher (the driver's cuTensorMapEncodeTiled) and the CPU harness (its
// stand-in): a contiguous bf16 (E, rows, cols) operand as a 3-D map
// (cols, rows, E), innermost first, with byte strides of a row and an
// expert, read in boxes of 64 columns (one 128-byte swizzled row) x
// box_rows rows x 1 expert, zero-filled out of bounds.
template <class Encode>
CUresult encode_map(Encode encode, CUtensorMap *map, const void *base, int E,
                    int rows, int cols, int box_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                                (cuuint64_t)E};
    const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                   (cuuint64_t)rows * cols * 2};
    const cuuint32_t box[3] = {(cuuint32_t)SW, (cuuint32_t)box_rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void *>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units
// (bits 0-13, 16-29, 32-45), layout 1 in bits 62-63.
__device__ __forceinline__ unsigned long long smem_desc(const void *p,
                                                        unsigned lbo,
                                                        unsigned sbo) {
    return (unsigned long long)((smem_u32(p) & 0x3FFFF) >> 4) |
           (unsigned long long)((lbo & 0x3FFFF) >> 4) << 16 |
           (unsigned long long)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__global__ void __launch_bounds__(GTHREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 __nv_bfloat16 *__restrict__ out, int E, int C, int D,
                 int F) {
    extern __shared__ __align__(1024) unsigned char gmm_smem[];
    unsigned char *ring =
        gmm_smem + ((1024 - (smem_u32(gmm_smem) & 1023)) & 1023);
    unsigned long long *full =
        reinterpret_cast<unsigned long long *>(ring + STAGES * STAGE_BYTES);
    unsigned long long *empty = full + STAGES;
    const int tm = (C + GM - 1) / GM, tn = (F + GN - 1) / GN;
    const int nk = (D + GK - 1) / GK, tiles = E * tm * tn;
    const int wg = threadIdx.x / WG;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 2 * WG / 32);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        // the producer: one thread keeps the ring full
        setmaxnreg_dec<40>();
        if (threadIdx.x == 0) {
            int s = 0;
            unsigned phase = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int m0 = t % tm * GM, n0 = t / tm % tn * GN;
                const int e = t / (tm * tn);
                for (int kb = 0; kb < nk; ++kb) {
                    // the slot's previous contents consumed (the first
                    // pass waits on the phase before the first: done)
                    mbar_wait(&empty[s], phase ^ 1);
                    unsigned char *a = ring + s * STAGE_BYTES;
                    mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
                    tma_load_3d(a, &map_x, &full[s], kb * GK, m0, e);
#pragma unroll
                    for (int j = 0; j < GN / SW; ++j)
                        tma_load_3d(a + A_BYTES + j * B_BOX, &map_w, &full[s],
                                    n0 + j * SW, kb * GK, e);
                    if (++s == STAGES) {
                        s = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // the consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63
        setmaxnreg_inc<232>();
        const int cw = wg - 1, warp = threadIdx.x % WG / 32;
        const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
        float acc[128];
        int s = 0;
        unsigned phase = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = t % tm * GM, n0 = t / tm % tn * GN;
            const int e = t / (tm * tn);
            int prev = 0;
            for (int kb = 0; kb < nk; ++kb) {
                mbar_wait(&full[s], phase);
                const unsigned char *a = ring + s * STAGE_BYTES + cw * 64 * 128;
                const unsigned char *b = ring + s * STAGE_BYTES + A_BYTES;
                fence_acc(acc);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < GK / 16; ++kk)
                    wgmma_m64n256k16(acc, smem_desc(a + kk * 32, 16, 1024),
                                     smem_desc(b + kk * 16 * 128, B_BOX, 1024),
                                     kb > 0 || kk > 0);
                wgmma_commit();
                // the previous stage's products are done: free its slot
                wgmma_wait<1>();
                if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
                prev = s;
                if (++s == STAGES) {
                    s = 0;
                    phase ^= 1;
                }
            }
            wgmma_wait<0>();
            fence_acc(acc);
            if (lane == 0) mbar_arrive(&empty[prev]);

            // the f32 sums, rounded once, as bf16 pairs
            __nv_bfloat16 *oe = out + (size_t)e * C * F;
            const int r0 = m0 + cw * 64 + warp * 16 + g;
#pragma unroll
            for (int j = 0; j < GN / 8; ++j) {
                const int col = n0 + 8 * j + 2 * q;
                if (col >= F) continue;     // F is even: col + 1 < F too
                if (r0 < C)
                    *reinterpret_cast<__nv_bfloat162 *>(
                        oe + (size_t)r0 * F + col) =
                        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
                if (r0 + 8 < C)
                    *reinterpret_cast<__nv_bfloat162 *>(
                        oe + (size_t)(r0 + 8) * F + col) =
                        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
            }
        }
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// the host half
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library is built without -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap *, CUtensorMapDataType,
                                cuuint32_t, void *, const cuuint64_t *,
                                const cuuint64_t *, const cuuint32_t *,
                                const cuuint32_t *, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void *p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

static cudaError_t launch_f32(const void *x, const void *w, void *out, int E,
                              int C, int D, int F, cudaStream_t stream) {
    const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
    gmm_kernel<<<grid, THREADS, 0, stream>>>(
        (const float *)x, (const float *)w, (float *)out, C, D, F);
    return cudaGetLastError();
}

static cudaError_t launch_wmma(const void *x, const void *w, void *out, int E,
                               int C, int D, int F, cudaStream_t stream) {
    const dim3 grid((F + TBN - 1) / TBN, (C + TBM - 1) / TBM, E);
    gmm_bf16_kernel<<<grid, THREADS, 0, stream>>>(
        (const __nv_bfloat16 *)x, (const __nv_bfloat16 *)w,
        (__nv_bfloat16 *)out, C, D, F);
    return cudaGetLastError();
}

static cudaError_t launch_wgmma(const void *x, const void *w, void *out,
                                int E, int C, int D, int F, int blocks,
                                cudaStream_t stream) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    CUtensorMap map_x, map_w;
    if (encode_map(encode, &map_x, x, E, C, D, GM) != CUDA_SUCCESS ||
        encode_map(encode, &map_w, w, E, D, F, GK) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        GMM_SMEM);
    if (err != cudaSuccess) return err;
    gmm_wgmma_kernel<<<blocks, GTHREADS, GMM_SMEM, stream>>>(
        map_x, map_w, (__nv_bfloat16 *)out, E, C, D, F);
    return cudaGetLastError();
}

// x: (E, C, D), w: (E, D, F), out: (E, C, F), one dtype.  route (kernel.py
// GMM_ROUTES): 0 float32 on the CUDA cores, 1 bfloat16 on WMMA, 2
// bfloat16 on wgmma fed by TMA, as a persistent grid of `blocks` blocks.
extern "C" int gmm_launch(const void *x, const void *w, void *out, int E,
                          int C, int D, int F, int route, int blocks,
                          void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (route) {
    case 0: return (int)launch_f32(x, w, out, E, C, D, F, s);
    case 1: return (int)launch_wmma(x, w, out, E, C, D, F, s);
    case 2: return (int)launch_wgmma(x, w, out, E, C, D, F, blocks, s);
    default: return (int)cudaErrorInvalidValue;
    }
}
