// A CPU stand-in for the parts of the CUDA runtime the model kernels and
// the policy kernel use, so their kernel code builds as host C++ and runs
// on the CPU (tests/test_torch_kernels_emulated.py,
// tests/test_torch_policy_kernel_emulated.py).  Every CUDA thread of a block
// is a std::thread; __syncthreads is a barrier over the block and each
// warp shuffle or vote a write, a barrier over the warp, a read and a
// barrier.
// Blocks run one after another, so a block's shared memory can be a
// plain array.  Rounding matches the card's except where nvcc contracts
// a multiply and an add into one fma.  The tensor-map part of the driver
// API (cuda.h: CUtensorMap and cuTensorMapEncodeTiled) is here too: the
// stand-in encoder checks the driver's documented limits and keeps the
// map's fields for the TMA twin of hopper.h.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))

struct alignas(16) uint4 {
    unsigned x, y, z, w;
};
struct alignas(8) uint2 {
    unsigned x, y;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
    return {x, y, z, w};
}

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
typedef struct CUstream_st *cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

using std::max;
using std::min;

inline float __expf(float x) { return std::exp(x); }
inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
inline unsigned __float_as_uint(float f) {
    unsigned u;
    std::memcpy(&u, &f, 4);
    return u;
}

namespace emu {
inline std::barrier<> *block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars, wg_bars;
inline float lanes[1024];
inline unsigned long long lanes64[1024];

// Run fn() as every thread of every block of grid, blocks in turn; a
// barrier for the block, one for each warp and one for each warpgroup of
// 128 threads.
inline void launch(dim3 grid, int threads, const std::function<void()> &fn) {
    for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = 0; x < grid.x; ++x) {
                std::barrier<> bar(threads);
                block_bar = &bar;
                warp_bars.clear();
                wg_bars.clear();
                for (int w = 0; w < threads / 32; ++w)
                    warp_bars.emplace_back(new std::barrier<>(32));
                for (int w = 0; w < threads / 128; ++w)
                    wg_bars.emplace_back(new std::barrier<>(128));
                std::vector<std::thread> ts;
                for (int t = 0; t < threads; ++t)
                    ts.emplace_back([=, &fn] {
                        threadIdx = dim3(t);
                        blockIdx = dim3(x, y, z);
                        gridDim = grid;
                        blockDim = dim3(threads);
                        fn();
                    });
                for (auto &t : ts) t.join();
            }
}
}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }

inline void __syncwarp() {
    emu::warp_bars[threadIdx.x / 32]->arrive_and_wait();
}

inline bool __any_sync(unsigned, bool pred) {
    const unsigned t = threadIdx.x, w = t / 32;
    emu::lanes[t] = pred;
    emu::warp_bars[w]->arrive_and_wait();
    bool any = false;
    for (int l = 0; l < 32; ++l) any = any || emu::lanes[w * 32 + l] != 0.f;
    emu::warp_bars[w]->arrive_and_wait();
    return any;
}

// The integer votes and shuffles the policy kernel's scans use, as the
// PTX ISA defines them for a full warp (vote.sync.ballot.b32: bit l of
// the result is lane l's predicate; shfl.sync.idx / .bfly: the value of
// lane src, or of lane ^ mask; a 64-bit shuffle is two 32-bit ones);
// __ffs: the 1-based position of the lowest set bit, 0 for 0.
inline unsigned __ballot_sync(unsigned, bool pred) {
    const unsigned t = threadIdx.x, w = t / 32;
    emu::lanes64[t] = pred;
    emu::warp_bars[w]->arrive_and_wait();
    unsigned b = 0;
    for (int l = 0; l < 32; ++l)
        b |= (emu::lanes64[w * 32 + l] != 0 ? 1u : 0u) << l;
    emu::warp_bars[w]->arrive_and_wait();
    return b;
}

inline unsigned long long emu_shfl64(unsigned long long v, unsigned src) {
    const unsigned t = threadIdx.x, w = t / 32;
    emu::lanes64[t] = v;
    emu::warp_bars[w]->arrive_and_wait();
    const unsigned long long r = emu::lanes64[w * 32 + src % 32];
    emu::warp_bars[w]->arrive_and_wait();
    return r;
}

inline int __shfl_sync(unsigned, int v, int src) {
    return (int)emu_shfl64((unsigned)v, (unsigned)src);
}

inline unsigned long long __shfl_xor_sync(unsigned, unsigned long long v,
                                          int mask) {
    return emu_shfl64(v, (threadIdx.x % 32) ^ (unsigned)mask);
}

inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
    const unsigned t = threadIdx.x, w = t / 32;
    emu::lanes[t] = v;
    emu::warp_bars[w]->arrive_and_wait();
    const float r = emu::lanes[w * 32 + ((t % 32) ^ mask)];
    emu::warp_bars[w]->arrive_and_wait();
    return r;
}

// ---------------------------------------------------------------------------
// the tensor-map part of the driver API (cuda.h)
// ---------------------------------------------------------------------------

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
    CU_TENSOR_MAP_SWIZZLE_NONE = 0,
    CU_TENSOR_MAP_SWIZZLE_32B,
    CU_TENSOR_MAP_SWIZZLE_64B,
    CU_TENSOR_MAP_SWIZZLE_128B
};
enum CUtensorMapL2promotion {
    CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
    CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
    CU_TENSOR_MAP_L2_PROMOTION_L2_256B
};
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

// 128 opaque bytes on the card; here the fields the TMA twin reads
struct alignas(64) CUtensorMap {
    unsigned long long opaque[16];
};

namespace emu {
struct TensorMap {
    const unsigned char *base;
    unsigned rank, esize, swizzle;          // swizzle in bytes (0: none)
    unsigned long long dims[5], strides[5];  // strides in bytes, dim 0's = esize
    unsigned box[5];
};
static_assert(sizeof(TensorMap) <= sizeof(CUtensorMap), "map too large");
}  // namespace emu

// cuTensorMapEncodeTiled's contract for tiled, non-interleaved maps with
// unit element strides: a 16-byte-aligned base, dims in [1, 2^32], byte
// strides multiples of 16 below 2^40, boxes of 1-256 elements whose inner
// row is a multiple of 16 bytes and, swizzled, at most the swizzle's span.
inline CUresult cuTensorMapEncodeTiled(
    CUtensorMap *map, CUtensorMapDataType type, cuuint32_t rank, void *base,
    const cuuint64_t *dims, const cuuint64_t *strides, const cuuint32_t *box,
    const cuuint32_t *elem_strides, CUtensorMapInterleave interleave,
    CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill) {
    emu::TensorMap m{};
    m.base = (const unsigned char *)base;
    m.rank = rank;
    m.esize = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 0;
    m.swizzle = swizzle == CU_TENSOR_MAP_SWIZZLE_128B  ? 128
                : swizzle == CU_TENSOR_MAP_SWIZZLE_64B ? 64
                : swizzle == CU_TENSOR_MAP_SWIZZLE_32B ? 32
                                                       : 0;
    if (m.esize == 0 || rank < 1 || rank > 5 ||
        interleave != CU_TENSOR_MAP_INTERLEAVE_NONE ||
        (uintptr_t)base % 16 != 0)
        return CUDA_ERROR_INVALID_VALUE;
    for (unsigned i = 0; i < rank; ++i) {
        if (dims[i] == 0 || dims[i] > (1ull << 32) || box[i] == 0 ||
            box[i] > 256 || elem_strides[i] != 1)
            return CUDA_ERROR_INVALID_VALUE;
        m.dims[i] = dims[i];
        m.box[i] = box[i];
        m.strides[i] = i == 0 ? m.esize : strides[i - 1];
        if (i > 0 && (m.strides[i] % 16 != 0 || m.strides[i] >= (1ull << 40)))
            return CUDA_ERROR_INVALID_VALUE;
    }
    const unsigned row = box[0] * m.esize;
    if (row % 16 != 0 || (m.swizzle && row > m.swizzle))
        return CUDA_ERROR_INVALID_VALUE;
    std::memcpy(map, &m, sizeof m);
    return CUDA_SUCCESS;
}
