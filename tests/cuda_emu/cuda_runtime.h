// A CPU stand-in for the parts of the CUDA runtime the model kernels use,
// so their kernel code builds as host C++ and runs on the CPU
// (tests/test_torch_kernels_emulated.py).  Every CUDA thread of a block
// is a std::thread; __syncthreads is a barrier over the block and each
// warp shuffle or vote a write, a barrier over the warp, a read and a
// barrier.
// Blocks run one after another, so a block's shared memory can be a
// plain array.  Rounding matches the card's except where nvcc contracts
// a multiply and an add into one fma.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
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
#define __launch_bounds__(n)
#define __align__(n) __attribute__((aligned(n)))

struct alignas(16) uint4 {
    unsigned x, y, z, w;
};

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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

namespace emu {
inline std::barrier<> *block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline float lanes[1024];

// Run fn() as every thread of every block of grid, blocks in turn.
inline void launch(dim3 grid, int threads, const std::function<void()> &fn) {
    for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = 0; x < grid.x; ++x) {
                std::barrier<> bar(threads);
                block_bar = &bar;
                warp_bars.clear();
                for (int w = 0; w < threads / 32; ++w)
                    warp_bars.emplace_back(new std::barrier<>(32));
                std::vector<std::thread> ts;
                for (int t = 0; t < threads; ++t)
                    ts.emplace_back([=, &fn] {
                        threadIdx = dim3(t);
                        blockIdx = dim3(x, y, z);
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

inline float __shfl_xor_sync(unsigned, float v, int mask) {
    const unsigned t = threadIdx.x, w = t / 32;
    emu::lanes[t] = v;
    emu::warp_bars[w]->arrive_and_wait();
    const float r = emu::lanes[w * 32 + ((t % 32) ^ mask)];
    emu::warp_bars[w]->arrive_and_wait();
    return r;
}
