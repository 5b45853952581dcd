// Timing aids for the policy kernel (policy_kernel.cuh), built and used
// by chip_smoke.py only.
//
// bpf_empty: an empty <<<1,1>>> kernel -- launch cost with no work, the
//   floor a decision kernel is held against; bpf_empty_warp_launch
//   launches it on one warp, the block of a policy kernel whose program
//   scans a map, so the cost of the shape itself shows.
// bpf_spin: holds the stream for `ns` nanoseconds of the card's global
//   timer.  Launches queued behind it run back to back once it ends, so
//   CUDA events around them read device time and not the host's issue
//   rate.

#include <cuda_runtime.h>

__global__ void bpf_empty() {}

__global__ void bpf_spin(unsigned long long ns) {
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    do {
        __nanosleep(1000);
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    } while (t - t0 < ns);
}

extern "C" int bpf_empty_launch(void *stream) {
    bpf_empty<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" int bpf_empty_warp_launch(void *stream) {
    bpf_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" int bpf_spin_launch(void *stream, unsigned long long ns) {
    bpf_spin<<<1, 1, 0, (cudaStream_t)stream>>>(ns);
    return (int)cudaGetLastError();
}
