// Runs one model kernel under the CPU emulation (cuda_runtime.h here).
//
//   harness rmsnorm f32|bf16 DIR T D RESIDUAL EPS
//   harness gmm     f32|bf16 DIR E C D F
//   harness flash   f32|bf16 DIR BH S T d CAUSAL WINDOW SCALE
//
// Inputs are raw arrays in DIR (x, r, scale, w, q, k, v .bin), outputs
// are written there (y, res, out .bin).  The kernels' sources are the
// kernel halves of kernels/*/csrc/*.cu, each in its own namespace
// (rms, gmm, fla), prepared by the test.
#include "cuda_bf16.h"
#include "cuda_runtime.h"

#include <cstdio>
#include <cstdlib>
#include <string>
#include <type_traits>

namespace rms { float row[65536]; }
namespace fla { float sm[60000]; }
#include "rmsnorm.inc"
#include "grouped_matmul.inc"
#include "flash_attention.inc"

static std::string dir;

template <class T> std::vector<T> rd(const char *name, size_t n) {
    std::vector<T> v(n);
    FILE *f = fopen((dir + "/" + name).c_str(), "rb");
    if (!f || fread(v.data(), sizeof(T), n, f) != n) exit(3);
    fclose(f);
    return v;
}
template <class T> void wr(const char *name, const std::vector<T> &v) {
    FILE *f = fopen((dir + "/" + name).c_str(), "wb");
    fwrite(v.data(), sizeof(T), v.size(), f);
    fclose(f);
}

template <class T> int run(char **a) {
    const std::string k = a[1];
    if (k == "rmsnorm") {
        const int T_ = atoi(a[4]), D = atoi(a[5]), res = atoi(a[6]);
        const float eps = (float)atof(a[7]);
        const size_t n = (size_t)T_ * D;
        auto x = rd<T>("x.bin", n);
        auto r = res ? rd<T>("r.bin", n) : std::vector<T>();
        auto s = rd<float>("scale.bin", D);
        std::vector<T> y(n), rs(n);
        emu::launch(dim3(T_), 256, [&] {
            rms::rmsnorm_kernel<T>(x.data(), res ? r.data() : nullptr,
                                   s.data(), y.data(), rs.data(), D, eps);
        });
        wr("y.bin", y);
        wr("res.bin", rs);
    } else if (k == "gmm") {
        const int E = atoi(a[4]), C = atoi(a[5]), D = atoi(a[6]), F = atoi(a[7]);
        auto x = rd<T>("x.bin", (size_t)E * C * D);
        auto w = rd<T>("w.bin", (size_t)E * D * F);
        std::vector<T> o((size_t)E * C * F);
        // the launcher's choice: bf16 on the WMMA kernel's 128 x 128
        // tiles, float32 on the CUDA-core kernel's 64 x 64
        if constexpr (std::is_same<T, float>::value)
            emu::launch(dim3((F + 63) / 64, (C + 63) / 64, E), 256, [&] {
                gmm::gmm_kernel(x.data(), w.data(), o.data(), C, D, F);
            });
        else
            emu::launch(dim3((F + 127) / 128, (C + 127) / 128, E), 256, [&] {
                gmm::gmm_bf16_kernel(x.data(), w.data(), o.data(), C, D, F);
            });
        wr("out.bin", o);
    } else {
        const int BH = atoi(a[4]), S = atoi(a[5]), T_ = atoi(a[6]), d = atoi(a[7]);
        const int causal = atoi(a[8]), window = atoi(a[9]);
        const float scale = (float)atof(a[10]);
        auto q = rd<T>("q.bin", (size_t)BH * S * d);
        auto kk = rd<T>("k.bin", (size_t)BH * T_ * d);
        auto v = rd<T>("v.bin", (size_t)BH * T_ * d);
        std::vector<T> o((size_t)BH * S * d);
        const unsigned blocks = BH * ((S + 63) / 64);
        auto go = [&](auto nj) {
            constexpr int NJ = decltype(nj)::value;
            emu::launch(dim3(blocks), 256, [&] {
                fla::attn_kernel<T, NJ>(q.data(), kk.data(), v.data(),
                                        o.data(), S, T_, d, scale, causal,
                                        window);
            });
        };
        const int nj = (d + 15) / 16;      // the launcher's choice
        if (nj <= 2) go(std::integral_constant<int, 2>());
        else if (nj <= 4) go(std::integral_constant<int, 4>());
        else if (nj <= 8) go(std::integral_constant<int, 8>());
        else if (nj <= 10) go(std::integral_constant<int, 10>());
        else go(std::integral_constant<int, 16>());
        wr("out.bin", o);
    }
    return 0;
}

int main(int argc, char **argv) {
    if (argc < 4) return 2;
    dir = argv[3];
    return std::string(argv[2]) == "bf16" ? run<__nv_bfloat16>(argv)
                                          : run<float>(argv);
}
