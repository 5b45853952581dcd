// Runs one model kernel, or one PTX twin, under the CPU emulation
// (cuda_runtime.h and ptx.h here).
//
//   harness rmsnorm f32|bf16|f16 DIR T D RESIDUAL EPS RDTYPE ROUTE WARPS NV
//           BLOCKS OFFSET
//   harness gmm     f32|bf16 DIR E C D F ROUTE BLOCKS
//   harness flash   f32|bf16 DIR BH S T d DV CAUSAL WINDOW SCALE GROUP NSPLIT VEC
//                   LSE
//   harness flash_bwd bf16 DIR BH S T d DV CAUSAL WINDOW SCALE GROUP VEC
//   harness ptx     mma|ldmatrix|ldmatrix_trans|cvt|ex2|cp_async DIR
//   harness ptx     wgmma|tma|mbarrier DIR
//
// Inputs are raw arrays in DIR (x, r, scale, w, q, k, v, a, b, c, m,
// rows, smem, desc, args, g .bin), outputs are written there (y, res,
// out, d, regs, log .bin).  rmsnorm reads x in its dtype and r in
// RDTYPE (f32|bf16|f16) and writes y, and with RESIDUAL res, in x's
// dtype; it runs the kernel of ROUTE (kernel.py RMS_ROUTES: 0 vector,
// 1 smem) with WARPS warps a row and NV units a thread on
// BLOCKS blocks, x, r, y and res OFFSET elements into their buffers.  gmm runs the kernel of ROUTE (kernel.py
// GMM_ROUTES: 0 the CUDA-core kernel, 1 WMMA, 2 wgmma fed by TMA, as a
// persistent grid of BLOCKS blocks).
// The kernels' sources are the kernel halves of kernels/*/csrc/*.cu,
// each in its own namespace (rms, gmm, fla), prepared by the test.
// flash runs the launcher's kernel for the dtype: float32 the CUDA-core
// kernel, bfloat16 the tensor-core kernel (with NSPLIT > 1 its split-KV
// form and then the combine kernel), v DV wide, and with LSE it writes
// lse.bin too.  flash_bwd runs the backward's two passes on q, k, v, o,
// do and lse and writes dq, dk, dv and delta.
#include "cuda_bf16.h"
#include "cuda_fp16.h"
#include "cuda_runtime.h"
#include "ptx.h"

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <type_traits>

namespace rms { float row[65536]; }
namespace gmm { alignas(1024) unsigned char gmm_smem[200 * 1024]; }
namespace fla {
float sm[60000];
alignas(16) unsigned char tc_smem[150000];
}
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

template <class T, class R> int run_rms(char **a) {
    const int T_ = atoi(a[4]), D = atoi(a[5]), res = atoi(a[6]);
    const float eps = (float)atof(a[7]);
    const int route = atoi(a[9]), warps = atoi(a[10]), nv = atoi(a[11]);
    const int blocks = atoi(a[12]), off = atoi(a[13]);
    const size_t n = (size_t)T_ * D;
    // x, r, y and res start `off` elements into their buffers
    auto x = rd<T>("x.bin", n);
    auto r = res ? rd<R>("r.bin", n) : std::vector<R>();
    auto s = rd<float>("scale.bin", D);
    std::vector<T> xb(n + off), yb(n + off), rsb(res ? n + off : 0);
    std::vector<R> rb(res ? n + off : 0);
    std::copy(x.begin(), x.end(), xb.begin() + off);
    if (res) std::copy(r.begin(), r.end(), rb.begin() + off);
    const T *xp = xb.data() + off;
    const R *rp = res ? rb.data() + off : nullptr;
    T *yp = yb.data() + off, *rsp = res ? rsb.data() + off : nullptr;
    // the launcher's kernel for the route (rmsnorm_launch)
    const int nt = 32 * warps, threads = nt * (nt < 256 ? 256 / nt : 1);
    auto reg = [&](auto k) {
        constexpr int NV = decltype(k)::value;
        emu::launch(dim3(blocks), threads, [&] {
            rms::rmsnorm_reg_kernel<T, R, NV>(xp, rp, s.data(), yp, rsp, T_,
                                              D, eps, warps);
        });
    };
    if (route == 1) {
        emu::launch(dim3(blocks), 256, [&] {
            rms::rmsnorm_smem_kernel<T, R>(xp, rp, s.data(), yp, rsp, T_, D,
                                           eps);
        });
    } else if (route == 0 && nv == 1) {
        reg(std::integral_constant<int, 1>());
    } else if (route == 0 && nv == 2) {
        reg(std::integral_constant<int, 2>());
    } else if (route == 0 && nv == 4) {
        reg(std::integral_constant<int, 4>());
    } else {
        return 4;
    }
    wr("y.bin", std::vector<T>(yb.begin() + off, yb.end()));
    // res.bin only where the kernel wrote a residual stream
    if (res) wr("res.bin", std::vector<T>(rsb.begin() + off, rsb.end()));
    return 0;
}

template <class T> int run_rms_r(char **a) {
    const std::string r = a[8];
    return r == "bf16"  ? run_rms<T, __nv_bfloat16>(a)
           : r == "f16" ? run_rms<T, __half>(a)
                        : run_rms<T, float>(a);
}

template <class T> int run(char **a) {
    const std::string k = a[1];
    if (k == "gmm") {
        const int E = atoi(a[4]), C = atoi(a[5]), D = atoi(a[6]), F = atoi(a[7]);
        const int route = atoi(a[8]), blocks = atoi(a[9]);
        auto x = rd<T>("x.bin", (size_t)E * C * D);
        auto w = rd<T>("w.bin", (size_t)E * D * F);
        std::vector<T> o((size_t)E * C * F);
        if constexpr (std::is_same<T, float>::value) {
            if (route != 0) return 4;
            emu::launch(dim3((F + 63) / 64, (C + 63) / 64, E), 256, [&] {
                gmm::gmm_kernel(x.data(), w.data(), o.data(), C, D, F);
            });
        } else if (route == 1) {
            emu::launch(dim3((F + 127) / 128, (C + 127) / 128, E), 256, [&] {
                gmm::gmm_bf16_kernel(x.data(), w.data(), o.data(), C, D, F);
            });
        } else if (route == 2) {
            // the launcher's maps, through the stand-in encoder
            CUtensorMap mx, mw;
            if (gmm::encode_map(cuTensorMapEncodeTiled, &mx, x.data(), E, C,
                                D, gmm::GM) != CUDA_SUCCESS ||
                gmm::encode_map(cuTensorMapEncodeTiled, &mw, w.data(), E, D,
                                F, gmm::GK) != CUDA_SUCCESS)
                return 5;
            emu::smem_base = gmm::gmm_smem;
            emu::launch(dim3(blocks), gmm::GTHREADS, [&] {
                gmm::gmm_wgmma_kernel(mx, mw, o.data(), E, C, D, F);
            });
        } else {
            return 4;
        }
        wr("out.bin", o);
    } else if (k == "flash_bwd") {
        const int BH = atoi(a[4]), S = atoi(a[5]), T_ = atoi(a[6]);
        const int d = atoi(a[7]), dv = atoi(a[8]);
        const int causal = atoi(a[9]), window = atoi(a[10]);
        const float scale = (float)atof(a[11]);
        const int group = atoi(a[12]), vec = atoi(a[13]);
        if constexpr (!std::is_same<T, __nv_bfloat16>::value) return 4;
        else {
            const size_t nq = (size_t)BH * S, nk = (size_t)BH / group * T_;
            auto q = rd<T>("q.bin", nq * d);
            auto kk = rd<T>("k.bin", nk * d);
            auto v = rd<T>("v.bin", nk * dv);
            auto o = rd<T>("o.bin", nq * dv);
            auto dout = rd<T>("do.bin", nq * dv);
            auto lse = rd<float>("lse.bin", nq);
            std::vector<float> delta(nq);
            std::vector<T> gq(nq * d), gk(nk * d), gv(nk * dv);
            fla::BwdArgs args{q.data(), kk.data(), v.data(), o.data(),
                              dout.data(), lse.data(), delta.data(),
                              gq.data(), gk.data(), gv.data(), S, T_, d, dv,
                              group, BH / group, causal, window, vec, scale};
            // the launcher's passes (launch_bwd)
            fla::with_widths(d, dv, [&](auto dp, auto dvp) {
                constexpr int DP = decltype(dp)::value;
                constexpr int DV = decltype(dvp)::value;
                using TL = fla::BwdTiles<DP, DV>;
                const unsigned b1 = BH / group * ((S * group + TL::BQ - 1) / TL::BQ);
                emu::launch(dim3(b1), 128, [&] {
                    fla::attn_bwd_dq_kernel<DP, DV>(args);
                });
                const unsigned b2 =
                    BH / group * ((T_ + TL::BKV - 1) / TL::BKV) * TL::CS;
                emu::launch(dim3(b2), 128, [&] {
                    fla::attn_bwd_dkv_kernel<DP, DV>(args);
                });
                return 0;
            });
            wr("dq.bin", gq);
            wr("dk.bin", gk);
            wr("dv.bin", gv);
            wr("delta.bin", delta);
        }
    } else {
        const int BH = atoi(a[4]), S = atoi(a[5]), T_ = atoi(a[6]), d = atoi(a[7]);
        const int dv = atoi(a[8]);
        const int causal = atoi(a[9]), window = atoi(a[10]);
        const float scale = (float)atof(a[11]);
        const int group = atoi(a[12]), nsplit = atoi(a[13]), vec = atoi(a[14]);
        const int want_lse = atoi(a[15]);
        auto q = rd<T>("q.bin", (size_t)BH * S * d);
        auto kk = rd<T>("k.bin", (size_t)BH / group * T_ * d);
        auto v = rd<T>("v.bin", (size_t)BH / group * T_ * dv);
        std::vector<T> o((size_t)BH * S * dv);
        std::vector<float> lse((size_t)BH * S);
        if constexpr (std::is_same<T, float>::value) {
            if (dv != d || want_lse) return 4;
            const unsigned blocks = BH * ((S + 63) / 64);
            auto go = [&](auto nj) {
                constexpr int NJ = decltype(nj)::value;
                emu::launch(dim3(blocks), 256, [&] {
                    fla::attn_f32_kernel<NJ>(q.data(), kk.data(), v.data(),
                                             o.data(), BH, S, T_, d, group,
                                             scale, causal, window);
                });
            };
            const int nj = (d + 15) / 16;      // the launcher's choice
            if (nj <= 2) go(std::integral_constant<int, 2>());
            else if (nj <= 4) go(std::integral_constant<int, 4>());
            else if (nj <= 8) go(std::integral_constant<int, 8>());
            else if (nj <= 10) go(std::integral_constant<int, 10>());
            else go(std::integral_constant<int, 16>());
        } else {
            const int n_rows = BH * S;
            std::vector<float> pm((size_t)nsplit * n_rows),
                pl((size_t)nsplit * n_rows),
                pacc((size_t)nsplit * n_rows * dv);
            float *lp = want_lse ? lse.data() : nullptr;
            fla::AttnArgs args{q.data(), kk.data(), v.data(), o.data(),
                               pm.data(), pl.data(), pacc.data(), lp, S, T_,
                               d, dv, group, BH / group, nsplit, causal,
                               window, vec, scale};
            auto tiles = [&](auto dp, auto dvp, auto mt, auto wk) {
                constexpr int DP = decltype(dp)::value;
                constexpr int DV = decltype(dvp)::value;
                constexpr int MT = decltype(mt)::value;
                constexpr int WK = decltype(wk)::value;
                constexpr int BQ = fla::Tiles<DP, DV, MT, WK>::BQ;
                const unsigned blocks =
                    BH / group * nsplit * ((S * group + BQ - 1) / BQ);
                emu::launch(dim3(blocks), 128, [&] {
                    fla::attn_tc_kernel<DP, DV, MT, WK>(args);
                });
            };
            // the launcher's widths (with_widths) and rows a block
            // (launch_dp)
            using one = std::integral_constant<int, 1>;
            fla::with_widths(d, dv, [&](auto dp, auto dvp) {
                if (S * group <= 16)
                    tiles(dp, dvp, one(), std::integral_constant<int, 4>());
                else if (decltype(dp)::value <= 160 && S * group >= 128)
                    tiles(dp, dvp, std::integral_constant<int, 2>(), one());
                else
                    tiles(dp, dvp, one(), one());
                return 0;
            });
            if (nsplit > 1)
                emu::launch(dim3(n_rows), 64, [&] {
                    fla::attn_combine_kernel(pm.data(), pl.data(), pacc.data(),
                                             o.data(), lp, n_rows, S * group,
                                             group, S, dv, nsplit);
                });
        }
        if (want_lse) wr("lse.bin", lse);
        wr("out.bin", o);
    }
    return 0;
}

// one warp runs a twin on the lanes' inputs and writes each lane's result
int run_ptx(const std::string &what) {
    if (what == "mma") {
        auto av = rd<unsigned>("a.bin", 32 * 4);
        auto bv = rd<unsigned>("b.bin", 32 * 2);
        auto cv = rd<float>("c.bin", 32 * 4);
        std::vector<float> dv(32 * 4);
        emu::launch(dim3(1), 32, [&] {
            const int l = threadIdx.x;
            unsigned ar[4];
            float dr[4];
            for (int i = 0; i < 4; ++i) {
                ar[i] = av[4 * l + i];
                dr[i] = cv[4 * l + i];
            }
            mma_bf16_16816(dr, ar, bv[2 * l], bv[2 * l + 1]);
            for (int i = 0; i < 4; ++i) dv[4 * l + i] = dr[i];
        });
        wr("d.bin", dv);
    } else if (what == "ldmatrix" || what == "ldmatrix_trans") {
        auto m = rd<uint16_t>("m.bin", 32 * 8);     // 32 rows of 8 b16
        auto rows = rd<int>("rows.bin", 32);        // the row of each lane
        std::vector<unsigned> regs(32 * 4);
        emu::launch(dim3(1), 32, [&] {
            const int l = threadIdx.x;
            unsigned r[4];
            if (what == "ldmatrix") ldmatrix_x4(r, &m[8 * rows[l]]);
            else ldmatrix_x4_trans(r, &m[8 * rows[l]]);
            for (int i = 0; i < 4; ++i) regs[4 * l + i] = r[i];
        });
        wr("regs.bin", regs);
    } else if (what == "cvt") {
        auto f = rd<float>("f.bin", 64);            // (lo, hi) per lane
        std::vector<unsigned> regs(32);
        emu::launch(dim3(1), 32, [&] {
            const int l = threadIdx.x;
            regs[l] = cvt_bf16x2(f[2 * l], f[2 * l + 1]);
        });
        wr("regs.bin", regs);
    } else if (what == "ex2") {
        auto f = rd<float>("f.bin", 32);
        std::vector<float> y(32);
        emu::launch(dim3(1), 32,
                    [&] { y[threadIdx.x] = ex2_approx(f[threadIdx.x]); });
        wr("y.bin", y);
    } else if (what == "cp_async") {
        auto src = rd<unsigned char>("src.bin", 32 * 16);
        auto bytes = rd<int>("bytes.bin", 32);      // 16 or 0 per lane
        std::vector<unsigned char> dst(32 * 16, 0xAB);
        emu::launch(dim3(1), 32, [&] {
            const int l = threadIdx.x;
            cp_async16(&dst[16 * l], &src[16 * l], bytes[l]);
            cp_async_commit();
            cp_async_wait<0>();
        });
        wr("dst.bin", dst);
    } else if (what == "wgmma") {
        // args: N (64 or 256), scale_d of the first product, trans_b,
        // products; desc: (da, db) per product; smem: the operands
        auto args = rd<int>("args.bin", 4);
        const int N = args[0], nops = args[3];
        alignas(1024) static unsigned char arena[64 * 1024];
        auto sm = rd<unsigned char>("smem.bin", sizeof arena);
        std::memcpy(arena, sm.data(), sizeof arena);
        emu::smem_base = arena;
        auto desc = rd<unsigned long long>("desc.bin", 2 * nops);
        auto cv = rd<float>("c.bin", 128 * N / 2);
        std::vector<float> dv(128 * N / 2), before(128 * N / 2);
        auto go = [&](auto n) {
            constexpr int NN = decltype(n)::value;
            emu::launch(dim3(1), 128, [&] {
                const int l = threadIdx.x;
                float d[NN / 2];
                for (int i = 0; i < NN / 2; ++i) d[i] = cv[l * NN / 2 + i];
                wgmma_fence();
                for (int o = 0; o < nops; ++o)
                    wgmma_m64nNk16<NN>(d, desc[2 * o], desc[2 * o + 1],
                                       o > 0 || args[1], args[2]);
                wgmma_commit();
                // in flight: the accumulators still hold C
                for (int i = 0; i < NN / 2; ++i) before[l * NN / 2 + i] = d[i];
                wgmma_wait<0>();
                for (int i = 0; i < NN / 2; ++i) dv[l * NN / 2 + i] = d[i];
            });
        };
        if (N == 64) go(std::integral_constant<int, 64>());
        else if (N == 256) go(std::integral_constant<int, 256>());
        else return 2;
        wr("d.bin", dv);
        wr("before.bin", before);
    } else if (what == "tma") {
        // args: E, rows, cols, box_rows, box_cols, swizzle bytes, c0, c1,
        // c2, destination offset; g: the bf16 (E, rows, cols) tensor
        auto args = rd<int>("args.bin", 10);
        const int E = args[0], R = args[1], Cc = args[2];
        auto g = rd<uint16_t>("g.bin", (size_t)E * R * Cc);
        alignas(1024) static unsigned char arena[64 * 1024];
        std::memset(arena, 0xAB, sizeof arena);
        emu::smem_base = arena;
        const cuuint64_t dims[3] = {(cuuint64_t)Cc, (cuuint64_t)R,
                                    (cuuint64_t)E};
        const cuuint64_t strides[2] = {(cuuint64_t)Cc * 2,
                                       (cuuint64_t)R * Cc * 2};
        const cuuint32_t box[3] = {(cuuint32_t)args[4], (cuuint32_t)args[3],
                                   1};
        const cuuint32_t unit[3] = {1, 1, 1};
        CUtensorMap map;
        std::vector<int> log;
        log.push_back(cuTensorMapEncodeTiled(
            &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, g.data(), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            args[5] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
        if (log[0] == CUDA_SUCCESS) {
            unsigned long long *bar = (unsigned long long *)arena;
            const unsigned bytes = args[3] * args[4] * 2;
            emu::launch(dim3(1), 1, [&] {
                mbar_init(bar, 1);
                mbar_arrive_expect_tx(bar, bytes);
                log.push_back(mbar_try_wait_parity(bar, 0));
                tma_load_3d(arena + args[9], &map, bar, args[6], args[7],
                            args[8]);
                log.push_back(mbar_try_wait_parity(bar, 0));
            });
        }
        wr("log.bin", log);
        wr("dst.bin", std::vector<unsigned char>(arena + 1024,
                                                 arena + sizeof arena));
    } else if (what == "mbarrier") {
        // a scripted sequence on one thread, then three threads blocked on
        // a phase that a fourth completes late
        alignas(1024) static unsigned char arena[1024];
        emu::smem_base = arena;
        unsigned long long *bar = (unsigned long long *)arena;
        std::vector<int> log;
        auto tw = [&](unsigned p) { log.push_back(mbar_try_wait_parity(bar, p)); };
        emu::launch(dim3(1), 1, [&] {
            mbar_init(bar, 2);
            tw(0), tw(1);
            mbar_arrive(bar);
            tw(0);
            mbar_arrive_expect_tx(bar, 96);
            tw(0);
            mbar_complete_tx(bar, 64);
            tw(0);
            mbar_complete_tx(bar, 32);
            tw(0), tw(1);
            mbar_arrive(bar);
            mbar_arrive(bar);
            tw(1), tw(0);
        });
        std::atomic<int> passed{0};
        int early = -1, late = -1;
        emu::launch(dim3(1), 4, [&] {
            if (threadIdx.x == 0) mbar_init(bar, 1);
            __syncthreads();
            if (threadIdx.x > 0) {
                mbar_wait(bar, 0);
                ++passed;
                return;
            }
            std::this_thread::sleep_for(std::chrono::milliseconds(100));
            mbar_arrive_expect_tx(bar, 16);
            std::this_thread::sleep_for(std::chrono::milliseconds(100));
            early = passed.load();       // arrivals done, bytes not yet
            mbar_complete_tx(bar, 16);
            mbar_wait(bar, 0);
            while (passed.load() < 3) std::this_thread::yield();
            late = passed.load();
        });
        log.push_back(early);
        log.push_back(late);
        wr("log.bin", log);
    } else {
        return 2;
    }
    return 0;
}
int main(int argc, char **argv) {
    if (argc < 4) return 2;
    dir = argv[3];
    if (std::string(argv[1]) == "ptx") return run_ptx(argv[2]);
    if (std::string(argv[1]) == "rmsnorm") {
        const std::string t = argv[2];
        return t == "bf16"  ? run_rms_r<__nv_bfloat16>(argv)
               : t == "f16" ? run_rms_r<__half>(argv)
                            : run_rms_r<float>(argv);
    }
    return std::string(argv[2]) == "bf16" ? run<__nv_bfloat16>(argv)
                                          : run<float>(argv);
}
