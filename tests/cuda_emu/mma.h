// CPU stand-in for the WMMA part of mma.h.  On the card a fragment is
// spread over the 32 lanes of a warp; here every thread of the warp holds
// the whole 16 x 16 tile and does the whole product, which gives the same
// tile (sums in f32, in k order).  Lane 0 alone stores, so the warp's
// threads never write one address at once; the __syncwarp that follows a
// store on the card orders it here too.
#pragma once
#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
struct col_major {};
enum layout_t { mem_row_major, mem_col_major };

template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment {
    T x[16 * 16];
};

inline float as_float(float v) { return v; }
inline float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class Use, class T, class Layout>
void load_matrix_sync(fragment<Use, 16, 16, 16, T, Layout> &f, const T *p,
                      unsigned ldm) {
    for (int r = 0; r < 16; ++r)
        for (int c = 0; c < 16; ++c)
            f.x[r * 16 + c] = std::is_same<Layout, col_major>::value
                                  ? p[c * ldm + r]
                                  : p[r * ldm + c];
}

inline void fill_fragment(fragment<accumulator, 16, 16, 16, float> &f,
                          float v) {
    for (float &e : f.x) e = v;
}

template <class LA, class LB>
void mma_sync(fragment<accumulator, 16, 16, 16, float> &d,
              const fragment<matrix_a, 16, 16, 16, __nv_bfloat16, LA> &a,
              const fragment<matrix_b, 16, 16, 16, __nv_bfloat16, LB> &b,
              const fragment<accumulator, 16, 16, 16, float> &c) {
    float out[16 * 16];
    for (int r = 0; r < 16; ++r)
        for (int n = 0; n < 16; ++n) {
            float s = c.x[r * 16 + n];
            for (int k = 0; k < 16; ++k)
                s += as_float(a.x[r * 16 + k]) * as_float(b.x[k * 16 + n]);
            out[r * 16 + n] = s;
        }
    for (int i = 0; i < 256; ++i) d.x[i] = out[i];
}

inline void store_matrix_sync(float *p,
                              const fragment<accumulator, 16, 16, 16, float> &f,
                              unsigned ldm, layout_t layout) {
    if (threadIdx.x % 32 != 0) return;
    for (int r = 0; r < 16; ++r)
        for (int c = 0; c < 16; ++c)
            (layout == mem_col_major ? p[c * ldm + r] : p[r * ldm + c]) =
                f.x[r * 16 + c];
}

}  // namespace wmma
}  // namespace nvcuda
