// lutact_core.h — the interpolated fixed-point sigmoid of one int32 value,
// written once for two compilers: nvcc builds it into the lut_sigmoid
// kernel (lutact.cu), g++ into a CPU library that the tests hold against
// the reference (lutact_host.cpp).
//
// It computes the JAX package's `fpsigmoid_interp_jnp`
// (src/repro/core/fixedpoint/luts.py) bit for bit over all of int32:
//
//   ax = |x|                (wraps: |INT_MIN| == INT_MIN)
//   i  = clip(ax // 250, 0, 31)
//   r  = ax - 250 i
//   y  = lut[i] + ((lut[i+1] - lut[i]) r) // 250      (int32, wrapping)
//   y  = 1000 if ax >= 8000
//   out = 1000 - y if x < 0 else y
//
// `//` is a floor division and int32 products wrap.  Signed overflow is
// undefined in C++, so + - * go through uint32.  The negation behind |x| is
// an opaque PTX `sub` on the device: nvcc treats `a < 0 ? -a : a` as an
// abs that is never negative, however the negation is spelt, and would
// then drop the floor correction of `ax // 250` and the lower clip, which
// at INT_MIN keep the LUT index in range.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define LA_HD __host__ __device__ __forceinline__
#else
#define LA_HD inline
#endif

namespace lutact {

constexpr int32_t STEP = 250;          // _SIG_INTERP_MAX // _SIG_INTERP_N
constexpr int32_t N = 32;              // _SIG_INTERP_N; the LUT has N + 1 entries
constexpr int32_t MAX = 8000;          // _SIG_INTERP_MAX

LA_HD int32_t wadd(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
LA_HD int32_t wsub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
LA_HD int32_t wmul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }

LA_HD int32_t wneg(int32_t a) {
#ifdef __CUDA_ARCH__
    int32_t r;
    asm("sub.s32 %0, 0, %1;" : "=r"(r) : "r"(a));
    return r;
#else
    return (int32_t)(0u - (uint32_t)a);
#endif
}

// Floor division by a positive constant (jnp's `//`).
LA_HD int32_t fdiv_step(int32_t a) {
    int32_t q = a / STEP;
    if ((a % STEP != 0) && (a < 0)) q -= 1;
    return q;
}

LA_HD int32_t sigmoid_interp(int32_t x, const int32_t* lut) {
    const bool mirror = x < 0;
    const int32_t ax = mirror ? wneg(x) : x;
    int32_t i = fdiv_step(ax);
    i = i < 0 ? 0 : (i > N - 1 ? N - 1 : i);
    const int32_t r = wsub(ax, wmul(i, STEP));
    const int32_t y0 = lut[i], y1 = lut[i + 1];
    int32_t y = wadd(y0, fdiv_step(wmul(wsub(y1, y0), r)));
    if (ax >= MAX) y = 1000;
    return mirror ? wsub(1000, y) : y;
}

}  // namespace lutact
