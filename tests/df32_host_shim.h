// Lets a host compiler build akbx_torch/csrc/df32.cuh, so that a CPU test
// can hold the header's df32 functions against their PyTorch twins.
// Include it before df32.cuh and compile with -O2 -ffp-contract=off: each
// round-to-nearest intrinsic becomes the plain IEEE float operation,
// __fmaf_rn becomes std::fmaf.  rsqrtf (a first guess on the card, used by
// df_rsqrt only) is defined so that the header compiles; df_rsqrt is not
// tested through this shim.
#pragma once

#include <cmath>

#define __device__
#define __forceinline__ inline

static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
static inline float __fmaf_rn(float a, float b, float c) {
  return std::fmaf(a, b, c);
}
static inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
