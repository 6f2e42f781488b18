// Double-f32 ("df32") arithmetic for the deviation-trace and Huygens
// kernels.
//
// Port of the op set of akbx/kernels/huygens.py::_make_df_ops plus
// akbx/kernels/trace_kernel.py::_df_div.  A df value is hi + lo with
// |lo| <= ulp(hi)/2 (~49 mantissa bits).  The error-free transforms are
// exact only if every add and multiply rounds exactly as written, so every
// operation inside them is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), which the
// compiler never contracts; the build also passes -fmad=false and never
// --use_fast_math.
//
// The one FMA is the explicit __fmaf_rn of two_prod: p = fl(a b) and
// e = fma(a, b, -p) = a b - p, exact, in 2 instructions.  An explicit
// intrinsic is emitted whatever -fmad says, and a product written as
// __fmul_rn is a single consistent value here, so the two hazards that
// made the JAX package build two_prod from Dekker splits and two_sum
// chains (56 operations; akbx/core/precision.py::two_prod) do not exist
// on this compiler.  Both forms give the same (p, e) bit for bit unless the
// error term falls below the f32 normal range (|a b| under about 2^-102),
// where the FMA rounds it once to a subnormal and the Dekker form ends
// within 2^-148 of it.
//
// Each function performs the same operations in the same order as the
// plain PyTorch twin (akbx_torch/core/precision.py and
// akbx_torch/kernels/trace_kernel.py), so kernel and twin agree to the
// last bit except where df_rsqrt's first guess (rsqrtf) rounds
// differently from torch.rsqrt.
#pragma once

struct df {
  float hi;
  float lo;
};

__device__ __forceinline__ df two_sum(float a, float b) {
  float s = __fadd_rn(a, b);
  float bb = __fsub_rn(s, a);
  float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

__device__ __forceinline__ df fast_two_sum(float a, float b) {
  float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

// exact product and its error term; the twin takes the same FMA through
// f64 (core/precision.py::two_prod)
__device__ __forceinline__ df two_prod(float a, float b) {
  float p = __fmul_rn(a, b);
  float e = __fmaf_rn(a, b, -p);
  return {p, e};
}

__device__ __forceinline__ df df_add(df x, df y) {
  df s = two_sum(x.hi, y.hi);
  df t = two_sum(x.lo, y.lo);
  float c = __fadd_rn(s.lo, t.hi);
  df v = fast_two_sum(s.hi, c);
  float w = __fadd_rn(t.lo, v.lo);
  return fast_two_sum(v.hi, w);
}

__device__ __forceinline__ df df_mul(df x, df y) {
  df p = two_prod(x.hi, y.hi);
  float e = __fadd_rn(p.lo, __fadd_rn(__fmul_rn(x.hi, y.lo),
                                      __fmul_rn(x.lo, y.hi)));
  return fast_two_sum(p.hi, e);
}

// exact scaling by a power of two or a sign
__device__ __forceinline__ df df_scale(df x, float s) {
  return {__fmul_rn(x.hi, s), __fmul_rn(x.lo, s)};
}

__device__ __forceinline__ df df_sqrt(df x) {
  float s = __fsqrt_rn(x.hi);
  df s2 = two_prod(s, s);
  df d = two_sum(x.hi, -s2.hi);
  float r = __fadd_rn(d.hi, __fadd_rn(__fsub_rn(d.lo, s2.lo), x.lo));
  float safe = s > 0.0f ? s : 1.0f;
  float e = __fdiv_rn(r, __fmul_rn(2.0f, safe));
  return fast_two_sum(s, e);
}

// trace_kernel.py::_df_div: quotient + one Newton correction
__device__ __forceinline__ df df_div(df x, df y) {
  float q1 = __fdiv_rn(x.hi, y.hi);
  df p = two_prod(y.hi, q1);
  float e = __fadd_rn(p.lo, __fmul_rn(y.lo, q1));
  df r = df_add(x, {-p.hi, -e});
  float q2 = __fdiv_rn(__fadd_rn(r.hi, r.lo), y.hi);
  return fast_two_sum(q1, q2);
}

// bounce_chain's df_rsqrt: f32 first guess + one double-word Newton step
__device__ __forceinline__ df df_rsqrt(df x) {
  float s = rsqrtf(x.hi < 1e-30f ? 1e-30f : x.hi);
  df s2 = two_prod(s, s);
  df xs = df_mul(x, s2);
  df c = df_scale(df_add({-xs.hi, -xs.lo}, {3.0f, 0.0f}), 0.5f);
  df p0 = two_prod(s, c.hi);
  return fast_two_sum(p0.hi, __fadd_rn(p0.lo, __fmul_rn(s, c.lo)));
}

__device__ __forceinline__ df dot3(const df* a, const df* b) {
  return df_add(df_add(df_mul(a[0], b[0]), df_mul(a[1], b[1])),
                df_mul(a[2], b[2]));
}
