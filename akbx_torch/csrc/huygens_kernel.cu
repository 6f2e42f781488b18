// The Huygens contraction K3 of akbx_torch, for Hopper (sm_90a).
//
// akbx_huygens replaces the Pallas TPU kernel
// akbx/kernels/huygens.py::_huygens_kernel.  For every target i it sums
// over all sources j
//
//   u[i] = sum_j (re_j + i im_j) ds_j exp(-i k r_ij) / r_ij
//
// with the weights re ds, im ds given as f32 and the coordinates as exact
// (hi, lo) f32 pairs of the f64 values, re-centred on the joint centroid
// by the host (akbx_torch/kernels/huygens.py::propagate_pallas).  Per
// pair, in double-f32 (df32.cuh, the same ops in the same order as
// huygens.py:177-214): the df32 differences, squares and sum, df_sqrt,
// k r by df_mul, the two-step mod-2pi reduction of -k r (rintf is
// round-half-even like jnp.round), then the accurate f32 sinf / cosf
// (never __sinf / __cosf) of a phase in about [-pi, pi], the guarded 1/r
// and the f32 terms cr sre - sr sim, sr sre + cr sim.  Every add and
// multiply is an explicit round-to-nearest intrinsic, so nothing is
// contracted into an FMA; the build passes -fmad=false and never
// --use_fast_math.
//
// Launch layout: one thread per target, 256 per block, the target's df32
// coordinates and two accumulators in registers.  The sources stream
// through shared memory in tiles of 256 (8 f32 = 32 B each: x, y, z hi/lo
// and the two weights), every thread reading the same source at a time (a
// broadcast).  Both ragged tails are masked, nothing is padded.  As in the
// TPU kernel, each tile's terms are summed in f32 and the tile sums are
// added, in tile order, into an f32 total per target (the TPU keeps its
// f32 output tile resident across source tiles); the wrapper casts it to
// f64.
//
// What bounds it on this card: each pair is ~270 f32 operations when
// every two_prod is a multiply and an FMA, ~640 as written here (the
// Dekker two_prod without FMA; chip_smoke.py counts both), against 32
// bytes per source and 24 per target, so it is bound by the f32
// instruction rate (33.5e12 operations/s on an H100 SXM), not by memory.
// This first version does nothing about speed.
//
// Build (akbx_torch/kernels/_build.py): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -prec-div=true
// -prec-sqrt=true -shared -Xcompiler -fPIC; never --use_fast_math.

#include <cuda_runtime.h>

#include "df32.cuh"

#define H_THREADS 256  // targets per block = sources per shared-memory tile

// 2 pi as an f32 (hi, lo) pair: huygens.py's TWO_PI_HI32, TWO_PI_LO32
#define TWO_PI_HI32 0x1.921fb6p+2f
#define TWO_PI_LO32 (-0x1.777a5cp-23f)

// one step of the mod-2pi reduction of a df32 phase (huygens.py:193-196)
__device__ __forceinline__ df reduce_2pi(df p) {
  const float n = rintf(__fdiv_rn(p.hi, TWO_PI_HI32));
  const df m = two_prod(n, TWO_PI_HI32);
  p = df_add(p, {-m.hi, -m.lo});
  return df_add(p, {__fmul_rn(-n, TWO_PI_LO32), 0.0f});
}

__global__ void __launch_bounds__(H_THREADS)
huygens_kernel(const float* __restrict__ tgt, long long n,
               const float* __restrict__ src,
               const float* __restrict__ w, long long m,
               const float* __restrict__ k_pair,
               float* __restrict__ out) {
  __shared__ float s[8][H_THREADS];
  const long long i = (long long)blockIdx.x * H_THREADS + threadIdx.x;
  const bool live = i < n;
  df t[3] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  if (live)
    for (int r = 0; r < 3; ++r)
      t[r] = {tgt[(2 * r) * n + i], tgt[(2 * r + 1) * n + i]};
  const df k = {k_pair[0], k_pair[1]};
  float acc_re = 0.0f, acc_im = 0.0f;

  for (long long base = 0; base < m; base += H_THREADS) {
    __syncthreads();  // the previous tile is consumed
    const long long j = base + threadIdx.x;
    if (j < m) {
      for (int r = 0; r < 6; ++r) s[r][threadIdx.x] = src[r * m + j];
      s[6][threadIdx.x] = w[j];
      s[7][threadIdx.x] = w[m + j];
    }
    __syncthreads();
    if (!live) continue;
    const int len = (int)(m - base < H_THREADS ? m - base : H_THREADS);
    float part_re = 0.0f, part_im = 0.0f;
    for (int q = 0; q < len; ++q) {
      // r = |t - s| in df32 (huygens.py:177-185)
      const df dx = df_add(t[0], {-s[0][q], -s[1][q]});
      const df dy = df_add(t[1], {-s[2][q], -s[3][q]});
      const df dz = df_add(t[2], {-s[4][q], -s[5][q]});
      const df d2 = df_add(df_add(df_mul(dx, dx), df_mul(dy, dy)),
                           df_mul(dz, dz));
      const df r = df_sqrt(d2);
      // phase -k r, reduced mod 2pi in two df32 steps (:189-201)
      const df kr = df_mul(r, k);
      const df p = reduce_2pi(reduce_2pi({-kr.hi, -kr.lo}));
      const float phase = __fadd_rn(p.hi, p.lo);
      const float sn = sinf(phase);
      const float cs = cosf(phase);
      // guard r ~ 0 (:207), then the weighted terms (:211-214)
      const float inv_r = r.hi > 1e-12f ? __fdiv_rn(1.0f, r.hi) : 0.0f;
      const float cr = __fmul_rn(cs, inv_r);
      const float sr = __fmul_rn(sn, inv_r);
      const float sre = s[6][q], sim = s[7][q];
      part_re = __fadd_rn(part_re,
                          __fsub_rn(__fmul_rn(cr, sre), __fmul_rn(sr, sim)));
      part_im = __fadd_rn(part_im,
                          __fadd_rn(__fmul_rn(sr, sre), __fmul_rn(cr, sim)));
    }
    acc_re = __fadd_rn(acc_re, part_re);
    acc_im = __fadd_rn(acc_im, part_im);
  }
  if (live) {
    out[i] = acc_re;
    out[n + i] = acc_im;
  }
}

// Plain C entry point, loaded with ctypes.  tgt (6, n) and src (6, m)
// f32 rows x_hi, x_lo, y_hi, y_lo, z_hi, z_lo; w (2, m) f32 rows re ds,
// im ds; k_pair (2,) f32 (hi, lo); out (2, n) f32 rows re, im.  Launches
// on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 = ok).
extern "C" int akbx_huygens(const float* tgt, long long n, const float* src,
                            const float* w, long long m, const float* k_pair,
                            float* out, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + H_THREADS - 1) / H_THREADS);
  huygens_kernel<<<blocks, H_THREADS, 0, (cudaStream_t)stream>>>(
      tgt, n, src, w, m, k_pair, out);
  return (int)cudaGetLastError();
}
