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
// contracted; the only FMAs are the explicit __fmaf_rn of two_prod
// (df32.cuh; 7 a pair) and those inside libdevice's sinf / cosf.  The
// build passes -fmad=false and never --use_fast_math.
//
// What bounds it on this card: 266 f32 operations a pair (a division, a
// square root, a sine counted as one) against 32 bytes a source and 24 a
// target, so the f32 instruction rate (33.5e12 operations/s on an H100
// SXM), not memory.  The card's other units do not apply.  The tensor
// cores cannot carry the distance: |t|^2 + |s|^2 - 2 t.s from TF32 or
// bf16 splits keeps ~30 bits, where the phase k r needs the error-free
// 49 bits (2^-48 of the coordinates).  A TMA ring has nothing to hide: a
// tile is 8 KB per 65,536 pairs.  So the design serves the instruction
// pipe:
//
//  - H_SPLIT = 4 neighbouring lanes share a target, and each carries
//    H_UNROLL = 4 sources at a time, so a target's 16 pair chains are in
//    flight at once: independent chains for the scheduler to interleave,
//    and four times the warps for a given target count (a stage of 66,049
//    targets is 62 warps an SM, twice what an SM holds at 64 registers a
//    thread; one of 2,048 targets is 32 blocks where a thread per target
//    gave 8 on 132 SMs).  The terms are then
//    added into the tile's f32 partial sums in source order, by every
//    lane of the target alike (a shuffle fetches a neighbour's term), so
//    the sum inside a tile keeps the order of a one-source-at-a-time loop.
//    The target's df32 coordinates and the sums stay in registers.
//  - The sources stream through shared memory in tiles of H_TILE = 256,
//    one 32-byte record each (x, y, z hi/lo and the two weights), read as
//    two float4 (the lanes of a warp read four records, a multicast).  The
//    tile buffer is doubled and the next tile is filled with cp.async
//    while this one is consumed: one barrier a tile, no exposed load.
//  - k arrives by value (two floats in the constant bank), not as a load.
//  - Both ragged tails are masked, nothing is padded.
//
// As in the TPU kernel, each tile's terms are summed in f32 and the tile
// sums are added, in tile order, into an f32 total per target (the TPU
// keeps its f32 output tile resident across source tiles); the wrapper
// casts it to f64.
//
// What is left between the kernel and its bound is the instruction count:
// the bound takes a division, a square root, a sine and a cosine as one
// operation each, and the card takes a sequence of instructions for each
// (four IEEE divisions, a square root, sinf and cosf a pair).  More warps,
// more chains per thread and other block sizes all measure within a few
// percent of each other (chip_kernel_tune.py): the instruction pipe is
// full.
//
// Build (akbx_torch/kernels/_build.py): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -prec-div=true
// -prec-sqrt=true -shared -Xcompiler -fPIC; never --use_fast_math.  With
// -DAKBX_TUNE the library also holds akbx_huygens_variant, every block
// size, unroll depth and lane split that chip_kernel_tune.py times.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "df32.cuh"

#define H_TILE 256   // sources per f32 partial sum (huygens.py::TILE)
#define H_BLOCK 256  // threads per block: H_BLOCK / H_SPLIT targets
#define H_UNROLL 4   // independent sources in flight per thread
#define H_SPLIT 4    // neighbouring lanes that share a target

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

// the f32 terms of one (target, source) pair; c = x_hi, x_lo, y_hi, y_lo
// and zw = z_hi, z_lo, re ds, im ds of the source's record
__device__ __forceinline__ void pair_terms(const df* t, df k, float4 c,
                                           float4 zw, float* re, float* im) {
  // r = |t - s| in df32 (huygens.py:177-185)
  const df dx = df_add(t[0], {-c.x, -c.y});
  const df dy = df_add(t[1], {-c.z, -c.w});
  const df dz = df_add(t[2], {-zw.x, -zw.y});
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
  *re = __fsub_rn(__fmul_rn(cr, zw.z), __fmul_rn(sr, zw.w));
  *im = __fadd_rn(__fmul_rn(sr, zw.z), __fmul_rn(cr, zw.w));
}

// this block's share of one source tile, gathered from the (6, m) and
// (2, m) rows into 32-byte records; the caller commits the batch
template <int BLOCK>
__device__ __forceinline__ void fill_tile(float* buf, const float* src,
                                          const float* w, long long m,
                                          long long base) {
  for (int q = threadIdx.x; q < H_TILE; q += BLOCK) {
    const long long j = base + q;
    if (j < m) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
        __pipeline_memcpy_async(buf + 8 * q + r, src + r * m + j, 4);
      __pipeline_memcpy_async(buf + 8 * q + 6, w + j, 4);
      __pipeline_memcpy_async(buf + 8 * q + 7, w + m + j, 4);
    }
  }
}

// v of lane p among the SPLIT lanes that share a target
template <int SPLIT>
__device__ __forceinline__ float from_lane(unsigned int lanes, float v,
                                           int p) {
  return SPLIT > 1 ? __shfl_sync(lanes, v, p, SPLIT) : v;
}

// Adds the terms of the SPLIT * UNROLL sources from q0 on to the tile's
// partial sums.  This lane computes UNROLL of them (every SPLIT-th from
// q0 + part); then every lane of the target adds all of them in source
// order.  RAGGED: the group crosses the tile's end at len, and a term
// past it is +0, which leaves the sums' bits as they are.
template <int UNROLL, int SPLIT, bool RAGGED>
__device__ __forceinline__ void add_group(const df* t, df k,
                                          const float4* rec, int q0, int len,
                                          int part, unsigned int lanes,
                                          float* part_re, float* part_im) {
  float re[UNROLL], im[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int q = q0 + u * SPLIT + part;
    re[u] = 0.0f;
    im[u] = 0.0f;
    if (!RAGGED || q < len)
      pair_terms(t, k, rec[2 * q], rec[2 * q + 1], &re[u], &im[u]);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int p = 0; p < SPLIT; ++p) {
      *part_re = __fadd_rn(*part_re, from_lane<SPLIT>(lanes, re[u], p));
      *part_im = __fadd_rn(*part_im, from_lane<SPLIT>(lanes, im[u], p));
    }
  }
}

template <int BLOCK, int UNROLL, int SPLIT>
__global__ void __launch_bounds__(BLOCK, 1024 / BLOCK)
huygens_kernel(const float* __restrict__ tgt, long long n,
               const float* __restrict__ src,
               const float* __restrict__ w, long long m, float k_hi,
               float k_lo, float* __restrict__ out) {
  __shared__ __align__(16) float s[2][8 * H_TILE];
  // SPLIT neighbouring lanes share a target; lanes is their mask
  const int part = threadIdx.x % SPLIT;
  const unsigned int lanes = ((1u << SPLIT) - 1u)
                             << ((threadIdx.x & 31) & ~(SPLIT - 1));
  const long long i =
      (long long)blockIdx.x * (BLOCK / SPLIT) + threadIdx.x / SPLIT;
  const bool live = i < n;
  df t[3] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  if (live)
    for (int r = 0; r < 3; ++r)
      t[r] = {tgt[(2 * r) * n + i], tgt[(2 * r + 1) * n + i]};
  const df k = {k_hi, k_lo};
  float acc_re = 0.0f, acc_im = 0.0f;

  fill_tile<BLOCK>(s[0], src, w, m, 0);
  __pipeline_commit();
  int cur = 0;
  for (long long base = 0; base < m; base += H_TILE, cur ^= 1) {
    // this tile has landed; every thread is done with the other buffer
    __pipeline_wait_prior(0);
    __syncthreads();
    if (base + H_TILE < m)
      fill_tile<BLOCK>(s[cur ^ 1], src, w, m, base + H_TILE);
    __pipeline_commit();
    if (!live) continue;
    const float4* rec = reinterpret_cast<const float4*>(s[cur]);
    const int len = (int)(m - base < H_TILE ? m - base : H_TILE);
    float part_re = 0.0f, part_im = 0.0f;
    int q0 = 0;
    for (; q0 + SPLIT * UNROLL <= len; q0 += SPLIT * UNROLL)
      add_group<UNROLL, SPLIT, false>(t, k, rec, q0, len, part, lanes,
                                      &part_re, &part_im);
    if (q0 < len)  // the last tile's ragged tail
      add_group<UNROLL, SPLIT, true>(t, k, rec, q0, len, part, lanes,
                                     &part_re, &part_im);
    acc_re = __fadd_rn(acc_re, part_re);
    acc_im = __fadd_rn(acc_im, part_im);
  }
  if (live && part == 0) {
    out[i] = acc_re;
    out[n + i] = acc_im;
  }
}

template <int BLOCK, int UNROLL, int SPLIT>
static int launch(const float* tgt, long long n, const float* src,
                  const float* w, long long m, float k_hi, float k_lo,
                  float* out, void* stream) {
  if (n <= 0) return 0;
  const int targets = BLOCK / SPLIT;
  const unsigned int blocks = (unsigned int)((n + targets - 1) / targets);
  huygens_kernel<BLOCK, UNROLL, SPLIT>
      <<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(tgt, n, src, w, m, k_hi,
                                                   k_lo, out);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes.  tgt (6, n) and src (6, m)
// f32 rows x_hi, x_lo, y_hi, y_lo, z_hi, z_lo; w (2, m) f32 rows re ds,
// im ds; k_hi, k_lo the wavenumber's f32 pair, by value; out (2, n) f32
// rows re, im.  Launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 = ok).
extern "C" int akbx_huygens(const float* tgt, long long n, const float* src,
                            const float* w, long long m, float k_hi,
                            float k_lo, float* out, void* stream) {
  return launch<H_BLOCK, H_UNROLL, H_SPLIT>(tgt, n, src, w, m, k_hi, k_lo,
                                            out, stream);
}

#ifdef AKBX_TUNE
// the same kernel at another block size, unroll depth and lane split,
// for timing
extern "C" int akbx_huygens_variant(int block, int unroll, int split,
                                    const float* tgt, long long n,
                                    const float* src, const float* w,
                                    long long m, float k_hi, float k_lo,
                                    float* out, void* stream) {
#define VARIANT(B, U, S)                                 \
  if (block == B && unroll == U && split == S)           \
    return launch<B, U, S>(tgt, n, src, w, m, k_hi, k_lo, out, stream);
#define VARIANTS(B, S) VARIANT(B, 1, S) VARIANT(B, 2, S) VARIANT(B, 4, S)
  VARIANTS(64, 1) VARIANTS(128, 1) VARIANTS(256, 1) VARIANT(256, 8, 1)
  VARIANTS(128, 2) VARIANTS(256, 2) VARIANTS(128, 4) VARIANTS(256, 4)
  VARIANTS(256, 8)
#undef VARIANTS
#undef VARIANT
  return (int)cudaErrorInvalidValue;
}
#endif
