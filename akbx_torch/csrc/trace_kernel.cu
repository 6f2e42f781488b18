// The deviation-trace kernels of akbx_torch, for Hopper (sm_90a).
//
// K1 akbx_trace_deviation replaces the Pallas TPU kernel
//    akbx/kernels/trace_kernel.py::_trace_kernel (math: bounce_chain).
// K2 akbx_detector replaces akbx/kernels/trace_kernel.py::_det_kernel
//    (math: detector_chain), and serves every detector plane in one
//    launch where the JAX package launches once per plane.
//
// Both are per-ray elementwise chains in double-f32 (df32.cuh): one
// thread per ray, 256 threads per block, a masked ragged tail.  Every
// input and output is a row of a (rows, N) plane stack, read and written
// coalesced by ray index with 64-bit plane offsets (59 N passes 2^31 above
// 36.4M rays).  Every add and multiply is an explicit round-to-nearest
// intrinsic, so nothing is contracted; the only FMAs are the explicit
// __fmaf_rn of two_prod (df32.cuh), and df_rsqrt's first guess is the
// card's rsqrtf (rsqrt.approx), which its double-word Newton step
// corrects.
//
// What bounds them on this card: K1 does 8,572 f32 operations per ray at
// four mirrors (a division or a square root counted as one) against 48
// bytes read and 236 written, so the f32 instruction rate, not memory
// (1.19 GB at 4,194,304 rays is a third of the operations' time).  Its
// design serves the instruction pipe:
//
//  - The per-mirror constants (n_mirr x 64 f32) live in __constant__
//    memory, so each is read as an instruction operand: no load
//    instruction, no shared memory, no barrier.  The table is computed on
//    the device from the chief trace, so the entry point fills the symbol
//    with a device-to-device cudaMemcpyToSymbolAsync on the launch's
//    stream, just before the launch; nothing passes through the host.  Two
//    launches on one stream are ordered, so the symbol is safe between
//    them.  K1 must therefore not run on two streams at once (the wrapper,
//    kernels/trace_kernel.py::trace_deviation, raises if asked to).
//  - The kernel is a template on the mirror count, dispatched by the
//    entry point, and the mirror loop is fully unrolled together with the
//    3-vector loops: every constant has a fixed offset, and dp, dd, dq
//    and the dot products live in registers, with no stack frame.
//  - The inputs stay two f64 planes read coalesced and split in the
//    kernel; the 59 output rows are coalesced f32 stores.
//
// K2 does 1,582 operations per ray for both planes against ~56 bytes read
// and ~112 written: bound by bytes.  Its small table (n_planes x 32 f32)
// is staged in shared memory once per block.
//
// Build (akbx_torch/kernels/_build.py): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -prec-div=true
// -prec-sqrt=true -shared -Xcompiler -fPIC; never --use_fast_math.  With
// -DAKBX_TUNE the library also holds akbx_trace_deviation_variant, the
// occupancy targets and store hints that chip_kernel_tune.py times.

#include <cuda_runtime.h>

#include "df32.cuh"

// constants-row layout of K1; the same offsets as
// akbx_torch/kernels/trace_kernel.py::pack_consts
#define M_HI 0
#define M_LO 9
#define GC_HI 18
#define GC_LO 21
#define GA_HI 24
#define GA_LO 27
#define D_HI 30
#define D_LO 33
#define DN_HI 36
#define DN_LO 39
#define T_HI 42
#define T_LO 43
#define A_HI 44
#define A_LO 45
#define BP_HI 46
#define BP_LO 47
#define RHO_HI 48
#define RHO_LO 49
#define BRANCH 50
#define T2_HI 51
#define T2_LO 52
#define BV_HI 53
#define BV_LO 56
#define N_CONST 64
#define MAX_MIRRORS 8

// constants-row layout of K2 (pack_det_consts)
#define DR_HI 0
#define DR_LO 9
#define DD4_HI 18
#define DD4_LO 21
#define DTC_HI 24
#define DTC_LO 25
#define DL_HI 26
#define DL_LO 27
#define DL2_HI 28
#define DL2_LO 29
#define N_DCONST 32
#define MAX_PLANES 4

#define THREADS 256

__device__ __forceinline__ df cdf(const float* c, int k_hi, int k_lo) {
  return {c[k_hi], c[k_lo]};
}

// exact f64 -> (hi, lo) f32 split, as akbx_torch/kernels/__init__.py::split64
__device__ __forceinline__ df split64(double x) {
  float hi = __double2float_rn(x);
  float lo = __double2float_rn(__dsub_rn(x, (double)hi));
  return {hi, lo};
}

__device__ __forceinline__ df df_where(bool c, df a, df b) {
  return c ? a : b;
}

// K1's constants, (n_mirr, 64) f32 rows; filled by launch_trace
__constant__ float c_trace[MAX_MIRRORS * N_CONST];

// a df constant of mirror m; with m and the offsets known at compile time
// each word is an operand in the constant bank
__device__ __forceinline__ df kdf(int m, int k_hi, int k_lo) {
  return {c_trace[m * N_CONST + k_hi], c_trace[m * N_CONST + k_lo]};
}

// a store of a value that this kernel never reads again
template <bool STREAM>
__device__ __forceinline__ void put(float* p, float v) {
  if (STREAM)
    __stcs(p, v);
  else
    *p = v;
}

template <int N_MIRR, int MIN_BLOCKS, bool STREAM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
trace_deviation_kernel(const double* __restrict__ dp64,
                       const double* __restrict__ dd64, long long n,
                       float* __restrict__ dq_hi, float* __restrict__ dq_lo,
                       float* __restrict__ od_hi, float* __restrict__ od_lo,
                       float* __restrict__ dt_hi, float* __restrict__ dt_lo,
                       float* __restrict__ dsum_hi,
                       float* __restrict__ dsum_lo,
                       float* __restrict__ valid_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  df dp[3], dd[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    dp[r] = split64(dp64[r * n + i]);
    dd[r] = split64(dd64[r * n + i]);
  }
  float valid = 1.0f;
  df dsum = {0.0f, 0.0f};

#pragma unroll
  for (int m = 0; m < N_MIRR; ++m) {
    df M[3][3], gC[3], gA[3], Dv[3], Dn[3], bv[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        M[r][q] = kdf(m, M_HI + 3 * r + q, M_LO + 3 * r + q);
      gC[r] = kdf(m, GC_HI + r, GC_LO + r);
      gA[r] = kdf(m, GA_HI + r, GA_LO + r);
      Dv[r] = kdf(m, D_HI + r, D_LO + r);
      Dn[r] = kdf(m, DN_HI + r, DN_LO + r);
      bv[r] = kdf(m, BV_HI + r, BV_LO + r);
    }
    const df Tc = kdf(m, T_HI, T_LO);
    const df T2c = kdf(m, T2_HI, T2_LO);
    const df Ac = kdf(m, A_HI, A_LO);
    const df Bpc = kdf(m, BP_HI, BP_LO);
    const df rhoc = kdf(m, RHO_HI, RHO_LO);
    const float branch = c_trace[m * N_CONST + BRANCH];

    df Mdp[3], Mdd[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      Mdp[r] = dot3(M[r], dp);
      Mdd[r] = dot3(M[r], dd);
    }
    const df dC = df_add(dot3(gC, dp), dot3(Mdp, dp));
    const df dA = df_add(dot3(gA, dd), dot3(Mdd, dd));
    const df dB = df_add(df_add(dot3(gC, dd), dot3(gA, dp)),
                         df_scale(dot3(Mdp, dd), 2.0f));

    // R = dA T^2 + dB T + dC + rho
    const df R = df_add(df_add(df_mul(dA, T2c), df_mul(dB, Tc)),
                        df_add(dC, rhoc));
    const df A_full = df_add(dA, Ac);
    const df Bp = df_add(df_add(df_scale(df_mul(dA, Tc), 2.0f), dB), Bpc);

    // stable q-form roots of A dt^2 + B' dt + R = 0
    const df disc = df_add(df_mul(Bp, Bp), df_scale(df_mul(A_full, R), -4.0f));
    const bool ok = disc.hi > 0.0f;
    const df sq = df_sqrt(ok ? disc : df{0.0f, 0.0f});
    const bool b_pos = Bp.hi >= 0.0f;
    const float sgn = b_pos ? 1.0f : -1.0f;
    const df qq = df_scale(
        df_add(Bp, {__fmul_rn(sq.hi, sgn), __fmul_rn(sq.lo, sgn)}), -0.5f);
    const df safe_q = {qq.hi != 0.0f ? qq.hi : 1.0f, qq.lo};
    const df safe_A = {A_full.hi != 0.0f ? A_full.hi : 1.0f, A_full.lo};
    const df t_q_A = df_div(qq, safe_A);
    const df t_R_q = df_div(R, safe_q);
    const df t_plus = df_where(b_pos, t_R_q, t_q_A);
    const df t_minus = df_where(b_pos, t_q_A, t_R_q);
    const df dt = df_where(branch >= 0.0f, t_plus, t_minus);
    valid = __fmul_rn(valid, ok ? 1.0f : 0.0f);

    // dq = dp + T dd + dt (D + dd)
    df d_full[3], dq[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      d_full[r] = df_add(dd[r], Dv[r]);
      dq[r] = df_add(df_add(dp[r], df_mul(dd[r], Tc)), df_mul(d_full[r], dt));
    }

    // unit normal: gradQ(dq) = bvec + 2 M dq (chief-centered frame)
    df nvec[3], n_unit[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      nvec[r] = df_add(df_scale(dot3(M[r], dq), 2.0f), bv[r]);
    const df inv_n = df_rsqrt(dot3(nvec, nvec));
#pragma unroll
    for (int r = 0; r < 3; ++r) n_unit[r] = df_mul(nvec[r], inv_n);

    // reflect: r = d - 2 (d.n) n; deviation from the chief's reflected
    const df dn2 = df_scale(dot3(d_full, n_unit), -2.0f);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const df refl = df_add(d_full[r], df_mul(n_unit[r], dn2));
      dd[r] = df_add(refl, df_scale(Dn[r], -1.0f));
      dp[r] = dq[r];
      const long long row = (long long)(3 * m + r) * n + i;
      put<STREAM>(dq_hi + row, dq[r].hi);
      put<STREAM>(dq_lo + row, dq[r].lo);
      put<STREAM>(od_hi + row, dd[r].hi);
      put<STREAM>(od_lo + row, dd[r].lo);
    }
    put<STREAM>(dt_hi + (long long)m * n + i, dt.hi);
    put<STREAM>(dt_lo + (long long)m * n + i, dt.lo);
    dsum = m == 0 ? dt : df_add(dsum, dt);
  }
  put<STREAM>(dsum_hi + i, dsum.hi);
  put<STREAM>(dsum_lo + i, dsum.lo);
  put<STREAM>(valid_out + i, valid);
}

// detector plane x = x_det + OPL finish on the tilt-rotated deviations
// (trace_kernel.py::_plane_chain), for one constants row
__device__ __forceinline__ void plane_chain(const float* c, const df* dqr,
                                            const df* ddr, df dsum,
                                            df* ddet, df* dtot) {
  df D4[3];
  for (int r = 0; r < 3; ++r) D4[r] = cdf(c, DD4_HI + r, DD4_LO + r);
  const df tc = cdf(c, DTC_HI, DTC_LO);
  const df L = cdf(c, DL_HI, DL_LO);
  const df L2 = cdf(c, DL2_HI, DL2_LO);

  const df den = df_add(D4[0], ddr[0]);
  const df num = df_add(dqr[0], df_mul(tc, ddr[0]));
  const df dt = df_div(df_scale(num, -1.0f), den);

  df delta[3];
  for (int r = 0; r < 3; ++r) {
    const df d_full = df_add(D4[r], ddr[r]);
    delta[r] = df_add(df_mul(tc, ddr[r]), df_mul(dt, d_full));
    ddet[r] = df_add(dqr[r], delta[r]);
  }
  const df cd = df_mul(tc, dot3(D4, delta));
  const df u = df_add(df_scale(cd, 2.0f), dot3(delta, delta));
  const df s2 = df_add(L2, u);
  const df root = df_sqrt({s2.hi < 0.0f ? 0.0f : s2.hi, s2.lo});
  const df dlast = df_div(u, df_add(L, root));
  *dtot = df_add(dsum, dlast);
}

__global__ void __launch_bounds__(THREADS)
detector_kernel(const float* __restrict__ consts, int n_planes,
                const float* __restrict__ dq_hi, const float* __restrict__ dq_lo,
                const float* __restrict__ dd_hi, const float* __restrict__ dd_lo,
                const float* __restrict__ dsum_hi,
                const float* __restrict__ dsum_lo, long long n,
                float* __restrict__ ddet_hi, float* __restrict__ ddet_lo,
                float* __restrict__ dqr_hi, float* __restrict__ dqr_lo,
                float* __restrict__ ddr_hi, float* __restrict__ ddr_lo,
                float* __restrict__ dtot_hi, float* __restrict__ dtot_lo) {
  __shared__ float sc[MAX_PLANES * N_DCONST];
  for (int k = threadIdx.x; k < n_planes * N_DCONST; k += blockDim.x)
    sc[k] = consts[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  df dq[3], dd[3], R[3][3], dqr[3], ddr[3];
  for (int r = 0; r < 3; ++r) {
    dq[r] = {dq_hi[r * n + i], dq_lo[r * n + i]};
    dd[r] = {dd_hi[r * n + i], dd_lo[r * n + i]};
    for (int q = 0; q < 3; ++q)
      R[r][q] = cdf(sc, DR_HI + 3 * r + q, DR_LO + 3 * r + q);
  }
  const df dsum = {dsum_hi[i], dsum_lo[i]};
  // tilt removal with row 0's rotation (every row carries the same R)
  for (int r = 0; r < 3; ++r) {
    dqr[r] = dot3(R[r], dq);
    ddr[r] = dot3(R[r], dd);
    dqr_hi[r * n + i] = dqr[r].hi;
    dqr_lo[r * n + i] = dqr[r].lo;
    ddr_hi[r * n + i] = ddr[r].hi;
    ddr_lo[r * n + i] = ddr[r].lo;
  }
  for (int p = 0; p < n_planes; ++p) {
    df ddet[3], dtot;
    plane_chain(sc + p * N_DCONST, dqr, ddr, dsum, ddet, &dtot);
    for (int r = 0; r < 3; ++r) {
      const long long row = (long long)(3 * p + r) * n + i;
      ddet_hi[row] = ddet[r].hi;
      ddet_lo[row] = ddet[r].lo;
    }
    dtot_hi[(long long)p * n + i] = dtot.hi;
    dtot_lo[(long long)p * n + i] = dtot.lo;
  }
}

static unsigned int n_blocks(long long n) {
  return (unsigned int)((n + THREADS - 1) / THREADS);
}

// K1's arguments after the constants table and the mirror count
#define K1_PARAMS                                                           \
  const double *dp64, const double *dd64, long long n, float *dq_hi,        \
      float *dq_lo, float *od_hi, float *od_lo, float *dt_hi, float *dt_lo, \
      float *dsum_hi, float *dsum_lo, float *valid
#define K1_ARGS                                                     \
  dp64, dd64, n, dq_hi, dq_lo, od_hi, od_lo, dt_hi, dt_lo, dsum_hi, \
      dsum_lo, valid

// fills the constants symbol from the device table on the launch's
// stream, then launches the instance for N_MIRR mirrors
template <int N_MIRR, int MIN_BLOCKS, bool STREAM>
static int launch_trace(const float* consts, K1_PARAMS, cudaStream_t stream) {
  if (n <= 0) return 0;
  const cudaError_t rc = cudaMemcpyToSymbolAsync(
      c_trace, consts, sizeof(float) * N_MIRR * N_CONST, 0,
      cudaMemcpyDeviceToDevice, stream);
  if (rc != cudaSuccess) return (int)rc;
  trace_deviation_kernel<N_MIRR, MIN_BLOCKS, STREAM>
      <<<n_blocks(n), THREADS, 0, stream>>>(K1_ARGS);
  return (int)cudaGetLastError();
}

#define K1_MIN_BLOCKS 4         // blocks of 256 an SM the registers allow
#define K1_STREAM_STORES false  // __stcs for the outputs

// Plain C entry points, loaded with ctypes.  Each launches on the given
// stream, does not synchronise, and returns the first CUDA error (0 = ok).
// consts is a device pointer.
extern "C" int akbx_trace_deviation(const float* consts, int n_mirr,
                                    K1_PARAMS, void* stream) {
  switch (n_mirr) {
#define CASE(N)                                                   \
  case N:                                                         \
    return launch_trace<N, K1_MIN_BLOCKS, K1_STREAM_STORES>(      \
        consts, K1_ARGS, (cudaStream_t)stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef AKBX_TUNE
// K1 for four mirrors at another occupancy target and with or without
// streaming stores, for timing
extern "C" int akbx_trace_deviation_variant(int min_blocks, int stream_stores,
                                            const float* consts, int n_mirr,
                                            K1_PARAMS, void* stream) {
  if (n_mirr != 4) return (int)cudaErrorInvalidValue;
#define VARIANT(B, S)                             \
  if (min_blocks == B && stream_stores == (int)S) \
    return launch_trace<4, B, S>(consts, K1_ARGS, (cudaStream_t)stream);
  VARIANT(1, false) VARIANT(2, false) VARIANT(3, false) VARIANT(4, false)
  VARIANT(5, false) VARIANT(6, false)
  VARIANT(2, true) VARIANT(3, true) VARIANT(4, true)
#undef VARIANT
  return (int)cudaErrorInvalidValue;
}
#endif

extern "C" int akbx_detector(
    const float* consts, int n_planes, const float* dq_hi,
    const float* dq_lo, const float* dd_hi, const float* dd_lo,
    const float* dsum_hi, const float* dsum_lo, long long n, float* ddet_hi,
    float* ddet_lo, float* dqr_hi, float* dqr_lo, float* ddr_hi,
    float* ddr_lo, float* dtot_hi, float* dtot_lo, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  detector_kernel<<<n_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      consts, n_planes, dq_hi, dq_lo, dd_hi, dd_lo, dsum_hi, dsum_lo, n,
      ddet_hi, ddet_lo, dqr_hi, dqr_lo, ddr_hi, ddr_lo, dtot_hi, dtot_lo);
  return (int)cudaGetLastError();
}
