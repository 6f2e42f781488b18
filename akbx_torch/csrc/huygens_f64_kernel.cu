// The exact-f64 Huygens tile K4 of akbx_torch, for Hopper (sm_90a).
//
// akbx_huygens_f64 replaces no TPU kernel.  akbx's ring
// (akbx/parallel/sharding.py, _wave._huygens_chunk inside its ppermute
// loop) sums each resident source block into the rank's targets in plain
// f64 through XLA, and the port's parallel.sharding.huygens_ring did the
// same through the f64 tile that is now K4's twin (huygens_tile): some
// sixty elementwise f64 PyTorch passes a (chunk x M) tile, each writing
// and re-reading a matrix of the tile's size, then four matrix-vector
// products.  K4 does that tile's arithmetic in one kernel, keeping every
// intermediate in registers.  It was added because the ring, on four
// cards, ran 24.7x slower per stage than K3 does on one: the card was
// busy with memory traffic of intermediates, not with the sum.
//
// For every target i it adds into acc_re[i], acc_im[i]
//
//   sum_j (w_re_j + i w_im_j) exp(-i k r_ij) / r_ij
//
// with the twin's operations in the twin's order per pair, all in f64
// (kernels/huygens_f64.py::huygens_f64_reference, huygens_tile):
// dx, dy, dz; r = sqrt((dx dx + dy dy) + dz dz) with IEEE sqrt; the exact
// product k r as a double-word pair (mul and __fma_rn, the same pair as
// the twin's Dekker form); n = rint(-k r_hi / TWO_PI_HI) with IEEE
// division (rint rounds half to even, as torch.round); the double-word
// reduction of core/trig.py::sincos_reduced; f64 sincos of the reduced
// phase; 1/r as IEEE reciprocal; and the complex multiply-accumulate.
// Every add and multiply is an explicit round-to-nearest intrinsic, the
// build passes -fmad=false and never --use_fast_math, and no float32
// appears.  r, the phase and 1/r are the twin's bit for bit; sin and cos
// may differ from the twin's libm by an ulp, and the sums are taken in
// another order.  A zero-weight source adds +-0 to each sum, so padding
// leaves the sums as they are.
//
// What bounds it on this card: the f64 instruction rate.  A pair is 57
// operations counted on the twin (a division, a square root, a sine
// counted as one; a two_prod as 2; the contraction as 4 FMAs) and about
// 100 f64 instructions as the card runs them, against 40 bytes a source
// and 24 a target; the H100 SXM issues 1.675e13 f64 instructions a second
// (33.5 TFLOP/s, an FMA counted once).  So the design serves the f64
// pipes:
//
//  - Both the targets and the sources are split.  A block takes K4_BLOCK
//    targets and one split of K4_SPLIT sources, so the ring's 16,520 x
//    16,520 tile is 65 x 33 blocks and the card holds four a SM; a grid
//    over targets alone would be 65 blocks on 132 SMs.
//  - Each split writes its f64 partial sums to a scratch buffer that the
//    wrapper allocates; a second small kernel adds them, in split order,
//    and adds that into the accumulators.  No atomics, so runs repeat bit
//    for bit, and the split of the sources depends on nothing but m.
//  - The split's sources stream through shared memory in tiles of
//    K4_TILE, as five f64 rows (x, y, z, w_re, w_im): every lane reads the
//    same source, a broadcast.
//  - Each thread keeps one target and its f64 sums in registers, and
//    the SM holds 32 warps of such threads (64 registers each) for the
//    scheduler to interleave.  Two or four targets a thread, each shared
//    read feeding as many pair chains, took 126 and 142 registers, so 16
//    or 12 warps an SM, and measured 9 and 25 % slower at the ring's tile
//    (NVIDIA H100 80GB HBM3, 700 W): a pair's ~100 f64 instructions dwarf
//    its five broadcast reads.
//  - It launches on the caller's stream (PyTorch's current stream), so the
//    ring's batch_isend_irecv still overlaps the sum.

#include <cuda_runtime.h>

#define K4_BLOCK 256      // threads per block, a target each
#define K4_TILE 256       // sources per shared-memory tile
#define K4_SPLIT 512      // sources per partial sum (huygens_f64.py::SPLIT)
#define K4_MIN_BLOCKS 4   // blocks an SM should hold (64 registers a thread)
#define K4_REDUCE 256     // threads per block of the second pass

// 2 pi = TWO_PI_HI + TWO_PI_LO (core/trig.py)
#define TWO_PI_HI 0x1.921fb54442d18p+2
#define TWO_PI_LO 0x1.1a62633145c07p-52

// a double-word f64 number hi + lo (core/precision.py::DF)
struct dw {
  double hi, lo;
};

__device__ __forceinline__ dw two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  const double bb = __dsub_rn(s, a);
  return {s, __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb))};
}

__device__ __forceinline__ dw fast_two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  return {s, __dsub_rn(b, __dsub_rn(s, a))};
}

// precision.py::df_add
__device__ __forceinline__ dw dw_add(dw x, dw y) {
  const dw s = two_sum(x.hi, y.hi);
  const dw t = two_sum(x.lo, y.lo);
  const dw v = fast_two_sum(s.hi, __dadd_rn(s.lo, t.hi));
  return fast_two_sum(v.hi, __dadd_rn(t.lo, v.lo));
}

// precision.py::df_add_f
__device__ __forceinline__ dw dw_add_d(dw x, double y) {
  const dw s = two_sum(x.hi, y);
  return fast_two_sum(s.hi, __dadd_rn(s.lo, x.lo));
}

// one (target, source) pair added into the target's sums
// (huygens_f64.py::huygens_tile, trig.py::sincos_reduced)
__device__ __forceinline__ void add_pair(double tx, double ty, double tz,
                                         double sx, double sy, double sz,
                                         double wr, double wi, double k,
                                         double* re, double* im) {
  const double dx = __dsub_rn(tx, sx);
  const double dy = __dsub_rn(ty, sy);
  const double dz = __dsub_rn(tz, sz);
  const double r = __dsqrt_rn(__dadd_rn(
      __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz)));
  // the phase -k r as the negated exact product
  const double kr = __dmul_rn(k, r);
  const dw phase = {-kr, -__fma_rn(k, r, -kr)};
  // phase - n 2pi in double-word
  const double n = rint(__ddiv_rn(phase.hi, TWO_PI_HI));
  const double t_hi = __dmul_rn(n, TWO_PI_HI);
  const double t_lo = __fma_rn(n, TWO_PI_HI, -t_hi);
  const dw red = dw_add_d(dw_add(phase, {-t_hi, -t_lo}),
                          __dmul_rn(-n, TWO_PI_LO));
  double s, c;
  sincos(__dadd_rn(red.hi, red.lo), &s, &c);
  const double inv_r = __drcp_rn(r);
  const double cr = __dmul_rn(c, inv_r);
  const double sr = __dmul_rn(s, inv_r);
  *re = __fma_rn(-sr, wi, __fma_rn(cr, wr, *re));
  *im = __fma_rn(cr, wi, __fma_rn(sr, wr, *im));
}

// Block (x, y): targets [x K4_BLOCK, (x + 1) K4_BLOCK) and sources
// [y K4_SPLIT, (y + 1) K4_SPLIT); writes the split's sums to part rows
// 2y (re) and 2y + 1 (im), each of n.
__global__ void __launch_bounds__(K4_BLOCK, K4_MIN_BLOCKS)
huygens_f64_kernel(const double* __restrict__ tgt, long long ld, long long n,
                   const double* __restrict__ src,
                   const double* __restrict__ w_re,
                   const double* __restrict__ w_im, long long m, double k,
                   double* __restrict__ part) {
  __shared__ double s[5][K4_TILE];
  const long long i = (long long)blockIdx.x * K4_BLOCK + threadIdx.x;
  const bool live = i < n;
  const double tx = live ? tgt[i] : 0.0;
  const double ty = live ? tgt[ld + i] : 0.0;
  const double tz = live ? tgt[2 * ld + i] : 0.0;
  double re = 0.0, im = 0.0;
  const long long j0 = (long long)blockIdx.y * K4_SPLIT;
  const long long j1 = j0 + K4_SPLIT < m ? j0 + K4_SPLIT : m;
  for (long long base = j0; base < j1; base += K4_TILE) {
    const int len = (int)(j1 - base < K4_TILE ? j1 - base : K4_TILE);
    __syncthreads();  // every thread is done with the last tile
    for (int q = threadIdx.x; q < len; q += K4_BLOCK) {
      s[0][q] = src[base + q];
      s[1][q] = src[m + base + q];
      s[2][q] = src[2 * m + base + q];
      s[3][q] = w_re[base + q];
      s[4][q] = w_im[base + q];
    }
    __syncthreads();
    for (int q = 0; q < len; ++q)
      add_pair(tx, ty, tz, s[0][q], s[1][q], s[2][q], s[3][q], s[4][q], k,
               &re, &im);
  }
  if (live) {
    double* out = part + 2 * (long long)blockIdx.y * n;
    out[i] = re;
    out[n + i] = im;
  }
}

// acc[i] += the sum of the splits' partial sums, in split order
__global__ void __launch_bounds__(K4_REDUCE)
huygens_f64_reduce(const double* __restrict__ part, long long n, int splits,
                   double* __restrict__ acc_re, double* __restrict__ acc_im) {
  const long long i = (long long)blockIdx.x * K4_REDUCE + threadIdx.x;
  if (i >= n) return;
  double re = part[i], im = part[n + i];
  for (int y = 1; y < splits; ++y) {
    re = __dadd_rn(re, part[2LL * y * n + i]);
    im = __dadd_rn(im, part[(2LL * y + 1) * n + i]);
  }
  acc_re[i] = __dadd_rn(acc_re[i], re);
  acc_im[i] = __dadd_rn(acc_im[i], im);
}

// Plain C entry point, loaded with ctypes.  tgt: three f64 rows x, y, z
// of n targets, ld apart; src: (3, m) f64 rows x, y, z; w_re, w_im: (m,)
// f64 weights (ds included); k the wavenumber by value; part: scratch of
// 2 ceil(m / K4_SPLIT) rows of n f64; acc_re, acc_im: (n,) f64, added
// into.  Launches both passes on the given stream, does not synchronise,
// and returns cudaGetLastError() (0 = ok).
extern "C" int akbx_huygens_f64(const double* tgt, long long ld, long long n,
                                const double* src, const double* w_re,
                                const double* w_im, long long m, double k,
                                double* part, double* acc_re, double* acc_im,
                                void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const long long splits = (m + K4_SPLIT - 1) / K4_SPLIT;
  const long long blocks = (n + K4_BLOCK - 1) / K4_BLOCK;
  if (splits > 65535 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  huygens_f64_kernel<<<dim3((unsigned int)blocks, (unsigned int)splits),
                       K4_BLOCK, 0, st>>>(tgt, ld, n, src, w_re, w_im, m, k,
                                          part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  huygens_f64_reduce<<<(unsigned int)((n + K4_REDUCE - 1) / K4_REDUCE),
                       K4_REDUCE, 0, st>>>(part, n, (int)splits, acc_re,
                                           acc_im);
  return (int)cudaGetLastError();
}
