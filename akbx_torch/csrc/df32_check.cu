// A test entry point of akbx_torch's kernel library: df32.cuh's two_prod
// on arrays, so that the card's FMA form can be held bit for bit against
// the PyTorch twin (akbx_torch/core/precision.py::two_prod).  No kernel
// of the port's paths calls it.

#include <cuda_runtime.h>

#include "df32.cuh"

__global__ void two_prod_kernel(const float* __restrict__ a,
                                const float* __restrict__ b, long long n,
                                float* __restrict__ hi,
                                float* __restrict__ lo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const df p = two_prod(a[i], b[i]);
  hi[i] = p.hi;
  lo[i] = p.lo;
}

// a, b, hi, lo: (n,) f32 on the device.  Launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 = ok).
extern "C" int akbx_two_prod(const float* a, const float* b, long long n,
                             float* hi, float* lo, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + 255) / 256);
  two_prod_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(a, b, n, hi, lo);
  return (int)cudaGetLastError();
}
