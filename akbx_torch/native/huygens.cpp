// Native CPU Huygens-Fresnel engine of akbx_torch (backend="native").
//
// The exact-f64 host engine: C++ with OpenMP over targets and an
// auto-vectorizable inner loop, for the O(N*M) sum that the reference
// runs with numba prange on the CPU.  It runs on the host because the
// caller names it; the card's engine is the K3 kernel.
//
// Exposed with a plain C ABI for ctypes.

#include <cmath>
#include <cstdint>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// u[i] = sum_j w[j] * exp(-i k r_ij) / r_ij over source points j.
// tgt: 3*n doubles laid out x[0..n), y[0..n), z[0..n) (row-major (3, n));
// src likewise 3*m; w_re/w_im are the source amplitudes premultiplied by
// the ds quadrature weights.
void huygens_propagate(const double* tgt, int64_t n,
                       const double* src, int64_t m,
                       const double* w_re, const double* w_im,
                       double k,
                       double* out_re, double* out_im) {
  const double* tx = tgt;
  const double* ty = tgt + n;
  const double* tz = tgt + 2 * n;
  const double* sx = src;
  const double* sy = src + m;
  const double* sz = src + 2 * m;

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double acc_re = 0.0;
    double acc_im = 0.0;
    const double xi = tx[i];
    const double yi = ty[i];
    const double zi = tz[i];
#pragma omp simd reduction(+ : acc_re, acc_im)
    for (int64_t j = 0; j < m; ++j) {
      const double dx = xi - sx[j];
      const double dy = yi - sy[j];
      const double dz = zi - sz[j];
      const double r = std::sqrt(dx * dx + dy * dy + dz * dz);
      const double phase = -k * r;
      const double c = std::cos(phase);
      const double s = std::sin(phase);
      const double inv_r = 1.0 / r;
      // (w_re + i w_im) * (c + i s) / r
      acc_re += (w_re[j] * c - w_im[j] * s) * inv_r;
      acc_im += (w_re[j] * s + w_im[j] * c) * inv_r;
    }
    out_re[i] = acc_re;
    out_im[i] = acc_im;
  }
}

// Per-point quadrature weights from 4 neighbor triangles (the reference's
// calc_dS, AKB_raytrace_20250312.py:13418-13473) — C++ for the large-grid
// export path.
void calc_ds(const double* pts, int64_t n_v, int64_t n_h, double* out) {
  const int64_t n = n_v * n_h;
  const double* px = pts;
  const double* py = pts + n;
  const double* pz = pts + 2 * n;

  auto tri = [&](int64_t a, int64_t b, int64_t c) {
    const double e1x = px[b] - px[a], e1y = py[b] - py[a], e1z = pz[b] - pz[a];
    const double e2x = px[c] - px[a], e2y = py[c] - py[a], e2z = pz[c] - pz[a];
    const double cx = e1y * e2z - e1z * e2y;
    const double cy = e1z * e2x - e1x * e2z;
    const double cz = e1x * e2y - e1y * e2x;
    return 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
  };

#pragma omp parallel for schedule(static)
  for (int64_t i = 1; i < n_v - 1; ++i) {
    for (int64_t j = 1; j < n_h - 1; ++j) {
      const int64_t p = i * n_h + j;
      const int64_t right = p + 1, left = p - 1;
      const int64_t up = p - n_h, down = p + n_h;
      out[p] = tri(p, right, up) + tri(p, up, left) + tri(p, left, down) +
               tri(p, down, right);
    }
  }
  // edges copy the nearest interior value
  for (int64_t j = 0; j < n_h; ++j) {
    out[j] = out[n_h + j];
    out[(n_v - 1) * n_h + j] = out[(n_v - 2) * n_h + j];
  }
  for (int64_t i = 0; i < n_v; ++i) {
    out[i * n_h] = out[i * n_h + 1];
    out[i * n_h + n_h - 1] = out[i * n_h + n_h - 2];
  }
  out[0] = out[n_h + 1];
  out[n_h - 1] = out[n_h + n_h - 2];
  out[(n_v - 1) * n_h] = out[(n_v - 2) * n_h + 1];
  out[n_v * n_h - 1] = out[(n_v - 2) * n_h + n_h - 2];
}

int num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
