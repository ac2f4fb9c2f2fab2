// hermitian_chol: one small complex Hermitian solve, (A + diag I) x = b, in
// registers.  Shared by hermitian_solve_kernel (csrc/hermitian_solve.cu) and
// mvdr_weights_kernel (csrc/mvdr_weights.cu), so both run one
// implementation.
//
// The arithmetic of misonet_tpu/ops/pallas/mvdr_solve.py::_solve_kernel, in
// its order: an unrolled complex Cholesky A + diag I = L L^H reading only the
// real part of A's diagonal and its strict lower triangle a[i][j], i > j;
// each pivot clamped at 1e-30 before the square root; rows scaled by the
// reciprocal pivot; then forward (L y = b) and back (L^H x = y)
// substitution.  `a` is row-major M x M complex (float2 pairs), wherever it
// lives (shared memory in both kernels); M is a template parameter, so L, y
// and x stay in registers.

#pragma once

#include <cuda_runtime.h>

namespace misonet {

template <int M>
__device__ __forceinline__ void hermitian_chol_solve(const float2* a,
                                                     const float2 (&b)[M],
                                                     float diag,
                                                     float2 (&x)[M]) {
  // ---- Cholesky: A + diag I = L L^H (lower triangle of L, i > j) ----
  float lr[M][M], li[M][M], inv[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float ajj = a[j * M + j].x + diag;
#pragma unroll
    for (int k = 0; k < j; ++k)
      ajj = ajj - (lr[j][k] * lr[j][k] + li[j][k] * li[j][k]);
    inv[j] = 1.f / sqrtf(fmaxf(ajj, 1e-30f));
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      float sr = a[i * M + j].x, si = a[i * M + j].y;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        // s -= L[i,k] * conj(L[j,k])
        sr = sr - (lr[i][k] * lr[j][k] + li[i][k] * li[j][k]);
        si = si - (li[i][k] * lr[j][k] - lr[i][k] * li[j][k]);
      }
      lr[i][j] = sr * inv[j];
      li[i][j] = si * inv[j];
    }
  }
  // ---- forward substitution: L y = b ----
  float yr[M], yi[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float sr = b[j].x, si = b[j].y;
#pragma unroll
    for (int k = 0; k < j; ++k) {
      sr = sr - (lr[j][k] * yr[k] - li[j][k] * yi[k]);
      si = si - (lr[j][k] * yi[k] + li[j][k] * yr[k]);
    }
    yr[j] = sr * inv[j];
    yi[j] = si * inv[j];
  }
  // ---- back substitution: L^H x = y ----
  float xr[M], xi[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float sr = yr[i], si = yi[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) {
      // s -= conj(L[k,i]) * x[k]
      sr = sr - (lr[k][i] * xr[k] + li[k][i] * xi[k]);
      si = si - (lr[k][i] * xi[k] - li[k][i] * xr[k]);
    }
    xr[i] = sr * inv[i];
    xi[i] = si * inv[i];
  }
#pragma unroll
  for (int j = 0; j < M; ++j) x[j] = make_float2(xr[j], xi[j]);
}

}  // namespace misonet
