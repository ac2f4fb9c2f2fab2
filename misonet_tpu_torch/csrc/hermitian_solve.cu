// hermitian_solve: batched small complex Hermitian solves on Hopper.
//
// Replaces misonet_tpu/ops/pallas/mvdr_solve.py::hermitian_solve_pallas (its
// Pallas `_solve_kernel`): for each of n systems, (R + diag I) x = d with R
// an M x M complex Hermitian positive-definite matrix (M = 6 mics on the MVDR
// path), by an unrolled complex Cholesky R + diag I = L L^H, then forward
// (L y = d) and back (L^H x = y) substitution.  The arithmetic is the TPU
// kernel's, in its order (csrc/hermitian_chol.cuh, which mvdr_weights_kernel
// shares).  The MVDR normalization x / (d^H x) stays with the caller.
//
// The TPU kernel laid the batch across vector lanes ([M, M, N] re/im planes,
// padded to 8,192 systems).  Here one thread solves one system, with M a
// template parameter so L, y and x live in registers; the inputs are read in
// place as complex64 [n, M, M] and [n, M] (float2 pairs), no re/im planes,
// no padding.
//
// Bound on the H100: a system reads 288 + 48 bytes and writes 48 (M = 6) and
// does ~600 flops, so the kernel is memory-bound (~0.12 us for the 1,032
// systems of a 12.3 s request at 3.35 TB/s) and, on the serving path,
// launch-bound.  One thread's matrix sits at a 288-byte stride, so reading
// it straight from global memory would be 36 uncoalesced loads per thread.
// Instead each block of NT threads stages its NT matrices and right-hand
// sides in shared memory with coalesced 8-byte loads (consecutive threads,
// consecutive complex entries), solves from there, and writes x back the
// same way.  Staged rows are padded to an odd number of float2 so that the
// threads' strided reads fall on distinct banks.

#include <cuda_runtime.h>

#include "hermitian_chol.cuh"

namespace misonet {
namespace {

constexpr int NT = 64;  // systems (threads) per block: 38 KB staged at M = 8

template <int M>
__global__ void __launch_bounds__(NT)
hermitian_solve_kernel(const float2* __restrict__ r,
                       const float2* __restrict__ d, float2* __restrict__ x,
                       float diag, long long n) {
  constexpr int MM = M * M;
  constexpr int SR = MM | 1;  // odd strides: conflict-free 8-byte reads
  constexpr int SD = M | 1;
  __shared__ float2 rs[NT * SR];
  __shared__ float2 ds[NT * SD];
  const long long base = (long long)blockIdx.x * NT;
  const int cnt = (int)min((long long)NT, n - base);

  const float2* rb = r + base * MM;
  for (int k = threadIdx.x; k < cnt * MM; k += NT)
    rs[(k / MM) * SR + k % MM] = __ldg(rb + k);
  const float2* db = d + base * M;
  for (int k = threadIdx.x; k < cnt * M; k += NT)
    ds[(k / M) * SD + k % M] = __ldg(db + k);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < cnt) {
    float2* v = ds + t * SD;
    float2 b[M], xt[M];
#pragma unroll
    for (int j = 0; j < M; ++j) b[j] = v[j];
    hermitian_chol_solve<M>(rs + t * SR, b, diag, xt);
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = xt[j];
  }
  __syncthreads();

  float2* xb = x + base * M;
  for (int k = threadIdx.x; k < cnt * M; k += NT)
    xb[k] = ds[(k / M) * SD + k % M];
}

template <int M>
cudaError_t launch(const float2* r, const float2* d, float2* x, float diag,
                   long long n, cudaStream_t st) {
  const long long blocks = (n + NT - 1) / NT;
  hermitian_solve_kernel<M><<<(unsigned)blocks, NT, 0, st>>>(r, d, x, diag, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace misonet

// C entry point.  All tensors complex64 (float2 pairs), contiguous, on the
// current device: r [n, m, m], d [n, m], x [n, m] (output).  Solves
// (r + diag I) x = d per system, reading the real diagonal and the strict
// lower triangle of r.  Returns cudaGetLastError() after the launch (0 on
// success); m outside 2..8 returns cudaErrorInvalidValue; n = 0 launches
// nothing.
extern "C" int misonet_hermitian_solve(int m, const void* r, const void* d,
                                       void* x, float diag, long long n,
                                       void* stream) {
  using namespace misonet;
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* rr = static_cast<const float2*>(r);
  const auto* dd = static_cast<const float2*>(d);
  auto* xx = static_cast<float2*>(x);
  switch (m) {
    case 2: return (int)launch<2>(rr, dd, xx, diag, n, st);
    case 3: return (int)launch<3>(rr, dd, xx, diag, n, st);
    case 4: return (int)launch<4>(rr, dd, xx, diag, n, st);
    case 5: return (int)launch<5>(rr, dd, xx, diag, n, st);
    case 6: return (int)launch<6>(rr, dd, xx, diag, n, st);
    case 7: return (int)launch<7>(rr, dd, xx, diag, n, st);
    case 8: return (int)launch<8>(rr, dd, xx, diag, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
