// Shared pieces of the port's direct-convolution kernels (dense_stack.cu,
// stencil.cu, dense_stack_int8.cu): the block tiling constants, the
// shared-memory weight staging, the ELU, the two-pass InstanceNorm
// statistics, and the loads and stores of the two storage types.
//
// Storage types.  A kernel templated on T in {float, __nv_bfloat16} loads
// T, computes in float32 and stores T.  In the bfloat16 mode (the JAX
// package's precise=False) every operand of a product is a bfloat16 value
// (round_as<T>), so each product is exact in float32 and the sums run in
// float32, as the TPU kernels' bf16 x bf16 -> f32 dots do.
//
// Tiling.  A block computes NB = 32 output channels at POS_TILE = 256
// positions of one batch element's flattened [T, F] output plane.  Its
// threads split into two halves of "lanes"; a thread holds a register tile
// of NT = 16 channels (its half) x PT positions (lane, lane + LANES, ...),
// and reads its 16 weights per (channel, tap) as four float4 broadcasts
// from shared memory.
//
// Statistics.  Each block reduces sum and sum-of-squares of its valid
// outputs per channel (warp shuffles, then shared memory) and writes one
// partial per (batch, channel, position tile).  A second kernel adds the
// partials of each (batch, channel) in a fixed order in double precision,
// so the statistics are the same from run to run (no atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace misonet {

constexpr int NB = 32;          // output channels per block
constexpr int NT = 16;          // output channels per thread
constexpr int POS_TILE = 256;   // output positions per block
// Floats per staged (channel, tap) row of weights: NB padded by 4, so the
// staging stores of a warp, which walk down rows at a fixed channel n,
// spread over 8 banks instead of one, and each row stays 16-byte aligned
// for the float4 reads.
constexpr int WS_ROW = NB + 4;

__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expm1f(z);
}

// Read-only loads of either storage type, widened to float32.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Stores of a float32 value in either storage type (round to nearest even).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to the precision of T (the identity for float).
template <typename T>
__device__ __forceinline__ float round_as(float v);
template <>
__device__ __forceinline__ float round_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ws[k][tap][nn] (nn < NB) = w[n0 + nn, c_begin + k, tap] for a weight
// tensor laid out [N, C, 3, 3], or w[c_begin + k, n0 + nn, tap] for one
// laid out [C, N, 3, 3] (TRANSPOSED: torch's ConvTranspose2d weight, read
// as it is); zero for channels past N or past the chunk of CK.
// Consecutive threads read consecutive values of w in both layouts; W is
// the weights' storage type.
template <int CK, int THREADS, bool TRANSPOSED = false, typename W>
__device__ __forceinline__ void stage_weights(float (*ws)[9][WS_ROW],
                                              const W* __restrict__ w,
                                              int N, int C, int n0,
                                              int c_begin, int ck) {
  for (int i = threadIdx.x; i < CK * 9 * NB; i += THREADS) {
    const int tap = i % 9;
    const int r = i / 9;
    const int k = TRANSPOSED ? r / NB : r % CK;
    const int nn = TRANSPOSED ? r % NB : r / CK;
    const int n = n0 + nn;
    float v = 0.f;
    if (n < N && k < ck) {
      const size_t row = TRANSPOSED ? (size_t)(c_begin + k) * N + n
                                    : (size_t)n * C + c_begin + k;
      v = ldg_f32(w + row * 9 + tap);
    }
    ws[k][tap][nn] = v;
  }
}

// acc[i][j] += w[half*16 + i] * xv[j] for one (channel, tap), the 16
// weights read as four float4 broadcasts from shared memory.
template <int PT>
__device__ __forceinline__ void fma_tap(float (&acc)[NT][PT],
                                        const float* __restrict__ wt,
                                        const float (&xv)[PT]) {
  const float4* w4 = reinterpret_cast<const float4*>(wt);
#pragma unroll
  for (int q = 0; q < NT / 4; ++q) {
    const float4 wv = w4[q];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      acc[4 * q + 0][j] = fmaf(wv.x, xv[j], acc[4 * q + 0][j]);
      acc[4 * q + 1][j] = fmaf(wv.y, xv[j], acc[4 * q + 1][j]);
      acc[4 * q + 2][j] = fmaf(wv.z, xv[j], acc[4 * q + 2][j]);
      acc[4 * q + 3][j] = fmaf(wv.w, xv[j], acc[4 * q + 3][j]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reduce s[i], q[i] over the lanes of each half (THREADS / 2 of them) and
// write the block's partials for channels n0 + half*16 + i < n_stats:
//   part[(0*rows + b*n_stats + n) * ntiles + tile] = sum
//   part[(1*rows + b*n_stats + n) * ntiles + tile] = sum of squares
// with rows = B * n_stats.  Must be reached by every thread of the block.
template <int THREADS>
__device__ __forceinline__ void block_stats(float (&s)[NT], float (&q)[NT],
                                            float* __restrict__ part, int b,
                                            int B, int n0, int n_stats,
                                            int tile, int ntiles) {
  __shared__ float red_s[THREADS / 32][NT];
  __shared__ float red_q[THREADS / 32][NT];
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float vs = warp_sum(s[i]);
    const float vq = warp_sum(q[i]);
    if ((threadIdx.x & 31) == 0) {
      red_s[warp][i] = vs;
      red_q[warp][i] = vq;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * NT) {
    const int h = threadIdx.x / NT;
    const int i = threadIdx.x % NT;
    const int n = n0 + h * NT + i;
    if (n < n_stats) {
      float ts = 0.f, tq = 0.f;
      constexpr int kWarpsPerHalf = THREADS / 64;
      for (int w = 0; w < kWarpsPerHalf; ++w) {
        ts += red_s[h * kWarpsPerHalf + w][i];
        tq += red_q[h * kWarpsPerHalf + w][i];
      }
      const size_t rows = (size_t)B * n_stats;
      const size_t r = (size_t)b * n_stats + n;
      part[r * ntiles + tile] = ts;
      part[(rows + r) * ntiles + tile] = tq;
    }
  }
}

namespace {

// Second pass: one warp per (batch, channel) row; each lane adds every
// 32nd tile partial in order, then a fixed butterfly combines the lanes,
// all in double.
__global__ void reduce_stats_kernel(const float* __restrict__ part,
                                    float* __restrict__ sums,
                                    float* __restrict__ sqs, int rows,
                                    int ntiles) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps leave together
  double ts = 0.0, tq = 0.0;
  for (int t = lane; t < ntiles; t += 32) {
    ts += part[(size_t)r * ntiles + t];
    tq += part[((size_t)rows + r) * ntiles + t];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ts += __shfl_xor_sync(0xffffffffu, ts, o);
    tq += __shfl_xor_sync(0xffffffffu, tq, o);
  }
  if (lane == 0) {
    sums[r] = (float)ts;
    sqs[r] = (float)tq;
  }
}

inline cudaError_t launch_reduce_stats(const float* part, float* sums,
                                       float* sqs, int rows, int ntiles,
                                       cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  constexpr int kRowsPerBlock = 8;
  reduce_stats_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock,
                        32 * kRowsPerBlock, 0, stream>>>(part, sums, sqs,
                                                         rows, ntiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace misonet
