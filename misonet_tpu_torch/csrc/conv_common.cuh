// Shared pieces of the port's convolution kernels (the tensor-core
// kernels of dense_stack.cu, stencil.cu, stencil_bwd.cu and
// dense_stack_int8.cu): the ELU, the second pass of the InstanceNorm
// statistics, and the loads and stores of the two storage types.
//
// Storage types.  A kernel templated on T in {float, __nv_bfloat16} loads
// T, computes in float32 and stores T.  In the bfloat16 mode (the JAX
// package's precise=False) every operand of a product is a bfloat16 value,
// so each product is exact in float32 and the sums run in float32, as the
// TPU kernels' bf16 x bf16 -> f32 dots do.
//
// Statistics.  Each block reduces sum and sum-of-squares of its valid
// outputs per channel in a fixed order and writes one partial per (batch,
// channel, position tile) (conv_mma.cuh's finish_tile).  A second kernel
// adds the partials of each (batch, channel) in a fixed order in double
// precision, so the statistics are the same from run to run (no atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace misonet {

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
