// tc_pack: the split weight planes of the float32 tensor-core kernels.
//
// The float32 modes of dense_stack.cu (dense_stack and dense_layer),
// stencil.cu and stencil_bwd.cu (the dgrad) multiply in three TF32
// passes over split operands (conv_mma.cuh) and read their
// weights pre-split, as two packed planes [2, G, 9, O, 4]: element [p, g,
// tap, o, e] is the big (p = 0) or small (p = 1) TF32 part of the weight
// of output channel o and reduced channel 4 g + e of the padded reduction
// axis at tap = 3 kt + kf (each source's channels zero-padded to a
// multiple of 4).  pack_tf32_kernel builds both planes from the weight as
// it is, [O, R, 3, 3], or transposed, [R, O, 3, 3], in one launch: one
// thread per element of a plane, both parts from one read, split by
// tc::split_tf32 as the kernels split their windows.  Its plain twin is
// ops/kernels/tc_pack.py's pack_tf32_plain (pack_tc_weights at group 4,
// then tf32_split); the wrapper packs each weight once per version.
//
// The work is a few thousand to ~250,000 floats (the widest dgrad
// weight, 192 x 64 x 9), so a launch is latency, not bandwidth: what it
// replaces is the ~8 PyTorch kernels a weight took to pack and split.
// Writes are coalesced (consecutive threads, consecutive elements); the
// reads gather 9 floats apart and stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "conv_mma.cuh"

namespace misonet {
namespace {

constexpr int kMaxSources = 8;
constexpr int kThreads = 256;

// The sources of the reduction axis: source s has width[s] channels from
// channel c0[s] of the weight and groups of 4 from group g0[s] of a plane.
struct PackSources {
  int n;
  int width[kMaxSources];
  int c0[kMaxSources];
  int g0[kMaxSources + 1];
};

__global__ void __launch_bounds__(kThreads)
pack_tf32_kernel(const float* __restrict__ w, int O, int R, int transpose,
                 PackSources src, float* __restrict__ out) {
  const int per = src.g0[src.n] * 9 * O * 4;  // elements of a plane
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < per;
       i += gridDim.x * kThreads) {
    const int e = i & 3;
    const int gto = i >> 2;
    const int o = gto % O;
    const int gt = gto / O;
    const int g = gt / 9;
    const int tap = gt - 9 * g;
    int s = 0;
    while (s + 1 < src.n && g >= src.g0[s + 1]) ++s;
    const int ch = 4 * (g - src.g0[s]) + e;
    uint32_t x[1] = {0}, big[1], small[1];
    if (ch < src.width[s]) {
      const int r = src.c0[s] + ch;
      const size_t k = transpose ? (size_t)r * O + o : (size_t)o * R + r;
      x[0] = __float_as_uint(__ldg(w + 9 * k + tap));
    }
    tc::split_tf32(x, big, small);
    out[i] = __uint_as_float(big[0]);
    out[per + i] = __uint_as_float(small[0]);
  }
}

}  // namespace
}  // namespace misonet

// Returns a CUDA error code (0 on success); 1 (cudaErrorInvalidValue) for
// no sources, more than 8, or widths that do not sum to R.
extern "C" int misonet_pack_tf32(const float* w, int O, int R, int transpose,
                                 const int* widths, int n_sources, float* out,
                                 void* stream) {
  using namespace misonet;
  if (n_sources < 1 || n_sources > kMaxSources || O < 1)
    return cudaErrorInvalidValue;
  PackSources src{};
  src.n = n_sources;
  int c = 0, g = 0;
  for (int s = 0; s < n_sources; ++s) {
    if (widths[s] < 1) return cudaErrorInvalidValue;
    src.width[s] = widths[s];
    src.c0[s] = c;
    src.g0[s] = g;
    c += widths[s];
    g += (widths[s] + 3) / 4;
  }
  src.g0[n_sources] = g;
  if (c != R) return cudaErrorInvalidValue;
  const int per = g * 9 * O * 4;
  const int blocks = std::min((per + kThreads - 1) / kThreads, 1024);
  pack_tf32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, O, R, transpose, src, out);
  return static_cast<int>(cudaGetLastError());
}
