// dense_stack: one input-grouped ("stacked") DenseBlock call on Hopper.
//
// Replaces misonet_tpu/ops/pallas/dense_stack.py::dense_stack_flat (its
// Pallas `_kernel`), float32 ("precise") mode.  For the newly available
// source tensor(s) x_s (1 or 2 raw tensors [B, c_i, T, F]; the decoder's skip
// concat stays logical) it computes
//
//   z = conv3x3_SAME(normalize(x_s), w_stack) (+ acc_in)
//   y       = ELU(z[:n_fin] + bias)          -> [B, n_fin, T, F]
//   sum/sq  = per-(b, c) sums of y, y^2      -> [B, n_fin]
//   acc_out = z[n_fin:]                      -> [B, N - n_fin, T, F]
//
// with normalize(x) = (x - mean) * scale per (b, c), and zero padding of the
// NORMALIZED input (the halo check below contributes 0), which replaces the
// TPU kernel's mean-correction indicator fields.  The lane-flattened
// framing, lane rotations and pack_plan of the TPU version do not exist
// here: tensors stay plain NCHW.
//
// Bound on the H100: float32 FMA issue (no tensor cores in this version;
// N = 24..192 channels and K = 9 * (24..64) per call).  So the inner loop
// is kept to FMAs: per block, each chunk of CK source channels is staged in
// shared memory already normalized, as the flat run of input rows the
// tile's outputs read (tile rows plus one above and below, zeros outside
// the plane), so a tap is one shared load at an immediate offset, masked
// only at the row's first and last column.  A thread holds 16 channels x 2
// positions and reads its 16 weights per tap as four float4 broadcasts.
// What limits it is latency hiding, not instruction count: a tile sweep on
// the H100 (PERF.md) found 256 threads capped at 64 registers, so 4
// blocks (32 warps) share an SM, 1.4x faster than larger register tiles at
// fewer warps.  The partial
// accumulator has to leave the kernel between calls (layer s+1 needs layer
// s's global InstanceNorm statistics), so acc_in/acc_out round-trip device
// memory.  Statistics: two passes, see conv_common.cuh.

#include "conv_common.cuh"

namespace misonet {
namespace {

constexpr int PT = 2;                  // output positions per thread
constexpr int LANES = POS_TILE / PT;   // position lanes per channel half
constexpr int THREADS = 2 * LANES;     // two 16-channel halves
constexpr int CK = 8;                  // source channels staged per round
constexpr int MIN_BLOCKS = 4;          // per SM: caps registers at 64

// Floats staged per source channel: the rows a tile of POS_TILE flattened
// positions spans, plus one row above and one below.
inline int stage_floats(int F) { return ((POS_TILE - 1) / F + 4) * F; }

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_stack_kernel(const float* __restrict__ x0, int c0,
                   const float* __restrict__ x1, int c1,
                   const float* __restrict__ scale,
                   const float* __restrict__ mean,
                   const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ acc_in,
                   float* __restrict__ y,
                   float* __restrict__ acc_out,
                   float* __restrict__ part,
                   int T, int F, int N, int n_fin, int xs_ch) {
  extern __shared__ __align__(16) float smem[];
  float (*ws)[9][WS_ROW] = reinterpret_cast<float (*)[9][WS_ROW]>(smem);
  float* xs = smem + CK * 9 * WS_ROW;  // CK staged channels of xs_ch floats
  const int half = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int C = c0 + c1;
  const int TF = T * F;

  // staged run: rows r0-1 .. r1+1 of the plane, flat from index g0
  const int p0 = tile * POS_TILE;
  const int r0 = p0 / F;
  const int r1 = (min(p0 + POS_TILE, TF) - 1) / F;
  const int g0 = (r0 - 1) * F;
  const int n_stage = (r1 - r0 + 3) * F;

  int pos[PT], li[PT];
  bool pv[PT], has_left[PT], has_right[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    pos[j] = p0 + j * LANES + lane;
    pv[j] = pos[j] < TF;
    const int pc = pv[j] ? pos[j] : TF - 1;  // ragged tail reads in range
    const int f = pc % F;
    li[j] = pc - g0;
    has_left[j] = f > 0;
    has_right[j] = f < F - 1;
  }

  float acc[NT][PT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < 2; ++s) {
    const float* xsrc = s ? x1 : x0;
    const int cs = s ? c1 : c0;
    const int coff = s ? c0 : 0;
    for (int cb = 0; cb < cs; cb += CK) {
      const int ck = min(CK, cs - cb);
      __syncthreads();  // the previous chunk is consumed
      stage_weights<CK, THREADS>(ws, w, N, C, n0, coff + cb, ck);
      for (int k = 0; k < ck; ++k) {
        const float sc = scale[b * C + coff + cb + k];
        const float mu = mean[b * C + coff + cb + k];
        const float* xp = xsrc + ((size_t)b * cs + cb + k) * TF;
        float* dst = xs + k * xs_ch;
        for (int i = threadIdx.x; i < n_stage; i += THREADS) {
          const int gi = g0 + i;
          dst[i] = (gi >= 0 && gi < TF) ? (__ldg(xp + gi) - mu) * sc : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        if (k >= ck) break;
        const float* xk = xs + k * xs_ch;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const float* row[PT];
#pragma unroll
          for (int j = 0; j < PT; ++j) row[j] = xk + li[j] + (dt - 1) * F;
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            float xv[PT];
#pragma unroll
            for (int j = 0; j < PT; ++j) {
              const float v = row[j][df - 1];
              const bool ok = df == 0 ? has_left[j]
                            : df == 2 ? has_right[j] : true;
              xv[j] = ok ? v : 0.f;
            }
            fma_tap<PT>(acc, &ws[k][dt * 3 + df][half * NT], xv);
          }
        }
      }
    }
  }

  // epilogue: finalize rows < n_fin, pass the rest on as partials
  float su[NT], sq[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    su[i] = 0.f;
    sq[i] = 0.f;
    const int n = n0 + half * NT + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      if (!pv[j]) continue;
      float z = acc[i][j];
      if (acc_in) z += acc_in[((size_t)b * N + n) * TF + pos[j]];
      if (n < n_fin) {
        const float v = elu(z + bias[n]);
        y[((size_t)b * n_fin + n) * TF + pos[j]] = v;
        su[i] += v;
        sq[i] += v * v;
      } else {
        acc_out[((size_t)b * (N - n_fin) + (n - n_fin)) * TF + pos[j]] = z;
      }
    }
  }
  if (n0 < n_fin)  // block-uniform
    block_stats<THREADS>(su, sq, part, b, B, n0, n_fin, tile, gridDim.x);
}

}  // namespace
}  // namespace misonet

// C entry point.  All tensors float32, contiguous, on the current device:
//   x0 [B, c0, T, F], x1 [B, c1, T, F] or NULL (c1 = 0),
//   scale, mean [B, c0 + c1], w [N, c0 + c1, 3, 3], bias [n_fin],
//   acc_in [B, N, T, F] or NULL, y [B, n_fin, T, F],
//   acc_out [B, N - n_fin, T, F] or NULL when N == n_fin,
//   part [2, B, n_fin, ntiles] scratch with ntiles = ceil(T*F / 256),
//   sums, sqs [B, n_fin].
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int misonet_dense_stack(const float* x0, int c0, const float* x1,
                                   int c1, const float* scale,
                                   const float* mean, const float* w,
                                   const float* bias, const float* acc_in,
                                   float* y, float* acc_out, float* part,
                                   float* sums, float* sqs, int B, int T,
                                   int F, int N, int n_fin, void* stream) {
  using namespace misonet;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (T * F + POS_TILE - 1) / POS_TILE;
  const dim3 grid(ntiles, (N + NB - 1) / NB, B);
  const int xs_ch = stage_floats(F);
  // weights, staged channels, and slack after the last channel: the masked
  // edge taps of a tile's first and last position read one float outside
  // their channel's run (into the weights before it or this slack)
  const size_t smem = (CK * 9 * WS_ROW + CK * xs_ch + 4) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dense_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dense_stack_kernel<<<grid, THREADS, smem, st>>>(
      x0, c0, x1, c1, scale, mean, w, bias, acc_in, y, acc_out, part, T, F,
      N, n_fin, xs_ch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce_stats(part, sums, sqs, B * n_fin, ntiles, st);
}

// The tiling constant the wrapper needs to size the partials scratch.
extern "C" int misonet_pos_tile() { return misonet::POS_TILE; }
