// stencil: the U-Net body's 3x3 trunk / transpose convs on Hopper.
//
// Replaces misonet_tpu/ops/pallas/stencil_flat.py::stencil_layer_flat (its
// Pallas `_kernel`) in its four instances, float32 ("precise") mode:
//
//   mode 0  enc0   conv, stride (1,1), time SAME / freq VALID, F -> F-2,
//                  identity normalization, bare (enc0_down_flat)
//   mode 1  down   conv, stride (1,2), freq VALID, F -> (F-3)/2+1,
//                  normalize on load, + ELU + stats (conv_down_flat)
//   mode 2  up     transpose conv, stride (1,2), torch geometry
//                  F -> (F-1)*2 - 0 + 3 = 2F+1, normalize on load,
//                  + ELU + stats (deconv_up_flat + interleave_up)
//   mode 3  final  transpose conv, stride (1,1), F -> F+2, all bins
//                  including the last, normalize on load, bare
//                  (final_deconv_flat + final_bin128)
//
// Tensors stay plain NCHW, so the TPU version's frequency space-to-depth,
// phase interleave and bin-128 glue, its lane rotations and its
// mean-correction fields have no counterpart: the kernel maps each output
// position to its input taps directly, and an out-of-range tap contributes
// 0 to the normalized input.  The stride-2 transpose (`up`) runs its even
// and odd output columns in separate blocks: an even column fo = 2m reads
// kf = 0, 2 at input m, m-1 and an odd one fo = 2m+1 reads kf = 1 at m, so
// each block runs only the taps of its phase (9 per column pair instead
// of 18).
//
// Weights come as Conv2d's [N, C, 3, 3] for the conv modes and as the torch
// ConvTranspose2d weight [C, N, 3, 3] for the transpose modes, read in place
// (no copy, no flip): out[t, fo] += w[c, n, kt, kf] * xn[t + 1 - kt, (fo -
// kf) / s].
//
// Bound on the H100: float32 FMA issue and its latency hiding, at C =
// 12..64 input channels and N = 4..32 outputs.  256 threads hold 16
// channels x 2 positions each and read their inputs straight from global
// memory (L1-resident), with the tap's bounds check per load;
// registers are capped so 3 blocks share an SM (8 % faster than 2 in a
// sweep on the H100, PERF.md).  Weights and the two-pass statistics
// as in conv_common.cuh.  The final layer's N = 4 fills 4 of the block's
// 32 channel slots; it is 1 of the 10 launches per forward.

#include "conv_common.cuh"

namespace misonet {
namespace {

enum Mode { ENC0 = 0, DOWN = 1, UP = 2, FINAL = 3 };

constexpr int PT = 2;                    // output positions per thread
constexpr int LANES = POS_TILE / PT;     // position lanes per channel half
constexpr int THREADS = 2 * LANES;       // two 16-channel halves
constexpr int CK = 16;                   // input channels staged per round
constexpr int MIN_BLOCKS = 3;            // per SM: caps registers at 80

// Input (ti, fi) read by tap (kt, kf) of the output at row t and plane
// column m (the output column itself, except for `up`, where m indexes the
// block's phase plane and the caller skips taps of the other parity).
template <int MODE>
__device__ __forceinline__ bool tap_src(int t, int m, int kt, int kf, int T,
                                        int Fin, int& ti, int& fi) {
  if (MODE == ENC0 || MODE == DOWN) {
    ti = t + kt - 1;
    fi = (MODE == DOWN ? 2 * m : m) + kf;
  } else {
    ti = t + 1 - kt;
    fi = MODE == UP ? m - (kf >> 1) : m - kf;
  }
  return ti >= 0 && ti < T && fi >= 0 && fi < Fin;
}

// Position tiles of one (batch, channel tile): `up` tiles its even-column
// plane (Fin + 1 columns) and then its odd-column plane (Fin columns).
__host__ __device__ inline int even_tiles(int T, int Fin) {
  return (T * (Fin + 1) + POS_TILE - 1) / POS_TILE;
}

__host__ __device__ inline int num_tiles(int mode, int T, int Fin, int Fout) {
  if (mode == UP)
    return even_tiles(T, Fin) + (T * Fin + POS_TILE - 1) / POS_TILE;
  return (T * Fout + POS_TILE - 1) / POS_TILE;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stencil_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ mean, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ y,
               float* __restrict__ part, int C, int T, int Fin, int Fout,
               int N) {
  constexpr bool kAct = MODE == DOWN || MODE == UP;  // ELU + stats
  __shared__ __align__(16) float ws[CK][9][WS_ROW];
  const int half = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int TFo = T * Fout;

  // the block's plane: all output columns, or one parity of them for `up`
  int tile = blockIdx.x, phase = 0, Fpl = Fout;
  if (MODE == UP) {
    const int ne = even_tiles(T, Fin);
    phase = tile >= ne;
    Fpl = phase ? Fin : Fin + 1;
    tile -= phase ? ne : 0;
  }
  int pos[PT], pt[PT], pm[PT];  // output index, row, plane column
  bool pv[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int p = tile * POS_TILE + j * LANES + lane;
    pv[j] = p < T * Fpl;
    pt[j] = p / Fpl;
    pm[j] = p - pt[j] * Fpl;
    pos[j] = pt[j] * Fout + (MODE == UP ? 2 * pm[j] + phase : pm[j]);
  }

  float acc[NT][PT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[i][j] = 0.f;

  for (int cb = 0; cb < C; cb += CK) {
    const int ck = min(CK, C - cb);
    __syncthreads();
    stage_weights<CK, THREADS, MODE == UP || MODE == FINAL>(ws, w, N, C, n0,
                                                            cb, ck);
    __syncthreads();
    for (int k = 0; k < ck; ++k) {
      const int c = cb + k;
      const float sc = scale ? scale[b * C + c] : 1.f;
      const float mu = mean ? mean[b * C + c] : 0.f;
      const float* xp = x + ((size_t)b * C + c) * T * Fin;
      float xv[9][PT];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        if (MODE == UP && ((tap % 3) & 1) != phase) continue;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          int ti, fi;
          const bool ok = pv[j] && tap_src<MODE>(pt[j], pm[j], tap / 3,
                                                 tap % 3, T, Fin, ti, fi);
          xv[tap][j] = ok ? (__ldg(xp + ti * Fin + fi) - mu) * sc : 0.f;
        }
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        if (MODE == UP && ((tap % 3) & 1) != phase) continue;
        fma_tap<PT>(acc, &ws[k][tap][half * NT], xv[tap]);
      }
    }
  }

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
      float v = acc[i][j] + bias[n];
      if (kAct) {
        v = elu(v);
        su[i] += v;
        sq[i] += v * v;
      }
      y[((size_t)b * N + n) * TFo + pos[j]] = v;
    }
  }
  if (kAct)
    block_stats<THREADS>(su, sq, part, b, B, n0, N, blockIdx.x, gridDim.x);
}

}  // namespace
}  // namespace misonet

// C entry point.  All tensors float32, contiguous, on the current device:
//   x [B, C, T, Fin]; scale, mean [B, C] (NULL for mode 0: identity);
//   w [N, C, 3, 3] for modes 0-1, [C, N, 3, 3] for modes 2-3; bias [N];
//   y [B, N, T, Fout];
//   part [2, B, N, ntiles] scratch with ntiles = misonet_stencil_tiles(),
//   and sums, sqs [B, N] for modes 1-2 (NULL otherwise).
// Returns cudaGetLastError() after the launches (0 on success); an unknown
// mode returns cudaErrorInvalidValue.
extern "C" int misonet_stencil(int mode, const float* x, const float* scale,
                               const float* mean, const float* w,
                               const float* bias, float* y, float* part,
                               float* sums, float* sqs, int B, int C, int T,
                               int Fin, int Fout, int N, void* stream) {
  using namespace misonet;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = num_tiles(mode, T, Fin, Fout);
  const dim3 grid(ntiles, (N + NB - 1) / NB, B);
  switch (mode) {
    case ENC0:
      stencil_kernel<ENC0><<<grid, THREADS, 0, st>>>(
          x, scale, mean, w, bias, y, part, C, T, Fin, Fout, N);
      break;
    case DOWN:
      stencil_kernel<DOWN><<<grid, THREADS, 0, st>>>(
          x, scale, mean, w, bias, y, part, C, T, Fin, Fout, N);
      break;
    case UP:
      stencil_kernel<UP><<<grid, THREADS, 0, st>>>(
          x, scale, mean, w, bias, y, part, C, T, Fin, Fout, N);
      break;
    case FINAL:
      stencil_kernel<FINAL><<<grid, THREADS, 0, st>>>(
          x, scale, mean, w, bias, y, part, C, T, Fin, Fout, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (mode == DOWN || mode == UP)
    return (int)launch_reduce_stats(part, sums, sqs, B * N, ntiles, st);
  return 0;
}

// Position tiles per (batch, channel tile) of a stencil call: the size of
// the last axis of its `part` scratch.
extern "C" int misonet_stencil_tiles(int mode, int T, int Fin, int Fout) {
  return misonet::num_tiles(mode, T, Fin, Fout);
}
