// stencil: the U-Net body's 3x3 trunk / transpose convs on Hopper.
//
// Replaces misonet_tpu/ops/pallas/stencil_flat.py::stencil_layer_flat (its
// Pallas `_kernel`) in its four instances, in its float32 ("precise") and
// bfloat16 (precise=False) modes:
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
// mean-correction fields have no counterpart: the kernels map each output
// position to its input taps directly, and an out-of-range tap contributes
// 0 to the normalized input.  The stride-2 transpose (`up`) runs its even
// and odd output columns in separate blocks: an even column fo = 2m reads
// kf = 0, 2 at input m, m-1 and an odd one fo = 2m+1 reads kf = 1 at m, so
// each block runs only the taps of its phase (9 per column pair instead
// of 18).  Output: out[t, fo] += w[c, n, kt, kf] * xn[t + 1 - kt, (fo -
// kf) / s] for the transpose modes, w[n, c, kt, kf] * xn[t + kt - 1,
// s fo + kf] for the conv modes.
//
// float32 mode (stencil_kernel): CUDA-core FMAs.  Weights come as
// Conv2d's [N, C, 3, 3] for the conv modes and as the torch
// ConvTranspose2d weight [C, N, 3, 3] for the transpose modes, read in
// place (no copy, no flip).  Bound on the H100: float32 FMA throughput and
// its latency hiding, at C = 12..64 input channels and N = 4..32 outputs.
// 256 threads hold 16 channels x 2 positions each and read their inputs
// straight from global memory (L1-resident), with the tap's bounds check
// per load; registers are capped so 3 blocks share an SM (8 % faster than
// 2 in a sweep on the H100, PERF.md).  Weights and the two-pass statistics
// as in conv_common.cuh.  The final layer's N = 4 fills 4 of the block's
// 32 channel slots; it is 1 of the 10 launches per forward.
//
// bfloat16 mode (stencil_tc_kernel): tensor cores, `mma.sync m16n8k16`
// bf16 x bf16 -> float32, the gather conv of conv_mma.cuh that
// dense_stack.cu's bf16 mode runs, over each mode's map: enc0 M_SHIFT,
// down M_DOUBLE, final M_SHIFT_T (the maps stencil_bwd.cu's wgrad reads
// them through), and for `up` its two parity planes (UpGeo below: 6 taps
// per unit group on the even plane, 3 on the odd, no wrong-parity zero
// unit).  Rows are a 2-D tile of 128 positions of the (plane of the)
// output, columns BN = 8..32 output channels (N on the mma's 8-wide side,
// an odd count of n8 tiles allowed: MISO1's final N = 4 and MISO3's N = 2
// fill one n8 tile, N = 24 three), the reduction over units of 8 input
// channels at one tap.  The window is staged channels-last, normalized
// and rounded on load to bf16((x - mean) * scale) with a zero halo (enc0:
// the raw input), the rounding point of the FMA loop and of
// stencil_plain; the weights arrive packed [G, 9, N, 8] by the wrapper
// (tc_pack.py; transposed for up and final) and are copied by cp.async.
// Epilogue through shared memory: bias, ELU and the fixed-order
// statistics partials for down and up, bias alone for enc0 and final, the
// bf16 store; then the statistics' second pass (launch_reduce_stats).
// Bound on the H100: its bytes (0.045 ms over phase 11's cases); what
// limits it, as for dense_stack's bf16 mode, is the staging of the window
// and the epilogue's traffic, not the mmas (PERF.md).

#include <algorithm>
#include <type_traits>

#include "conv_common.cuh"
#include "conv_mma.cuh"

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

// Launch a float32 stencil call (see the C entry points below).
int launch_stencil(int mode, const float* x, const float* scale,
                   const float* mean, const float* w, const float* bias,
                   float* y, float* part, float* sums, float* sqs, int B,
                   int C, int Tn, int Fin, int Fout, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = num_tiles(mode, Tn, Fin, Fout);
  const dim3 grid(ntiles, (N + NB - 1) / NB, B);
  switch (mode) {
#define MISONET_STENCIL(M)                                                \
  case M:                                                                 \
    stencil_kernel<M><<<grid, THREADS, 0, st>>>(x, scale, mean, w, bias,  \
                                                y, part, C, Tn, Fin, Fout, \
                                                N);                       \
    break;
    MISONET_STENCIL(ENC0)
    MISONET_STENCIL(DOWN)
    MISONET_STENCIL(UP)
    MISONET_STENCIL(FINAL)
#undef MISONET_STENCIL
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (mode == DOWN || mode == UP)
    return (int)launch_reduce_stats(part, sums, sqs, B * N, ntiles, st);
  return 0;
}

// ---- the bfloat16 mode on tensor cores --------------------------------------

using bf16 = __nv_bfloat16;

// The output plane a block tiles: the conv modes' and final's whole output
// (P_ENC0, P_DOWN, P_FINAL, numbered as their modes), or one parity plane
// of up's: P_UP_EVEN (fo = 2m, m < Fin + 1) and P_UP_ODD (fo = 2m + 1,
// m < Fin).
enum Plane { P_ENC0 = 0, P_DOWN = 1, P_UP_EVEN = 2, P_FINAL = 3,
             P_UP_ODD = 4 };

// The gather geometry of up's parity planes (the interface of tc::Geo):
// plane column m at tap kf reads input column m - kf / 2, the taps of the
// plane's parity only (even: kf = 0, 2; odd: kf = 1), window columns m0 - 1
// .. m0 + tw - 1 for plane columns m0 .. m0 + tw - 1.
template <int ODD>
struct UpGeo {
  static constexpr int TS = -1;
  static constexpr int NTAP = ODD ? 3 : 6;
  static constexpr bool SKIP = false;
  __device__ static int tap(int i) {
    return ODD ? 3 * i + 1 : 3 * (i >> 1) + 2 * (i & 1);
  }
  __device__ static int lo(int m0) { return m0 - 1; }
  __host__ __device__ static constexpr int width(int tw) { return tw + 1; }
  __device__ static int col(int m, int kf, int lo) {
    return m - (kf >> 1) - lo;
  }
};

template <int P>
using PlaneGeo = std::conditional_t<
    P == P_ENC0, tc::Geo<tc::M_SHIFT>,
    std::conditional_t<
        P == P_DOWN, tc::Geo<tc::M_DOUBLE>,
        std::conditional_t<P == P_FINAL, tc::Geo<tc::M_SHIFT_T>,
                           UpGeo<P == P_UP_ODD>>>>;

// Plane columns of plane P.
__host__ __device__ inline int plane_cols(int P, int Fin, int Fout) {
  return P == P_UP_EVEN ? Fin + 1 : P == P_UP_ODD ? Fin : Fout;
}

// One block's tile (number `tile` of its plane) of plane P: tc::GM_POS
// positions x BN = 8 NT8 output channels of one batch element; smem the
// kernel's dynamic shared memory.
template <int P, int NT8>
__device__ __forceinline__ void stencil_tc_tile(
    unsigned char* smem, const bf16* __restrict__ x,
    const float* __restrict__ scale, const float* __restrict__ mean,
    const bf16* __restrict__ w, const float* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ part, int C, int T, int Fin,
    int Fout, int N, int tile) {
  constexpr bool kAct = P == P_DOWN || P == P_UP_EVEN || P == P_UP_ODD;
  constexpr int BN = 8 * NT8;
  const int Fp = plane_cols(P, Fin, Fout);
  const int tw = tc::tile_w(Fp);
  const int ntc = (Fp + tw - 1) / tw;
  const int t0 = (tile / ntc) * (tc::GM_POS / tw);
  const int m0 = (tile % ntc) * tw;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int TFi = T * Fin;
  float acc[NT8][4] = {};

  for (int cb = 0; cb < C; cb += 8 * tc::GMAX) {
    const int rk = min(8 * tc::GMAX, C - cb);
    const bf16* xp = x + ((size_t)b * C + cb) * TFi;
    const int ch = b * C + cb;
    tc::gather_chunk<PlaneGeo<P>, NT8, bf16>(
        acc, smem, tw, t0, m0, w, N, o0, cb / 8, (rk + 7) / 8, rk, T, Fin,
        [&](int k, int p) {
          const float v = tc::bf16_at(xp + (size_t)k * TFi + p);
          if (P == P_ENC0) return v;  // identity normalization
          return (v - __ldg(mean + ch + k)) * __ldg(scale + ch + k);
        });
  }

  tc::finish_gather<NT8>(
      smem, acc, tw, kAct, N - o0, part, (size_t)b * N + o0,
      (size_t)gridDim.z * N, blockIdx.x, gridDim.x,
      [&](int o, int pr, int pc, float z) {
        const int n = o0 + o;
        const int t = t0 + pr;
        const int m = m0 + pc;
        if (n >= N || t >= T || m >= Fp) return make_float2(0.f, 0.f);
        const int f = P == P_UP_EVEN ? 2 * m : P == P_UP_ODD ? 2 * m + 1 : m;
        float v = z + __ldg(bias + n);
        if (kAct) v = elu(v);
        store(y + ((size_t)b * N + n) * T * Fout + (size_t)t * Fout + f, v);
        return kAct ? make_float2(v, v * v) : make_float2(0.f, 0.f);
      });
}

// Blocks of the tensor-core kernel along x: the plane's position tiles, or
// for up the even plane's and then the odd plane's.
__host__ __device__ inline int tc_tiles(int mode, int T, int Fin, int Fout) {
  if (mode == UP)
    return tc::pos_tiles(T, Fin + 1) + tc::pos_tiles(T, Fin);
  return tc::pos_tiles(T, Fout);
}

template <int MODE, int NT8>
__global__ void __launch_bounds__(tc::GM_THREADS, tc::gm_min_blocks(NT8))
stencil_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ mean, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ y,
                  float* __restrict__ part, int C, int T, int Fin, int Fout,
                  int N) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  if constexpr (MODE == UP) {
    const int ne = tc::pos_tiles(T, Fin + 1);
    if ((int)blockIdx.x < ne)
      stencil_tc_tile<P_UP_EVEN, NT8>(tc_smem, x, scale, mean, w, bias, y,
                                      part, C, T, Fin, Fout, N, blockIdx.x);
    else
      stencil_tc_tile<P_UP_ODD, NT8>(tc_smem, x, scale, mean, w, bias, y,
                                     part, C, T, Fin, Fout, N,
                                     blockIdx.x - ne);
  } else {
    stencil_tc_tile<MODE, NT8>(tc_smem, x, scale, mean, w, bias, y, part, C,
                               T, Fin, Fout, N, blockIdx.x);
  }
}

template <int MODE, int NT8>
cudaError_t launch_stencil_tc(const bf16* x, const float* scale,
                              const float* mean, const bf16* w,
                              const float* bias, bf16* y, float* part,
                              int B, int C, int T, int Fin, int Fout, int N,
                              cudaStream_t st) {
  constexpr int BN = 8 * NT8;
  size_t smem;
  if constexpr (MODE == UP) {
    smem = std::max(
        tc::gather_smem<UpGeo<0>>(BN, tc::tile_w(Fin + 1)),
        tc::gather_smem<UpGeo<1>>(BN, tc::tile_w(Fin)));
  } else {
    smem = tc::gather_smem<PlaneGeo<MODE>>(BN, tc::tile_w(Fout));
  }
  cudaError_t e = cudaFuncSetAttribute(
      stencil_tc_kernel<MODE, NT8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tc_tiles(MODE, T, Fin, Fout), (N + BN - 1) / BN, B);
  stencil_tc_kernel<MODE, NT8><<<grid, tc::GM_THREADS, smem, st>>>(
      x, scale, mean, w, bias, y, part, C, T, Fin, Fout, N);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_stencil_tc_mode(const bf16* x, const float* scale,
                                   const float* mean, const bf16* w,
                                   const float* bias, bf16* y, float* part,
                                   int B, int C, int T, int Fin, int Fout,
                                   int N, cudaStream_t st) {
  switch (tc::pick_nt8(N, 4, true)) {
#define MISONET_STENCIL_TC(NT8)                                           \
  case NT8:                                                               \
    return launch_stencil_tc<MODE, NT8>(x, scale, mean, w, bias, y, part, \
                                        B, C, T, Fin, Fout, N, st);
    MISONET_STENCIL_TC(1)
    MISONET_STENCIL_TC(2)
    MISONET_STENCIL_TC(3)
    MISONET_STENCIL_TC(4)
#undef MISONET_STENCIL_TC
    default:
      return cudaErrorInvalidValue;
  }
}

// Both passes of the bfloat16 mode: the tensor-core conv pass, then for
// down and up the statistics' fixed-order pass over its tc_tiles partials.
int launch_stencil(int mode, const bf16* x, const float* scale,
                   const float* mean, const bf16* w, const float* bias,
                   bf16* y, float* part, float* sums, float* sqs, int B,
                   int C, int Tn, int Fin, int Fout, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
#define MISONET_STENCIL_TC_MODE(M)                                         \
  case M:                                                                  \
    e = launch_stencil_tc_mode<M>(x, scale, mean, w, bias, y, part, B, C,  \
                                  Tn, Fin, Fout, N, st);                   \
    break;
    MISONET_STENCIL_TC_MODE(ENC0)
    MISONET_STENCIL_TC_MODE(DOWN)
    MISONET_STENCIL_TC_MODE(UP)
    MISONET_STENCIL_TC_MODE(FINAL)
#undef MISONET_STENCIL_TC_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || !(mode == DOWN || mode == UP)) return (int)e;
  return (int)launch_reduce_stats(part, sums, sqs, B * N,
                                  tc_tiles(mode, Tn, Fin, Fout), st);
}

}  // namespace
}  // namespace misonet

// C entry points.  All tensors contiguous, on the current device; x and y
// float32 (misonet_stencil) or bfloat16 (misonet_stencil_bf16), the rest
// float32 except the bf16 mode's weights:
//   x [B, C, T, Fin]; scale, mean [B, C] (NULL for mode 0: identity);
//   float32: w [N, C, 3, 3] for modes 0-1, [C, N, 3, 3] for modes 2-3;
//   bfloat16: w packed by ops/kernels/tc_pack.py with output n and reduced
//   c (transposed for modes 2-3), [ceil(C/8), 9, N, 8];
//   bias [N]; y [B, N, T, Fout];
//   part [2, B, N, ntiles] scratch with ntiles = misonet_stencil_tiles()
//   (float32) or misonet_stencil_tc_tiles() (bfloat16),
//   and sums, sqs [B, N] for modes 1-2 (NULL otherwise).
// Return cudaGetLastError() after the launches (0 on success); an unknown
// mode returns cudaErrorInvalidValue.
extern "C" int misonet_stencil(int mode, const float* x, const float* scale,
                               const float* mean, const float* w,
                               const float* bias, float* y, float* part,
                               float* sums, float* sqs, int B, int C, int T,
                               int Fin, int Fout, int N, void* stream) {
  return misonet::launch_stencil(mode, x, scale, mean, w, bias, y, part, sums,
                                 sqs, B, C, T, Fin, Fout, N, stream);
}

extern "C" int misonet_stencil_bf16(int mode, const __nv_bfloat16* x,
                                    const float* scale, const float* mean,
                                    const __nv_bfloat16* w, const float* bias,
                                    __nv_bfloat16* y, float* part, float* sums,
                                    float* sqs, int B, int C, int T, int Fin,
                                    int Fout, int N, void* stream) {
  return misonet::launch_stencil(mode, x, scale, mean, w, bias, y, part, sums,
                                 sqs, B, C, T, Fin, Fout, N, stream);
}

// Position tiles per (batch, channel tile) of a stencil call: the size of
// the last axis of its `part` scratch, float32 and bfloat16 mode.
extern "C" int misonet_stencil_tiles(int mode, int T, int Fin, int Fout) {
  return misonet::num_tiles(mode, T, Fin, Fout);
}

extern "C" int misonet_stencil_tc_tiles(int mode, int T, int Fin, int Fout) {
  return misonet::tc_tiles(mode, T, Fin, Fout);
}
