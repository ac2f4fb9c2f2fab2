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
// Both modes run one kernel, stencil_tc_kernel, on the tensor cores: the
// gather conv of conv_mma.cuh that dense_stack.cu's bf16 mode runs, over
// each mode's map: enc0 M_SHIFT, down M_DOUBLE, final M_SHIFT_T (the maps
// stencil_bwd.cu's wgrad reads them through), and for `up` its two parity
// planes (UpGeo below: 6 taps per unit group on the even plane, 3 on the
// odd, no wrong-parity zero unit).  Rows are a 2-D tile of 128 positions
// of the (plane of the) output, columns BN = 8..32 output channels (N on
// the mma's 8-wide side, an odd count of n8 tiles allowed: MISO1's final
// N = 4 and MISO3's N = 2 fill one n8 tile, N = 24 three), the reduction
// over units of one 16-byte group of input channels at one tap.  The
// window is staged channels-last, normalized on load to (x - mean) *
// scale with a zero halo (enc0: the raw input), the rounding point of
// stencil_plain; the weights arrive packed [G, 9, N, group] by the wrapper
// (tc_pack.py; transposed for up and final) and are copied by cp.async.
// Epilogue through shared memory: bias, ELU and the fixed-order
// statistics partials for down and up, bias alone for enc0 and final, the
// store; then the statistics' second pass (launch_reduce_stats).
//
//   float32 ("precise"): 4 channels a group, the window stored unrounded;
//   each product three `mma.sync m16n8k8` TF32 passes over split operands
//   (conv_mma.cuh: big big + big small + small big, float32 sums), the
//   window split in registers after its ldmatrix, the weights packed split
//   (two planes, by tc_pack.cu's pack_tf32_kernel once per weight
//   version).  Bound on the H100: the larger of its operations at a
//   third of the TF32 rate and its bytes, 0.17 ms over phase 3's cases (chip_smoke.py; 0.30 with the 67
//   TFLOP/s of the FMA loop this kernel replaced).  A chunk holds 16
//   channels, so the window per unit count is the bf16 mode's.
//   bfloat16: 8 channels a group, normalized and rounded on load to
//   bf16((x - mean) * scale); `mma.sync m16n8k16` bf16 x bf16 -> float32;
//   the bf16 store.  Bound on the H100: its bytes (0.045 ms over phase
//   11's cases); what limits it, as for dense_stack's bf16 mode, is the
//   staging of the window and the epilogue's traffic, not the mmas
//   (PERF.md).

#include <algorithm>
#include <type_traits>

#include "conv_common.cuh"
#include "conv_mma.cuh"

namespace misonet {
namespace {

enum Mode { ENC0 = 0, DOWN = 1, UP = 2, FINAL = 3 };

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
// positions x BN = 8 NT8 output channels of one batch element, in storage
// type E (float or bf16); smem the kernel's dynamic shared memory.
template <int P, int NT8, typename E>
__device__ __forceinline__ void stencil_tc_tile(
    unsigned char* smem, const E* __restrict__ x,
    const float* __restrict__ scale, const float* __restrict__ mean,
    const E* __restrict__ w, const float* __restrict__ bias,
    E* __restrict__ y, float* __restrict__ part, int C, int T, int Fin,
    int Fout, int N, int tile) {
  constexpr bool kAct = P == P_DOWN || P == P_UP_EVEN || P == P_UP_ODD;
  constexpr int BN = 8 * NT8;
  constexpr int EPG = tc::GROUP_BYTES / sizeof(E);  // channels a group
  constexpr int CH = EPG * tc::GMAX;                // channels a chunk
  const int Fp = plane_cols(P, Fin, Fout);
  const int tw = tc::tile_w(Fp);
  const int ntc = (Fp + tw - 1) / tw;
  const int t0 = (tile / ntc) * (tc::GM_POS / tw);
  const int m0 = (tile % ntc) * tw;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int TFi = T * Fin;
  // float32: the weights' small plane after the big one
  const size_t plane = (size_t)((C + EPG - 1) / EPG) * 9 * N;
  float acc[NT8][4] = {};

  for (int cb = 0; cb < C; cb += CH) {
    const int rk = min(CH, C - cb);
    const E* xp = x + ((size_t)b * C + cb) * TFi;
    const int ch = b * C + cb;
    tc::gather_chunk<PlaneGeo<P>, NT8, E>(
        acc, smem, tw, t0, m0, w, plane, N, o0, cb / EPG,
        (rk + EPG - 1) / EPG, rk, T, Fin, [&](int k, int p) {
          const float v = ldg_f32(xp + (size_t)k * TFi + p);
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

// Blocks of the kernel along x: the plane's position tiles, or for up the
// even plane's and then the odd plane's.
__host__ __device__ inline int tc_tiles(int mode, int T, int Fin, int Fout) {
  if (mode == UP)
    return tc::pos_tiles(T, Fin + 1) + tc::pos_tiles(T, Fin);
  return tc::pos_tiles(T, Fout);
}

template <int MODE, int NT8, typename E>
__global__ void __launch_bounds__(tc::GM_THREADS, tc::gm_min_blocks<E>(NT8))
stencil_tc_kernel(const E* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ mean, const E* __restrict__ w,
                  const float* __restrict__ bias, E* __restrict__ y,
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

template <int MODE, int NT8, typename E>
cudaError_t launch_stencil_tc(const E* x, const float* scale,
                              const float* mean, const E* w,
                              const float* bias, E* y, float* part, int B,
                              int C, int T, int Fin, int Fout, int N,
                              cudaStream_t st) {
  constexpr int BN = 8 * NT8;
  size_t smem;
  if constexpr (MODE == UP) {
    smem = std::max(
        tc::gather_smem<UpGeo<0>, E>(BN, tc::tile_w(Fin + 1)),
        tc::gather_smem<UpGeo<1>, E>(BN, tc::tile_w(Fin)));
  } else {
    smem = tc::gather_smem<PlaneGeo<MODE>, E>(BN, tc::tile_w(Fout));
  }
  cudaError_t e = cudaFuncSetAttribute(
      stencil_tc_kernel<MODE, NT8, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tc_tiles(MODE, T, Fin, Fout), (N + BN - 1) / BN, B);
  stencil_tc_kernel<MODE, NT8, E><<<grid, tc::GM_THREADS, smem, st>>>(
      x, scale, mean, w, bias, y, part, C, T, Fin, Fout, N);
  return cudaGetLastError();
}

template <int MODE, typename E>
cudaError_t launch_stencil_tc_mode(const E* x, const float* scale,
                                   const float* mean, const E* w,
                                   const float* bias, E* y, float* part,
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

// Both passes of a stencil call in storage type E: the tensor-core conv
// pass, then for down and up the statistics' fixed-order pass over its
// tc_tiles partials.
template <typename E>
int launch_stencil(int mode, const E* x, const float* scale,
                   const float* mean, const E* w, const float* bias, E* y,
                   float* part, float* sums, float* sqs, int B, int C,
                   int Tn, int Fin, int Fout, int N, void* stream) {
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
// float32 (misonet_stencil) or bfloat16 (misonet_stencil_bf16), w of their
// type, the rest float32:
//   x [B, C, T, Fin]; scale, mean [B, C] (NULL for mode 0: identity);
//   w packed by ops/kernels/tc_pack.py with output n and reduced c
//   (transposed for modes 2-3): float32 [2, ceil(C/4), 9, N, 4] (TF32 big
//   and small planes), bfloat16 [ceil(C/8), 9, N, 8];
//   bias [N]; y [B, N, T, Fout];
//   part [2, B, N, ntiles] scratch with ntiles = misonet_stencil_tc_tiles(),
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

// Position tiles per (batch, channel tile) of a stencil call in either
// mode: the size of the last axis of its `part` scratch.
extern "C" int misonet_stencil_tc_tiles(int mode, int T, int Fin, int Fout) {
  return misonet::tc_tiles(mode, T, Fin, Fout);
}
