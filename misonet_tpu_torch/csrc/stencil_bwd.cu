// stencil_bwd: the backward of the fused U-Net body convs on Hopper.
//
// Replaces misonet_tpu/ops/pallas/stencil_bwd.py::stencil_bwd_flat (its
// Pallas `_kernel`), float32 ("precise") mode, the one fused backward of
// both forward kernels: dense_stack.cu (mode DENSE) and the four stencil.cu
// instances (ENC0, DOWN, UP, FINAL).  The forward it differentiates is
//
//   xn = (x - mean) * scale           per (b, c), zero outside the plane
//   z  = conv(xn, W) + bias (+ acc_in)
//
// and its caller (ops/kernels/flat_grad.py) folds the ELU and statistics
// cotangents into g = dL/dz outside, in PyTorch.  Given g [B, N, T, Fo],
// one call computes
//
//   G[b,c,q]  = sum_{n,j} W[n,c,j] g[b,n,p(q,j)]     (dgrad)
//   dx        = scale * G
//   dscale    = sum_q G (x - mean),  dmean = -scale sum_q G
//   dW[n,c,j] = sum_{b,p} xn[b,c,q(p,j)] g[b,n,p]   (wgrad)
//   dbias[n]  = sum_{b,p} g[b,n,p]
//
// over the (input q, output p, tap j) triples the forward visits.  Tensors
// stay NCHW, so the TPU kernel's lane framing, tap tables, validity fields
// and weight/scale packing have no counterpart: each position maps to its
// taps directly and a tap outside the plane contributes 0.  The mean term
// of dW that the TPU kernel took from validity fields comes for free here,
// because the wgrad reads the normalized input xn with its zero halo.
//
// Kernels, per call:
//   dgrad_kernel<MODE>   the stencil.cu tiling (32 input channels x 256
//                        input positions per block, 16 x 2 per thread,
//                        weights of 16 cotangent channels staged in shared
//                        memory), run over the N cotangent channels with
//                        the transposed taps; its epilogue writes dx and
//                        one partial of sum G and sum G (x - mean) per
//                        (b, c, tile), added by reduce_stats_kernel
//                        (conv_common.cuh).  Each mode's dgrad is another
//                        forward geometry: DENSE the SAME conv with
//                        flipped taps, DOWN the stride-2 transpose (half
//                        its freq taps are of the wrong parity and are
//                        masked), UP the stride-2 conv, FINAL the VALID
//                        conv F+2 -> F.  ENC0 runs it only when dx is
//                        asked for (the train step does not ask).
//   wgrad_kernel<MODE>   an implicit GEMM: rows n (16, 32 or 64 per block,
//                        the narrowest that holds N), columns (c, tap)
//                        plus one column of ones for dbias (4096 / rows
//                        per block), reduction over the B*T*Fo output
//                        positions, 4 x 4 register tiles fed from
//                        32-position chunks staged in shared memory (the
//                        im2col gather of xn happens while staging).
//   wgrad_reduce_kernel  sums the splits' partials (next paragraph) in a
//                        fixed order, in double, into dW and dbias.
//
// Where the trouble is, and what the design does about it:
//   * The wgrad reduction is long: B*T*Fo = 8*501*127 = 509,000 positions
//     at the enc0/dec6 level.  Blocks run in no order, so the positions are
//     cut into a fixed number of splits that depends only on the shapes
//     (about 4 blocks per SM in all); each block loops over its split's
//     chunks with its sums in registers and writes ONE partial tile.  The
//     partials are added in split order, so gradients are the same from
//     run to run (no atomics, as the forward's statistics).  One partial
//     per 256-position tile would have been ~0.5 GB at dec6 call 0; the
//     splits keep it to splits * N * (9C + 1) floats (1.6 M there).
//   * dscale/dmean reduce over the input plane per (b, c): the forward's
//     two-pass statistics (block partials + a fixed-order pass in double).
//   * Bound on the H100: float32 FMA issue (no tensor cores in this
//     version).  dgrad and wgrad each do the forward's MACs: 1.19 TFLOP
//     per B = 8 train step over the 60 calls, >= 17.7 ms at the 67
//     TFLOP/s float32 peak; the bytes (g, x, dx, dW read or written once)
//     bound it far lower.  The dgrad reads its 9 taps through L1 and
//     keeps up with a shared-memory-staged variant (tried, PERF.md); the
//     wgrad redoes the im2col gather of xn for every 32-position chunk
//     and is the slower half.  The `up` wgrad multiplies the taps of the
//     other parity by zero, and N = 4 (final) fills a quarter of the
//     narrowest tile.  Making them fast (wgmma, TMA, TF32 splits) is
//     later work.

#include <algorithm>

#include "conv_common.cuh"

namespace misonet {
namespace {

enum BwdMode { B_ENC0 = 0, B_DOWN = 1, B_UP = 2, B_FINAL = 3, B_DENSE = 4 };

template <int MODE>
constexpr bool kTransposeMode = MODE == B_UP || MODE == B_FINAL;

// ---- geometry --------------------------------------------------------------

// Forward map: the input (ti, fi) that tap (kt, kf) of output (t, fo) reads.
template <int MODE>
__device__ __forceinline__ bool fwd_src(int t, int fo, int kt, int kf, int T,
                                        int Fin, int& ti, int& fi) {
  if (kTransposeMode<MODE>) {
    ti = t + 1 - kt;
    const int d = fo - kf;
    if (MODE == B_UP) {
      if (d < 0 || (d & 1)) return false;
      fi = d >> 1;
    } else {
      fi = d;
    }
  } else {
    ti = t + kt - 1;
    fi = (MODE == B_DOWN ? 2 * fo : fo) + kf - (MODE == B_DENSE ? 1 : 0);
  }
  return ti >= 0 && ti < T && fi >= 0 && fi < Fin;
}

// Inverse map: the output (t, fo) whose tap (kt, kf) reads input (ti, fi).
template <int MODE>
__device__ __forceinline__ bool bwd_dst(int ti, int fi, int kt, int kf, int T,
                                        int Fo, int& t, int& fo) {
  if (kTransposeMode<MODE>) {
    t = ti + kt - 1;
    fo = (MODE == B_UP ? 2 * fi : fi) + kf;
  } else {
    t = ti + 1 - kt;
    int d = fi - kf + (MODE == B_DENSE ? 1 : 0);
    if (MODE == B_DOWN) {
      if (d < 0 || (d & 1)) return false;
      d >>= 1;
    }
    fo = d;
  }
  return t >= 0 && t < T && fo >= 0 && fo < Fo;
}

// The flat output index of bwd_dst is base(ti, fi) + tap_off(kt, kf).
template <int MODE>
__device__ __forceinline__ int dst_base(int ti, int fi, int Fo) {
  if (MODE == B_UP) return ti * Fo + 2 * fi;
  if (MODE == B_DOWN) return ti * Fo + (fi >> 1);
  return ti * Fo + fi;
}

template <int MODE>
__device__ __forceinline__ int tap_off(int kt, int kf, int Fo) {
  if (kTransposeMode<MODE>) return (kt - 1) * Fo + kf;
  if (MODE == B_DOWN) return (1 - kt) * Fo - (kf >> 1);
  return (1 - kt) * Fo + (MODE == B_DENSE ? 1 : 0) - kf;
}

// ---- dgrad -----------------------------------------------------------------

constexpr int DG_PT = 2;                    // input positions per thread
constexpr int DG_LANES = POS_TILE / DG_PT;  // position lanes per half
constexpr int DG_THREADS = 2 * DG_LANES;    // two 16-channel halves
constexpr int DG_CK = 16;                   // cotangent channels per round
constexpr int DG_MIN_BLOCKS = 3;            // per SM: caps registers at 80

// Two sources (the dense mode's skip concat) are one channel axis of C =
// c0 + c1 channels; channel c lives in source (c >= c0).
struct Sources {
  const float* x0;
  const float* x1;
  int c0;
  int C;
  __device__ __forceinline__ size_t plane(int b, int c) const {
    return c < c0 ? (size_t)b * c0 + c : (size_t)b * (C - c0) + (c - c0);
  }
  __device__ __forceinline__ const float* ptr(int c) const {
    return c < c0 ? x0 : x1;
  }
};

template <int MODE>
__global__ void __launch_bounds__(DG_THREADS, DG_MIN_BLOCKS)
dgrad_kernel(const float* __restrict__ g, int N, Sources src,
             const float* __restrict__ scale, const float* __restrict__ mean,
             const float* __restrict__ w, float* __restrict__ dx0,
             float* __restrict__ dx1, float* __restrict__ part, int T,
             int Fin, int Fo) {
  __shared__ __align__(16) float ws[DG_CK][9][WS_ROW];
  const int half = threadIdx.x / DG_LANES;
  const int lane = threadIdx.x % DG_LANES;
  const int ct = blockIdx.y * NB;  // first channel of the block
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int C = src.C;
  const int TFi = T * Fin;
  const int TFo = T * Fo;

  int pos[DG_PT], base[DG_PT], mask[DG_PT];
#pragma unroll
  for (int j = 0; j < DG_PT; ++j) {
    const int q = blockIdx.x * POS_TILE + j * DG_LANES + lane;
    pos[j] = q;
    base[j] = 0;
    mask[j] = 0;
    if (q < TFi) {
      const int ti = q / Fin;
      const int fi = q - ti * Fin;
      base[j] = dst_base<MODE>(ti, fi, Fo);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        int t, fo;
        if (bwd_dst<MODE>(ti, fi, tap / 3, tap % 3, T, Fo, t, fo))
          mask[j] |= 1 << tap;
      }
    }
  }

  float acc[NT][DG_PT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < DG_PT; ++j) acc[i][j] = 0.f;

  for (int nb = 0; nb < N; nb += DG_CK) {
    const int ck = min(DG_CK, N - nb);
    __syncthreads();
    // ws[k][tap][cc] = W[n = nb + k, c = ct + cc, tap] in either layout
    stage_weights<DG_CK, DG_THREADS, !kTransposeMode<MODE>>(ws, w, C, N, ct,
                                                            nb, ck);
    __syncthreads();
    for (int k = 0; k < ck; ++k) {
      const float* gp = g + ((size_t)b * N + nb + k) * TFo;
      float gv[9][DG_PT];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int j = 0; j < DG_PT; ++j)
          gv[tap][j] = (mask[j] >> tap) & 1
                           ? __ldg(gp + base[j] +
                                   tap_off<MODE>(tap / 3, tap % 3, Fo))
                           : 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        fma_tap<DG_PT>(acc, &ws[k][tap][half * NT], gv[tap]);
    }
  }

  // epilogue: dx = scale * G, partials of sum G and sum G (x - mean)
  float su[NT], sq[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    su[i] = 0.f;
    sq[i] = 0.f;
    const int c = ct + half * NT + i;
    if (c >= C) continue;
    const size_t pl = src.plane(b, c) * TFi;
    const float* xp = src.ptr(c) + pl;
    float* dxp = (c < src.c0 ? dx0 : dx1) + pl;
    const float sc = scale ? scale[b * C + c] : 1.f;
    const float mu = mean ? mean[b * C + c] : 0.f;
#pragma unroll
    for (int j = 0; j < DG_PT; ++j) {
      if (pos[j] >= TFi) continue;
      const float G = acc[i][j];
      dxp[pos[j]] = sc * G;
      if (part) {
        su[i] += G;
        sq[i] += G * (__ldg(xp + pos[j]) - mu);
      }
    }
  }
  if (part)  // grid-uniform
    block_stats<DG_THREADS>(su, sq, part, b, B, ct, C, blockIdx.x, gridDim.x);
}

// ---- wgrad -----------------------------------------------------------------

constexpr int WG_THREADS = 256;
constexpr int WG_TILE = 4096;  // rows x columns per block, 4 x 4 a thread
constexpr int WG_KC = 32;      // output positions per staged chunk
constexpr int WG_STAGE_ROWS = WG_THREADS / WG_KC;
constexpr int WG_TARGET_BLOCKS = 4 * 132;  // about 4 per SM of an H100

// Rows (cotangent channels n) per block: the narrowest tile that holds N,
// so N = 4 (the final layer) and N = 24 do not waste most of a 64-row
// tile; the columns widen to keep 4096 outputs per block.
inline int wgrad_rows(int N) { return N <= 16 ? 16 : N <= 32 ? 32 : 64; }

// Columns of the GEMM: 9 C (c, tap) pairs, then one of ones (dbias).
__host__ __device__ inline int wgrad_cols(int C) { return 9 * C + 1; }

inline int wgrad_chunks(int K) { return (K + WG_KC - 1) / WG_KC; }

// Splits of the position range: a function of the shapes alone, so the
// reduction order (and so the result) is the same from run to run.
inline int wgrad_chunks_per_split(int N, int C, int K) {
  const int tn = wgrad_rows(N);
  const int tc = WG_TILE / tn;
  const int tiles = ((N + tn - 1) / tn) * ((wgrad_cols(C) + tc - 1) / tc);
  const int chunks = wgrad_chunks(K);
  int splits = (WG_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, chunks));
  return (chunks + splits - 1) / splits;
}

inline int wgrad_splits(int N, int C, int K) {
  const int cps = wgrad_chunks_per_split(N, C, K);
  return (wgrad_chunks(K) + cps - 1) / cps;
}

// One block: rows n0 .. n0+TN-1, columns col0 .. col0+TC-1, the positions
// of one split.  Each chunk's 32 products are summed apart and then added
// to the running sums, so no float sum runs over more than the split's
// chunk count of terms.
template <int MODE, int TN>
__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const float* __restrict__ g, int N, Sources src,
             const float* __restrict__ scale, const float* __restrict__ mean,
             float* __restrict__ part, int T, int Fin, int Fo, int K,
             int chunks_per_split) {
  constexpr int TC = WG_TILE / TN;
  __shared__ __align__(16) float as[WG_KC][TN + 4];
  __shared__ __align__(16) float bs[WG_KC][TC + 4];
  const int n0 = blockIdx.x * TN;
  const int col0 = blockIdx.y * TC;
  const int split = blockIdx.z;
  const int C = src.C;
  const int CJ = wgrad_cols(C);
  const int TFi = T * Fin;
  const int TFo = T * Fo;
  const int tx = threadIdx.x % (TC / 4);  // columns tx*4 .. tx*4+3
  const int ty = threadIdx.x / (TC / 4);  // rows ty*4 .. ty*4+3
  const int kk = threadIdx.x % WG_KC;     // staged position of this thread
  const int r0 = threadIdx.x / WG_KC;     // its first staged row / column

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int k_begin = split * chunks_per_split * WG_KC;
  const int k_end = min(K, k_begin + chunks_per_split * WG_KC);
  for (int kb = k_begin; kb < k_end; kb += WG_KC) {
    const int k = kb + kk;
    const bool kv = k < k_end;
    int b = 0, p = 0, t = 0, fo = 0;
    if (kv) {
      b = k / TFo;
      p = k - b * TFo;
      t = p / Fo;
      fo = p - t * Fo;
    }
    __syncthreads();  // the previous chunk is consumed
    for (int r = r0; r < TN; r += WG_STAGE_ROWS) {
      const int n = n0 + r;
      as[kk][r] = kv && n < N ? __ldg(g + ((size_t)b * N + n) * TFo + p)
                              : 0.f;
    }
    for (int r = r0; r < TC; r += WG_STAGE_ROWS) {
      const int col = col0 + r;
      float v = 0.f;
      if (kv && col < CJ) {
        if (col == CJ - 1) {
          v = 1.f;
        } else {
          const int c = col / 9;
          const int tap = col - 9 * c;
          int ti, fi;
          if (fwd_src<MODE>(t, fo, tap / 3, tap % 3, T, Fin, ti, fi)) {
            const float sc = scale ? __ldg(scale + b * C + c) : 1.f;
            const float mu = mean ? __ldg(mean + b * C + c) : 0.f;
            v = (__ldg(src.ptr(c) + src.plane(b, c) * TFi + ti * Fin + fi) -
                 mu) * sc;
          }
        }
      }
      bs[kk][r] = v;
    }
    __syncthreads();
    float cs[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[i][j] = 0.f;
#pragma unroll 8
    for (int q = 0; q < WG_KC; ++q) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[q][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[q][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[i][j] = fmaf(av[i], bv[j], cs[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += cs[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < CJ) part[((size_t)split * N + n) * CJ + col] = acc[i][j];
    }
  }
}

template <int MODE, int TN>
void launch_wgrad(const float* g, int N, Sources src, const float* scale,
                  const float* mean, float* wpart, int T, int Fin, int Fo,
                  int K, int splits, int cps, cudaStream_t st) {
  constexpr int TC = WG_TILE / TN;
  const dim3 grid((N + TN - 1) / TN, (wgrad_cols(src.C) + TC - 1) / TC,
                  splits);
  wgrad_kernel<MODE, TN><<<grid, WG_THREADS, 0, st>>>(
      g, N, src, scale, mean, wpart, T, Fin, Fo, K, cps);
}

// dW in the weight's own layout ([N, C, 3, 3], or [C, N, 3, 3] for the
// transpose modes) and dbias [N] from the splits' partials, added in split
// order in double.
template <bool TRANSPOSED>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    int splits, int N, int C,
                                    float* __restrict__ dw,
                                    float* __restrict__ dbias) {
  const int CJ = 9 * C + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * CJ) return;
  double s = 0.0;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * N * CJ + i];
  const int n = i / CJ;
  const int col = i - n * CJ;
  if (col == CJ - 1) {
    dbias[n] = (float)s;
    return;
  }
  const int c = col / 9;
  const int tap = col - 9 * c;
  const size_t o = TRANSPOSED ? ((size_t)c * N + n) * 9 + tap
                              : ((size_t)n * C + c) * 9 + tap;
  dw[o] = (float)s;
}

template <int MODE>
cudaError_t launch_bwd(const float* g, int N, Sources src, const float* scale,
                       const float* mean, const float* w, float* dx0,
                       float* dx1, float* dpart, float* sg, float* sgx,
                       float* wpart, float* dw, float* dbias, int B, int T,
                       int Fin, int Fo, cudaStream_t st) {
  const int C = src.C;
  if (dx0) {
    const int ntiles = (T * Fin + POS_TILE - 1) / POS_TILE;
    const dim3 grid(ntiles, (C + NB - 1) / NB, B);
    dgrad_kernel<MODE><<<grid, DG_THREADS, 0, st>>>(
        g, N, src, scale, mean, w, dx0, dx1, dpart, T, Fin, Fo);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (dpart) {
      e = launch_reduce_stats(dpart, sg, sgx, B * C, ntiles, st);
      if (e != cudaSuccess) return e;
    }
  }
  const int K = B * T * Fo;
  const int cps = wgrad_chunks_per_split(N, C, K);
  const int splits = wgrad_splits(N, C, K);
  const int CJ = wgrad_cols(C);
  switch (wgrad_rows(N)) {
    case 16:
      launch_wgrad<MODE, 16>(g, N, src, scale, mean, wpart, T, Fin, Fo, K,
                             splits, cps, st);
      break;
    case 32:
      launch_wgrad<MODE, 32>(g, N, src, scale, mean, wpart, T, Fin, Fo, K,
                             splits, cps, st);
      break;
    default:
      launch_wgrad<MODE, 64>(g, N, src, scale, mean, wpart, T, Fin, Fo, K,
                             splits, cps, st);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int kThreads = 256;
  wgrad_reduce_kernel<kTransposeMode<MODE>>
      <<<(N * CJ + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          wpart, splits, N, C, dw, dbias);
  return cudaGetLastError();
}

}  // namespace
}  // namespace misonet

// C entry point.  All tensors float32, contiguous, on the current device:
//   mode 0-3 as misonet_stencil (enc0, down, up, final), 4 = dense;
//   g [B, N, T, Fo] the folded cotangent of the conv output;
//   x0 [B, c0, T, Fin], x1 [B, c1, T, Fin] or NULL (c1 = 0; dense only);
//   scale, mean [B, c0 + c1], or NULL (identity, enc0);
//   w [N, C, 3, 3] for modes 0, 1, 4 and [C, N, 3, 3] for modes 2, 3;
//   dx0, dx1 like x0, x1, or dx0 = NULL to skip the dgrad (then dpart, sg
//   and sgx are unused);
//   dpart [2, B, C, ceil(T*Fin/256)] scratch and sg, sgx [B, C] (sum G,
//   sum G (x - mean)), or dpart = NULL to skip those sums;
//   wpart [misonet_stencil_bwd_splits(), N, 9C + 1] scratch;
//   dw like w, dbias [N].
// Returns cudaGetLastError() after the launches (0 on success); an unknown
// mode returns cudaErrorInvalidValue.
extern "C" int misonet_stencil_bwd(int mode, const float* g, int N,
                                   const float* x0, int c0, const float* x1,
                                   int c1, const float* scale,
                                   const float* mean, const float* w,
                                   float* dx0, float* dx1, float* dpart,
                                   float* sg, float* sgx, float* wpart,
                                   float* dw, float* dbias, int B, int T,
                                   int Fin, int Fo, void* stream) {
  using namespace misonet;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sources src{x0, x1 ? x1 : x0, c0, c0 + c1};
  switch (mode) {
    case B_ENC0:
      return (int)launch_bwd<B_ENC0>(g, N, src, scale, mean, w, dx0, dx1,
                                     dpart, sg, sgx, wpart, dw, dbias, B, T,
                                     Fin, Fo, st);
    case B_DOWN:
      return (int)launch_bwd<B_DOWN>(g, N, src, scale, mean, w, dx0, dx1,
                                     dpart, sg, sgx, wpart, dw, dbias, B, T,
                                     Fin, Fo, st);
    case B_UP:
      return (int)launch_bwd<B_UP>(g, N, src, scale, mean, w, dx0, dx1,
                                   dpart, sg, sgx, wpart, dw, dbias, B, T,
                                   Fin, Fo, st);
    case B_FINAL:
      return (int)launch_bwd<B_FINAL>(g, N, src, scale, mean, w, dx0, dx1,
                                      dpart, sg, sgx, wpart, dw, dbias, B, T,
                                      Fin, Fo, st);
    case B_DENSE:
      return (int)launch_bwd<B_DENSE>(g, N, src, scale, mean, w, dx0, dx1,
                                      dpart, sg, sgx, wpart, dw, dbias, B, T,
                                      Fin, Fo, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Splits of the wgrad's position range for a call: the leading axis of its
// `wpart` scratch.  K = B * T * Fo output positions.
extern "C" int misonet_stencil_bwd_splits(int N, int C, int K) {
  return misonet::wgrad_splits(N, C, K);
}
