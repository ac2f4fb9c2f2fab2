// stencil_bwd: the backward of the fused U-Net body convs on Hopper.
//
// Replaces misonet_tpu/ops/pallas/stencil_bwd.py::stencil_bwd_flat (its
// Pallas `_kernel`) in its float32 ("precise") and bfloat16 (precise=False,
// the JAX package's default) modes, the one fused backward of both forward
// kernels: dense_stack.cu (mode DENSE) and the four stencil.cu instances
// (ENC0, DOWN, UP, FINAL).  The forward it differentiates is
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
// and scale packing have no counterpart: each position maps to its
// taps directly and a tap outside the plane contributes 0.  The mean term
// of dW that the TPU kernel took from validity fields comes for free here,
// because the wgrad reads the normalized input xn with its zero halo.
//
// Modes (the storage type of g, the sources, the weights and dx):
// float32 throughout, or bfloat16 with the TPU kernel's rounding points:
// g arrives folded in float32 and rounded to bfloat16
// (ops/kernels/flat_grad.py); the dgrad multiplies bf16 weights by bf16
// cotangents with float32 sums; dx is rounded to bf16 for the store; sum G
// and sum G (x - mean) come from the float32 G; the wgrad multiplies bf16
// patch values by bf16 cotangents with float32 sums; dW, dbias and the
// sums stay float32.  One point differs on purpose: the TPU kernel's wgrad
// patch is the uncentred bf16(scale * x), its mean term scale * mean * M
// subtracted in float32 outside; this patch is the centred bf16((x - mean)
// * scale), the very values the port's forward (dense_stack.cu,
// stencil.cu) convolved.  So dW is the gradient of the forward that ran,
// the mean term needs no fields, and no large uncentred sum cancels against
// the mean term in float32.
//
// float32 kernels, per call (CUDA-core FMAs):
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
//   wgrad_reduce_kernel  sums the splits' partials (below) in a fixed
//                        order, in double, into dW and dbias.
//
// bfloat16 kernels, per call (tensor cores, mma.sync m16n8k16 bf16 x bf16
// -> float32; conv_mma.cuh has the layout and the six gather maps):
//   dgrad_tc_kernel<MODE, NT8>  the dense_stack forward's tensor-core
//                        kernel run as the mode's dgrad geometry: rows a
//                        2-D tile of 128 input positions, columns 16..64
//                        input channels, the reduction over units of 8
//                        cotangent channels at one tap, g staged
//                        channels-last (a tap of the other parity, DOWN,
//                        points at the zero row), the weight packed with
//                        output c and reduced n by the wrapper
//                        (tc_pack.py) and copied by cp.async.  Epilogue as
//                        the forward's, through shared memory: dx and the
//                        partials of sum G and sum G (x - mean).
//   wgrad_tc_kernel<MODE, WM, WN, WARPS_N>  rows the (c, tap) units plus
//                        one unit of ones (dbias) on the 16-row side of
//                        the mma, columns n on its 8-wide side (so MISO1's
//                        final N = 4 fills 4 of 8 slots), the reduction
//                        over chunks of 4 x 16 output positions: A by
//                        ldmatrix.trans from the normalized input staged
//                        channels-last (a window row is 8 channels of one
//                        position, so the transposed load gives 8
//                        channels x 8 positions, and a tap is a row
//                        pointer fixed per lane), B by ldmatrix from g
//                        staged [n][position].  The staging loads the raw
//                        bf16 input and normalizes with the block's
//                        (scale, mean) held in shared memory, and reads
//                        g's rows as aligned 32-bit words.
//   wgrad_reduce_kernel  as in float32.
//
// Where the trouble is, and what the design does about it:
//   * The wgrad reduction is long: B*T*Fo = 8*501*127 = 509,000 positions
//     at the enc0/dec6 level.  Blocks run in no order, so the positions are
//     cut into a fixed number of splits that depends only on the shapes
//     (about 4 blocks per SM in all); each block loops over its split's
//     chunks with its sums in float32 registers and writes ONE partial
//     tile.  The partials are added in split order, so gradients are the
//     same from run to run (no atomics, as the forward's statistics).  One
//     partial per position tile would have been ~0.5 GB at dec6 call 0;
//     the splits keep it to splits * N * (9C + 1) floats.  In bf16 a split
//     sums up to ~100 chunks of 64 positions in the mma's float32
//     accumulators; phase 17 holds dW to 1e-4 of max-abs against float64
//     sums and sees ~1e-6.
//   * dscale/dmean reduce over the input plane per (b, c): the forward's
//     two-pass statistics (block partials + a fixed-order pass in double).
//   * float32: bound by float32 FMA issue.  dgrad and wgrad each do the
//     forward's MACs: 1.19 TFLOP per B = 8 train step over the 60 calls,
//     >= 17.7 ms at the 67 TFLOP/s float32 peak; the bytes (g, x, dx, dW
//     read or written once) bound it far lower.  The dgrad reads its 9
//     taps through L1 and keeps up with a shared-memory-staged variant
//     (tried, PERF.md); the wgrad redoes the im2col gather of xn for every
//     32-position chunk and is the slower half.  The `up` wgrad multiplies
//     the taps of the other parity by zero, and N = 4 (final) fills a
//     quarter of the narrowest tile.  The bf16 kernels skip the wrong
//     parity's taps (the zero row costs an mma, not a load) and put N on
//     the mma's 8-wide side.
//   * bfloat16: at the bf16 tensor-core rate (989 TFLOP/s) its operations
//     and its bytes bound it about equally (0.44-0.49 ms over phase 17's
//     cases), far below its time: what limits it is the staging of the
//     operands (a diagnostic build without it ran the wgrad ~9x faster,
//     PERF.md), not the mmas.  The wgrad and the dgrad now take about
//     half of phase 17's time each.

#include <algorithm>

#include "conv_common.cuh"
#include "conv_mma.cuh"

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
template <typename S>
struct Sources {
  const S* x0;
  const S* x1;
  int c0;
  int C;
  __device__ __forceinline__ size_t plane(int b, int c) const {
    return c < c0 ? (size_t)b * c0 + c : (size_t)b * (C - c0) + (c - c0);
  }
  __device__ __forceinline__ const S* ptr(int c) const {
    return c < c0 ? x0 : x1;
  }
};

template <int MODE, typename S>
__global__ void __launch_bounds__(DG_THREADS, DG_MIN_BLOCKS)
dgrad_kernel(const S* __restrict__ g, int N, Sources<S> src,
             const float* __restrict__ scale, const float* __restrict__ mean,
             const S* __restrict__ w, S* __restrict__ dx0,
             S* __restrict__ dx1, float* __restrict__ part, int T,
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
      const S* gp = g + ((size_t)b * N + nb + k) * TFo;
      float gv[9][DG_PT];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int j = 0; j < DG_PT; ++j)
          gv[tap][j] = (mask[j] >> tap) & 1
                           ? ldg_f32(gp + base[j] +
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
    const S* xp = src.ptr(c) + pl;
    S* dxp = (c < src.c0 ? dx0 : dx1) + pl;
    const float sc = scale ? scale[b * C + c] : 1.f;
    const float mu = mean ? mean[b * C + c] : 0.f;
#pragma unroll
    for (int j = 0; j < DG_PT; ++j) {
      if (pos[j] >= TFi) continue;
      const float G = acc[i][j];
      store(dxp + pos[j], sc * G);
      if (part) {
        su[i] += G;
        sq[i] += G * (ldg_f32(xp + pos[j]) - mu);
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
template <int MODE, int TN, typename S>
__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const S* __restrict__ g, int N, Sources<S> src,
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
      as[kk][r] = kv && n < N ? ldg_f32(g + ((size_t)b * N + n) * TFo + p)
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
            // the forward's normalized input, rounded as it was there
            v = round_as<S>(
                (ldg_f32(src.ptr(c) + src.plane(b, c) * TFi + ti * Fin + fi) -
                 mu) * sc);
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

template <int MODE, int TN, typename S>
void launch_wgrad(const S* g, int N, Sources<S> src, const float* scale,
                  const float* mean, float* wpart, int T, int Fin, int Fo,
                  int K, int splits, int cps, cudaStream_t st) {
  constexpr int TC = WG_TILE / TN;
  const dim3 grid((N + TN - 1) / TN, (wgrad_cols(src.C) + TC - 1) / TC,
                  splits);
  wgrad_kernel<MODE, TN, S><<<grid, WG_THREADS, 0, st>>>(
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

template <int MODE, typename S>
cudaError_t launch_bwd(const S* g, int N, Sources<S> src, const float* scale,
                       const float* mean, const S* w, S* dx0, S* dx1,
                       float* dpart, float* sg, float* sgx,
                       float* wpart, float* dw, float* dbias, int B, int T,
                       int Fin, int Fo, cudaStream_t st) {
  const int C = src.C;
  if (dx0) {
    const int ntiles = (T * Fin + POS_TILE - 1) / POS_TILE;
    const dim3 grid(ntiles, (C + NB - 1) / NB, B);
    dgrad_kernel<MODE, S><<<grid, DG_THREADS, 0, st>>>(
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

// Dispatch on the mode for storage type S (see the C entry points below).
template <typename S>
int stencil_bwd(int mode, const S* g, int N, const S* x0, int c0, const S* x1,
                int c1, const float* scale, const float* mean, const S* w,
                S* dx0, S* dx1, float* dpart, float* sg, float* sgx,
                float* wpart, float* dw, float* dbias, int B, int T, int Fin,
                int Fo, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sources<S> src{x0, x1 ? x1 : x0, c0, c0 + c1};
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

// ---- the bfloat16 mode on tensor cores --------------------------------------

using bf16 = __nv_bfloat16;

// The gather map of each mode's dgrad (input position q, tap -> the g
// position p(q, tap)) and of its wgrad (output position p, tap -> the
// input position q(p, tap)); see tc::Map.
template <int MODE>
constexpr int kDgradMap = MODE == B_DENSE ? tc::M_SAME_T
                        : MODE == B_ENC0  ? tc::M_SHIFT_T
                        : MODE == B_DOWN  ? tc::M_HALF_T
                        : MODE == B_UP    ? tc::M_DOUBLE
                                          : tc::M_SHIFT;
template <int MODE>
constexpr int kWgradMap = MODE == B_DENSE ? tc::M_SAME
                        : MODE == B_ENC0  ? tc::M_SHIFT
                        : MODE == B_DOWN  ? tc::M_DOUBLE
                        : MODE == B_UP    ? tc::M_HALF_T
                                          : tc::M_SHIFT_T;

// dgrad: a tile of tc::GM_POS input positions x BN = 8 NT8 input channels
// of one batch element; the reduction over (n, tap) reads g staged
// channels-last; epilogue dx = bf16(scale G) and one partial of sum G and
// sum G (x - mean) per (b, c, tile).
template <int MODE, int NT8>
__global__ void __launch_bounds__(tc::GM_THREADS, tc::gm_min_blocks(NT8))
dgrad_tc_kernel(const bf16* __restrict__ g, int N, Sources<bf16> src,
                const float* __restrict__ scale,
                const float* __restrict__ mean, const bf16* __restrict__ w,
                bf16* __restrict__ dx0, bf16* __restrict__ dx1,
                float* __restrict__ part, int T, int Fin, int Fo) {
  constexpr int BN = 8 * NT8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int C = src.C;
  const int tw = tc::tile_w(Fin);
  const int ntc = (Fin + tw - 1) / tw;
  const int tile = blockIdx.x;
  const int t0 = (tile / ntc) * (tc::GM_POS / tw);
  const int f0 = (tile % ntc) * tw;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int TFi = T * Fin;
  const int TFo = T * Fo;
  float acc[NT8][4] = {};

  for (int nb = 0; nb < N; nb += 8 * tc::GMAX) {
    const int rk = min(8 * tc::GMAX, N - nb);
    const bf16* gp = g + ((size_t)b * N + nb) * TFo;
    // w: the weight packed with output c and reduced n (tc_pack.py); a tap
    // of the other parity (DOWN) reads the zero row
    tc::gather_chunk<tc::Geo<kDgradMap<MODE>>, NT8, bf16>(
        acc, tc_smem, tw, t0, f0, w, C, o0, nb / 8, (rk + 7) / 8, rk, T, Fo,
        [&](int k, int p) { return tc::bf16_at(gp + (size_t)k * TFo + p); });
  }

  // epilogue: dx = bf16(scale G), the partials of sum G and sum G (x -
  // mean)
  tc::finish_gather<NT8>(
      tc_smem, acc, tw, part != nullptr, C - o0, part, (size_t)b * C + o0,
      (size_t)gridDim.z * C, tile, gridDim.x,
      [&](int o, int pr, int pc, float gv) {
        const int c = o0 + o;
        const int t = t0 + pr;
        const int f = f0 + pc;
        if (c >= C || t >= T || f >= Fin) return make_float2(0.f, 0.f);
        const int q = t * Fin + f;
        const size_t pl = src.plane(b, c) * TFi;
        const float sc = scale ? scale[b * C + c] : 1.f;
        store((c < src.c0 ? dx0 : dx1) + pl + q, sc * gv);
        if (!part) return make_float2(0.f, 0.f);
        const float mu = mean ? mean[b * C + c] : 0.f;
        return make_float2(gv,
                           gv * (tc::bf16_at(src.ptr(c) + pl + q) - mu));
      });
}

template <int MODE, int NT8>
cudaError_t launch_dgrad_tc(const bf16* g, int N, Sources<bf16> src,
                            const float* scale, const float* mean,
                            const bf16* w, bf16* dx0, bf16* dx1, float* dpart,
                            int B, int T, int Fin, int Fo, cudaStream_t st) {
  constexpr int BN = 8 * NT8;
  const size_t smem =
      tc::gather_smem<tc::Geo<kDgradMap<MODE>>>(BN, tc::tile_w(Fin));
  cudaError_t e = cudaFuncSetAttribute(
      dgrad_tc_kernel<MODE, NT8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tc::pos_tiles(T, Fin), (src.C + BN - 1) / BN, B);
  dgrad_tc_kernel<MODE, NT8><<<grid, tc::GM_THREADS, smem, st>>>(
      g, N, src, scale, mean, w, dx0, dx1, dpart, T, Fin, Fo);
  return cudaGetLastError();
}

// wgrad: rows (c, tap) as units of 8 channels at one tap, then one unit of
// ones (dbias); columns n; the reduction over the output positions in
// chunks of WG_TH x WG_TW positions of one batch element.  A warp holds
// WM m16 tiles (2 WM units) x WN n8 tiles; WARPS_N warps across the
// columns.  A chunk's positions are one 16-position row per k-step: A by
// ldmatrix.trans from the channels-last window (a row of the window is 8
// channels at one position, so the transposed load gives 8 channels x 8
// positions), B by ldmatrix from g staged [n][position].
constexpr int WG_TH = 4;
constexpr int WG_TW = 16;
constexpr int WG_GROUPS = 8;  // groups one block's units can span
constexpr int WG_ROW = WG_GROUPS * tc::GROUP_BYTES + 16;
constexpr int WG_GROW = WG_TH * WG_TW * 2 + 16;  // bytes per staged g row

template <int WM, int WN, int WARPS_N>
struct WgradTile {
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int UB = 2 * WM * WARPS_M;  // units per block (<= 64)
  static constexpr int BN = 8 * WN * WARPS_N;  // columns per block
};

inline int wgrad_tc_chunks(int B, int T, int Fo) {
  return B * ((T + WG_TH - 1) / WG_TH) * ((Fo + WG_TW - 1) / WG_TW);
}

// (units, columns) per block of a call with N columns; launch_bwd_tc
// switches on the same thresholds.
inline void wgrad_tc_tile(int N, int& ub, int& bn) {
  if (N <= 8) {
    ub = WgradTile<4, 1, 1>::UB;
    bn = WgradTile<4, 1, 1>::BN;
  } else if (N <= 16) {
    ub = WgradTile<4, 2, 1>::UB;
    bn = WgradTile<4, 2, 1>::BN;
  } else if (N <= 32) {
    ub = WgradTile<4, 4, 1>::UB;
    bn = WgradTile<4, 4, 1>::BN;
  } else {
    ub = WgradTile<4, 4, 2>::UB;
    bn = WgradTile<4, 4, 2>::BN;
  }
}

// Chunks per split of the bf16 wgrad: a function of the shapes alone, so
// the reduction order is the same from run to run; about 4 blocks per SM.
inline int wgrad_tc_chunks_per_split(int N, int C, int B, int T, int Fo) {
  int ub, bn;
  wgrad_tc_tile(N, ub, bn);
  const int units = 9 * ((C + 7) / 8) + 1;
  const int tiles = ((units + ub - 1) / ub) * ((N + bn - 1) / bn);
  const int chunks = wgrad_tc_chunks(B, T, Fo);
  int splits = (WG_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, chunks));
  return (chunks + splits - 1) / splits;
}

inline int wgrad_tc_splits(int N, int C, int B, int T, int Fo) {
  const int cps = wgrad_tc_chunks_per_split(N, C, B, T, Fo);
  return (wgrad_tc_chunks(B, T, Fo) + cps - 1) / cps;
}

template <int MODE, int WM, int WN, int WARPS_N>
__global__ void __launch_bounds__(256, 2)
wgrad_tc_kernel(const bf16* __restrict__ g, int N, Sources<bf16> src,
                const float* __restrict__ scale,
                const float* __restrict__ mean, float* __restrict__ part,
                int B, int T, int Fin, int Fo, int chunks_per_split) {
  using G = tc::Geo<kWgradMap<MODE>>;
  using Tile = WgradTile<WM, WN, WARPS_N>;
  constexpr int UB = Tile::UB;
  constexpr int BN = Tile::BN;
  constexpr int SW = G::width(WG_TW);
  constexpr int N_WIN = (WG_TH + 2) * SW;
  static_assert((UB + 7) / 9 + 1 <= WG_GROUPS,
                "a block's units span more groups than a window row holds");
  __shared__ __align__(16) unsigned char win[(N_WIN + 2) * WG_ROW];
  __shared__ __align__(16) unsigned char gs[BN * WG_GROW];
  const int C = src.C;
  const int n_groups = (C + 7) / 8;
  const int ones_unit = 9 * n_groups;
  const int u0 = blockIdx.x * UB;
  const int n0 = blockIdx.y * BN;
  const int g_lo = min(u0 / 9, n_groups - 1);
  const int groups = min(n_groups - 1, (u0 + UB - 1) / 9) - g_lo + 1;
  const int TFi = T * Fin;
  const int TFo = T * Fo;
  const int ntc = (Fo + WG_TW - 1) / WG_TW;
  const int per_b = ((T + WG_TH - 1) / WG_TH) * ntc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp - wm * WARPS_N;
  // the zero row and the row of ones after the window
  for (int i = threadIdx.x; i < WG_ROW / 2; i += blockDim.x) {
    reinterpret_cast<unsigned short*>(win + N_WIN * WG_ROW)[i] = 0;
    reinterpret_cast<unsigned short*>(win + (N_WIN + 1) * WG_ROW)[i] =
        0x3f80;  // bf16 1.0
  }
  const uint32_t win_s = tc::smem_addr(win);
  // this lane's A rows: matrix j = lane >> 3 of m16 tile i is (unit
  // 2 mt + (j & 1), positions 8 (j >> 1) .. + 7 of the k-step's row).
  // The window column of a tap does not depend on the chunk's origin, so
  // the address is fixed per lane; k-step r adds r window rows (a_step)
  const int kk = (lane >> 4) * 8 + (lane & 7);
  uint32_t a_base[WM], a_step[WM];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const int u = u0 + 2 * (wm * WM + i) + ((lane >> 3) & 1);
    a_base[i] = win_s + N_WIN * WG_ROW;  // the zero row
    a_step[i] = 0;
    if (u < ones_unit) {
      const int gr = u / 9;
      const int tap = u - 9 * gr;
      const int kt = tap / 3;
      const int col = G::col(kk, tap - 3 * kt, G::lo(0));
      if (col >= 0) {
        a_base[i] = win_s + ((1 + G::TS * (kt - 1)) * SW + col) * WG_ROW +
                    (gr - g_lo) * tc::GROUP_BYTES;
        a_step[i] = SW * WG_ROW;
      }
    } else if (u == ones_unit) {
      a_base[i] += WG_ROW;  // the row of ones
    }
  }
  // B: matrix j of an x4 is (n8 tile + (j >> 1), k half j & 1); an x2
  // reads matrices 0 and 1
  const int jb = lane >> 3;
  const uint32_t b_lane =
      tc::smem_addr(gs) +
      ((wn * WN + (WN == 1 ? 0 : (jb >> 1))) * 8 + (lane & 7)) * WG_GROW +
      (jb & 1) * 16;

  // the staging of a chunk: a window item is 8 channels of one window
  // position, loaded raw and stored as the forward's normalized input,
  // rounded as it was there: bf16((x - mean) * scale), with the block's
  // coefficients of the chunk's batch element (scale 0 past C) and zero
  // outside the plane; a g item is 2 positions of one column n
  __shared__ float co_s[WG_GROUPS * 8], co_m[WG_GROUPS * 8];
  const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
  // g's rows are read as 32-bit words where its base allows
  const bool words = (reinterpret_cast<uintptr_t>(g) & 3) == 0;
  auto stage = [&](int k) {
    const int b = k / per_b;
    const int rem = k - b * per_b;
    const int t0 = (rem / ntc) * WG_TH;
    const int f0 = (rem % ntc) * WG_TW;
    const int lo = G::lo(f0);
#pragma unroll 2
    for (int i = threadIdx.x; i < N_WIN * groups; i += 256) {
      const int gr = i / N_WIN;
      const int pos = i - gr * N_WIN;
      const int wr = pos / SW;
      const int ts = t0 - 1 + wr;
      const int fs = lo + pos - wr * SW;
      const int c0 = 8 * (g_lo + gr);
      uint32_t raw[4] = {0, 0, 0, 0};
      const bool in = ts >= 0 && ts < T && fs >= 0 && fs < Fin;
      if (in) {
        const int p = ts * Fin + fs;
        if (c0 + 8 <= C && (c0 + 8 <= src.c0 || c0 >= src.c0)) {
          // 8 channels of one source: consecutive planes
          const unsigned short* xp = reinterpret_cast<const unsigned short*>(
              src.ptr(c0) + src.plane(b, c0) * TFi + p);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            raw[e >> 1] |= (uint32_t)__ldg(xp + (size_t)e * TFi)
                           << (16 * (e & 1));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = c0 + e;
            if (c < C)
              raw[e >> 1] |=
                  (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(
                      src.ptr(c) + src.plane(b, c) * TFi + p))
                  << (16 * (e & 1));
          }
        }
      }
      uint32_t q[4] = {0, 0, 0, 0};
      if (in) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c = 8 * gr + 2 * h;
          const float x0 = __uint_as_float(raw[h] << 16);
          const float x1 = __uint_as_float(raw[h] & 0xffff0000u);
          q[h] = tc::pack_bf16((x0 - co_m[c]) * co_s[c],
                               (x1 - co_m[c + 1]) * co_s[c + 1]);
        }
      }
      *reinterpret_cast<uint4*>(win + pos * WG_ROW + gr * tc::GROUP_BYTES) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
    // g: a thread takes one (n, tile row) run of WG_TW positions; inside
    // the row it reads aligned 32-bit words (one more, funnel-shifted,
    // for a run at an odd element), at the plane's edge 2-byte values
    for (int i = threadIdx.x; i < BN * WG_TH; i += 256) {
      const int n = i / WG_TH;
      const int r = i - n * WG_TH;
      const int t = t0 + r;
      uint32_t v[WG_TW / 2];
#pragma unroll
      for (int k = 0; k < WG_TW / 2; ++k) v[k] = 0;
      if (n0 + n < N && t < T) {
        const size_t idx =
            ((size_t)b * N + n0 + n) * TFo + (size_t)t * Fo + f0;
        if (words && f0 + WG_TW < Fo) {
          const uint32_t* wp =
              reinterpret_cast<const uint32_t*>(gu + (idx & ~(size_t)1));
          if (idx & 1) {
            uint32_t u[WG_TW / 2 + 1];
#pragma unroll
            for (int k = 0; k <= WG_TW / 2; ++k) u[k] = __ldg(wp + k);
#pragma unroll
            for (int k = 0; k < WG_TW / 2; ++k)
              v[k] = __funnelshift_r(u[k], u[k + 1], 16);
          } else {
#pragma unroll
            for (int k = 0; k < WG_TW / 2; ++k) v[k] = __ldg(wp + k);
          }
        } else {
#pragma unroll
          for (int e = 0; e < WG_TW; ++e)
            if (f0 + e < Fo)
              v[e >> 1] |= (uint32_t)__ldg(gu + idx + e) << (16 * (e & 1));
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(gs + n * WG_GROW +
                                            r * WG_TW * 2);
#pragma unroll
      for (int k = 0; k < WG_TW / 8; ++k)
        dst[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                            v[4 * k + 3]);
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_begin = blockIdx.z * chunks_per_split;
  const int k_end = min(B * per_b, k_begin + chunks_per_split);
  int b_cur = -1;
  for (int k = k_begin; k < k_end; ++k) {
    const int b = k / per_b;
    __syncthreads();  // the previous chunk is consumed
    if (b != b_cur) {  // block-uniform
      for (int i = threadIdx.x; i < WG_GROUPS * 8; i += 256) {
        const int c = 8 * g_lo + i;
        co_s[i] = c < C ? (scale ? scale[b * C + c] : 1.f) : 0.f;
        co_m[i] = c < C && mean ? mean[b * C + c] : 0.f;
      }
      __syncthreads();
      b_cur = b;
    }
    stage(k);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < WG_TH; ++r) {
      uint32_t a[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i)
        tc::ldsm_x4_trans(a_base[i] + r * a_step[i], a[i]);
#pragma unroll
      for (int jp = 0; jp < (WN + 1) / 2; ++jp) {
        uint32_t bf[4];
        const uint32_t ba = b_lane + jp * 16 * WG_GROW + r * WG_TW * 2;
        if (WN == 1) {
          tc::ldsm_x2(ba, bf[0], bf[1]);
        } else {
          tc::ldsm_x4(ba, bf);
        }
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          tc::mma(acc[i][2 * jp], a[i], bf[0], bf[1]);
          if (WN > 1) tc::mma(acc[i][2 * jp + 1], a[i], bf[2], bf[3]);
        }
      }
    }
  }

  // rows: c0/c1 at row lane >> 2 of the m16 tile (unit 2 mt), c2/c3 at
  // row + 8 (unit 2 mt + 1); a row of a unit is channel 8 gr + row
  const int CJ = wgrad_cols(C);
  const size_t base = (size_t)blockIdx.z * N;
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = u0 + 2 * (wm * WM + i) + h;
      int col;
      if (u < ones_unit) {
        const int gr = u / 9;
        const int c = 8 * gr + (lane >> 2);
        if (c >= C) continue;
        col = 9 * c + (u - 9 * gr);
      } else if (u == ones_unit && (lane >> 2) == 0) {
        col = CJ - 1;
      } else {
        continue;
      }
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + (wn * WN + j) * 8 + 2 * (lane & 3) + e;
          if (n < N) part[(base + n) * CJ + col] = acc[i][j][2 * h + e];
        }
    }
}

template <int MODE, int WM, int WN, int WARPS_N>
cudaError_t launch_wgrad_tc(const bf16* g, int N, Sources<bf16> src,
                            const float* scale, const float* mean,
                            float* wpart, int B, int T, int Fin, int Fo,
                            cudaStream_t st) {
  using Tile = WgradTile<WM, WN, WARPS_N>;
  const int units = 9 * ((src.C + 7) / 8) + 1;
  const int cps = wgrad_tc_chunks_per_split(N, src.C, B, T, Fo);
  const dim3 grid((units + Tile::UB - 1) / Tile::UB,
                  (N + Tile::BN - 1) / Tile::BN,
                  wgrad_tc_splits(N, src.C, B, T, Fo));
  wgrad_tc_kernel<MODE, WM, WN, WARPS_N><<<grid, 256, 0, st>>>(
      g, N, src, scale, mean, wpart, B, T, Fin, Fo, cps);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_bwd_tc(const bf16* g, int N, Sources<bf16> src,
                          const float* scale, const float* mean,
                          const bf16* w, bf16* dx0, bf16* dx1, float* dpart,
                          float* sg, float* sgx, float* wpart, float* dw,
                          float* dbias, int B, int T, int Fin, int Fo,
                          cudaStream_t st) {
  const int C = src.C;
  cudaError_t e;
  if (dx0) {
    switch (tc::pick_nt8(C, 8)) {
#define MISONET_DGRAD_TC(NT8)                                             \
  case NT8:                                                               \
    e = launch_dgrad_tc<MODE, NT8>(g, N, src, scale, mean, w, dx0, dx1,   \
                                   dpart, B, T, Fin, Fo, st);             \
    break;
      MISONET_DGRAD_TC(2)
      MISONET_DGRAD_TC(4)
      MISONET_DGRAD_TC(6)
      MISONET_DGRAD_TC(8)
#undef MISONET_DGRAD_TC
      default:
        return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
    if (dpart) {
      e = launch_reduce_stats(dpart, sg, sgx, B * C, tc::pos_tiles(T, Fin),
                              st);
      if (e != cudaSuccess) return e;
    }
  }
  if (N <= 8)
    e = launch_wgrad_tc<MODE, 4, 1, 1>(g, N, src, scale, mean, wpart, B, T,
                                       Fin, Fo, st);
  else if (N <= 16)
    e = launch_wgrad_tc<MODE, 4, 2, 1>(g, N, src, scale, mean, wpart, B, T,
                                       Fin, Fo, st);
  else if (N <= 32)
    e = launch_wgrad_tc<MODE, 4, 4, 1>(g, N, src, scale, mean, wpart, B, T,
                                       Fin, Fo, st);
  else
    e = launch_wgrad_tc<MODE, 4, 4, 2>(g, N, src, scale, mean, wpart, B, T,
                                       Fin, Fo, st);
  if (e != cudaSuccess) return e;
  constexpr int kThreads = 256;
  wgrad_reduce_kernel<kTransposeMode<MODE>>
      <<<(N * wgrad_cols(C) + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          wpart, wgrad_tc_splits(N, C, B, T, Fo), N, C, dw, dbias);
  return cudaGetLastError();
}

// Dispatch on the mode (bfloat16; see the C entry points below).
int stencil_bwd_bf16(int mode, const bf16* g, int N, const bf16* x0, int c0,
                     const bf16* x1, int c1, const float* scale,
                     const float* mean, const bf16* w, bf16* dx0, bf16* dx1,
                     float* dpart, float* sg, float* sgx, float* wpart,
                     float* dw, float* dbias, int B, int T, int Fin, int Fo,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sources<bf16> src{x0, x1 ? x1 : x0, c0, c0 + c1};
  switch (mode) {
#define MISONET_BWD_TC(M)                                                  \
  case M:                                                                  \
    return (int)launch_bwd_tc<M>(g, N, src, scale, mean, w, dx0, dx1,      \
                                 dpart, sg, sgx, wpart, dw, dbias, B, T,   \
                                 Fin, Fo, st);
    MISONET_BWD_TC(B_ENC0)
    MISONET_BWD_TC(B_DOWN)
    MISONET_BWD_TC(B_UP)
    MISONET_BWD_TC(B_FINAL)
    MISONET_BWD_TC(B_DENSE)
#undef MISONET_BWD_TC
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace misonet

// C entry points.  All tensors contiguous, on the current device; g, x0,
// x1, w, dx0 and dx1 float32 (misonet_stencil_bwd) or bfloat16
// (misonet_stencil_bwd_bf16), everything else float32:
//   mode 0-3 as misonet_stencil (enc0, down, up, final), 4 = dense;
//   g [B, N, T, Fo] the folded cotangent of the conv output;
//   x0 [B, c0, T, Fin], x1 [B, c1, T, Fin] or NULL (c1 = 0; dense only);
//   scale, mean [B, c0 + c1], or NULL (identity, enc0);
//   w [N, C, 3, 3] for modes 0, 1, 4 and [C, N, 3, 3] for modes 2, 3
//   (float32); bfloat16: packed by ops/kernels/tc_pack.py with output
//   channel c and reduced channel n, [ceil(N/8), 9, C, 8] (read only by
//   the dgrad);
//   dx0, dx1 like x0, x1, or dx0 = NULL to skip the dgrad (then dpart, sg
//   and sgx are unused);
//   dpart [2, B, C, ntiles] scratch, ntiles = ceil(T*Fin/256) (float32)
//   or misonet_tc_pos_tiles(T, Fin) (bfloat16), and sg, sgx [B, C] (sum G,
//   sum G (x - mean)), or dpart = NULL to skip those sums;
//   wpart [splits, N, 9C + 1] scratch, splits from
//   misonet_stencil_bwd_splits (float32) or
//   misonet_stencil_bwd_bf16_splits (bfloat16);
//   dw of w's shape (float32), dbias [N].
// Return cudaGetLastError() after the launches (0 on success); an unknown
// mode returns cudaErrorInvalidValue.
extern "C" int misonet_stencil_bwd(int mode, const float* g, int N,
                                   const float* x0, int c0, const float* x1,
                                   int c1, const float* scale,
                                   const float* mean, const float* w,
                                   float* dx0, float* dx1, float* dpart,
                                   float* sg, float* sgx, float* wpart,
                                   float* dw, float* dbias, int B, int T,
                                   int Fin, int Fo, void* stream) {
  return misonet::stencil_bwd(mode, g, N, x0, c0, x1, c1, scale, mean, w,
                              dx0, dx1, dpart, sg, sgx, wpart, dw, dbias, B,
                              T, Fin, Fo, stream);
}

extern "C" int misonet_stencil_bwd_bf16(
    int mode, const __nv_bfloat16* g, int N, const __nv_bfloat16* x0, int c0,
    const __nv_bfloat16* x1, int c1, const float* scale, const float* mean,
    const __nv_bfloat16* w, __nv_bfloat16* dx0, __nv_bfloat16* dx1,
    float* dpart, float* sg, float* sgx, float* wpart, float* dw,
    float* dbias, int B, int T, int Fin, int Fo, void* stream) {
  return misonet::stencil_bwd_bf16(mode, g, N, x0, c0, x1, c1, scale, mean,
                                   w, dx0, dx1, dpart, sg, sgx, wpart, dw,
                                   dbias, B, T, Fin, Fo, stream);
}

// Splits of the wgrad's position range for a call: the leading axis of its
// `wpart` scratch.  K = B * T * Fo output positions.
extern "C" int misonet_stencil_bwd_splits(int N, int C, int K) {
  return misonet::wgrad_splits(N, C, K);
}

// The same for the bfloat16 mode, whose splits cut B * T * Fo output
// positions into chunks of 4 x 16 positions of one batch element.
extern "C" int misonet_stencil_bwd_bf16_splits(int N, int C, int B, int T,
                                               int Fo) {
  return misonet::wgrad_tc_splits(N, C, B, T, Fo);
}
