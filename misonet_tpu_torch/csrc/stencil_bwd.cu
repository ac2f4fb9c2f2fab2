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
// Both modes run the same two kernels on the tensor cores (conv_mma.cuh
// has the layout, the six gather maps and the products: float32 as three
// `mma.sync m16n8k8` TF32 passes over split operands, big big + big
// small + small big with float32 sums; bf16 `mma.sync m16n8k16`
// bf16 x bf16 -> float32), per call:
//   dgrad_tc_kernel<MODE, NT8, E>  the dense_stack forward's tensor-core
//                        kernel run as the mode's dgrad geometry: rows a
//                        2-D tile of 128 input positions, columns 16..64
//                        input channels, the reduction over units of one
//                        16-byte group of cotangent channels (4 float32 or
//                        8 bf16) at one tap, g staged channels-last (a tap
//                        of the other parity, DOWN, points at the zero
//                        row), the weight packed with output c and reduced
//                        n by the wrapper (tc_pack.py; float32 as TF32 big
//                        and small planes, by tc_pack.cu) and copied by
//                        cp.async.  Epilogue as the forward's, through
//                        shared memory: dx and the partials of sum G and
//                        sum G (x - mean), added by reduce_stats_kernel
//                        (conv_common.cuh).  Each mode's dgrad is another
//                        forward geometry: DENSE the SAME conv with
//                        flipped taps, DOWN the stride-2 transpose, UP the
//                        stride-2 conv, FINAL the VALID conv F+2 -> F.
//                        ENC0 runs it only when dx is asked for (the train
//                        step does not ask).
//   wgrad_tc_kernel<MODE, WM, WN, WARPS_N, E>  rows the (c, tap) units of
//                        8 channels at one tap plus one unit of ones
//                        (dbias) on the 16-row side of the mma, columns n
//                        on its 8-wide side (so MISO1's final N = 4 fills
//                        4 of 8 slots), the reduction over chunks of 4 x
//                        16 output positions, B by ldmatrix from g staged
//                        [n][position].  A comes from the normalized input
//                        staged channels-last, a tap a row pointer fixed
//                        per lane: in bf16 by ldmatrix.trans (a window row
//                        is 8 channels of one position, so the transposed
//                        load gives 8 channels x 8 positions); in float32
//                        by 32-bit shared loads (.trans moves 16-bit
//                        elements and would cut a float in half), a0 =
//                        A[g][t], a1 = A[g+8][t], a2, a3 at t + 4 (g =
//                        lane / 4 a channel, t = lane % 4 a position), the
//                        window row padded to 8 words mod 32 so the 32
//                        lanes read 32 banks (DOWN's, two columns apart,
//                        meet in pairs).  The staging loads the raw input
//                        and normalizes with the block's (scale, mean) held
//                        in shared memory (float32: and splits both
//                        operands into TF32 big and small planes there,
//                        once, not at each of a value's uses); bf16 reads
//                        g's rows as aligned 32-bit words.
//   wgrad_reduce_kernel  sums the splits' partials (below) in a fixed
//                        order, in double, into dW and dbias.
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
//     sums and sees ~1e-6.  float32 is held to 1e-5 of the float64 run:
//     each chunk's 24 TF32 mmas sum into fresh accumulators, added to the
//     split's float32 sums once a chunk, so no accumulator runs longer
//     than one chunk (the tensor cores' float32 sums are not rounded to
//     nearest).
//   * dscale/dmean reduce over the input plane per (b, c): the forward's
//     two-pass statistics (block partials + a fixed-order pass in double).
//   * float32: its operations at a third of the TF32 rate (495 / 3
//     TFLOP/s) bound it: the dgrad and the wgrad each do the forward's
//     MACs, 1.19 TFLOP per B = 8 train step over the 60 calls, >= 7.2 ms
//     (17.7 at the 67 TFLOP/s of the FMA loops these kernels replaced).
//     Its window holds half as many channels per byte as bf16's and it
//     issues 6x the mmas per channel (k = 8, three passes), plus the
//     splits' conversions.
//   * bfloat16: at the bf16 tensor-core rate (989 TFLOP/s) its operations
//     and its bytes bound it about equally (0.44-0.49 ms over phase 17's
//     cases), far below its time: what limits it is the staging of the
//     operands (a diagnostic build without it ran the wgrad ~9x faster,
//     PERF.md), not the mmas.  The wgrad and the dgrad now take about
//     half of phase 17's time each.

#include <algorithm>

#include "conv_common.cuh"
#include "conv_mma.cuh"
#include "smem_limit.cuh"

namespace misonet {
namespace {

enum BwdMode { B_ENC0 = 0, B_DOWN = 1, B_UP = 2, B_FINAL = 3, B_DENSE = 4 };

template <int MODE>
constexpr bool kTransposeMode = MODE == B_UP || MODE == B_FINAL;

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

// ---- dgrad -----------------------------------------------------------------

// A tile of tc::GM_POS input positions x BN = 8 NT8 input channels of one
// batch element, in storage type E; the reduction over (n, tap) reads g
// staged channels-last; epilogue dx = scale G (rounded to E) and one
// partial of sum G and sum G (x - mean) per (b, c, tile).
template <int MODE, int NT8, typename E>
__global__ void __launch_bounds__(tc::GM_THREADS, tc::gm_min_blocks<E>(NT8))
dgrad_tc_kernel(const E* __restrict__ g, int N, Sources<E> src,
                const float* __restrict__ scale,
                const float* __restrict__ mean, const E* __restrict__ w,
                E* __restrict__ dx0, E* __restrict__ dx1,
                float* __restrict__ part, int T, int Fin, int Fo) {
  constexpr int BN = 8 * NT8;
  constexpr int EPG = tc::GROUP_BYTES / sizeof(E);  // channels a group
  constexpr int CH = EPG * tc::GMAX;                // channels a chunk
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
  // float32: the weight's small plane after the big one
  const size_t plane = (size_t)((N + EPG - 1) / EPG) * 9 * C;
  float acc[NT8][4] = {};

  for (int nb = 0; nb < N; nb += CH) {
    const int rk = min(CH, N - nb);
    const E* gp = g + ((size_t)b * N + nb) * TFo;
    // w: the weight packed with output c and reduced n (tc_pack.py); a tap
    // of the other parity (DOWN) reads the zero row
    tc::gather_chunk<tc::Geo<kDgradMap<MODE>>, NT8, E>(
        acc, tc_smem, tw, t0, f0, w, plane, C, o0, nb / EPG,
        (rk + EPG - 1) / EPG, rk, T, Fo,
        [&](int k, int p) { return ldg_f32(gp + (size_t)k * TFo + p); });
  }

  // epilogue: dx = scale G, the partials of sum G and sum G (x - mean)
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
        return make_float2(gv, gv * (ldg_f32(src.ptr(c) + pl + q) - mu));
      });
}

template <int MODE, int NT8, typename E>
cudaError_t launch_dgrad_tc(const E* g, int N, Sources<E> src,
                            const float* scale, const float* mean,
                            const E* w, E* dx0, E* dx1, float* dpart, int B,
                            int T, int Fin, int Fo, cudaStream_t st) {
  constexpr int BN = 8 * NT8;
  const size_t smem =
      tc::gather_smem<tc::Geo<kDgradMap<MODE>>, E>(BN, tc::tile_w(Fin));
  static SmemLimit limit;
  const cudaError_t e = limit.raise(dgrad_tc_kernel<MODE, NT8, E>);
  if (e != cudaSuccess) return e;
  const dim3 grid(tc::pos_tiles(T, Fin), (src.C + BN - 1) / BN, B);
  dgrad_tc_kernel<MODE, NT8, E><<<grid, tc::GM_THREADS, smem, st>>>(
      g, N, src, scale, mean, w, dx0, dx1, dpart, T, Fin, Fo);
  return cudaGetLastError();
}

// ---- wgrad -----------------------------------------------------------------

// Rows (c, tap) as units of 8 channels at one tap, then one unit of ones
// (dbias); columns n; the reduction over the output positions in chunks
// of WG_TH x WG_TW positions of one batch element.  A warp holds WM m16
// tiles (2 WM units) x WN n8 tiles; WARPS_N warps across the columns.  A
// k-step is 16 positions of one chunk row in bf16, 8 in float32.
constexpr int WG_TH = 4;
constexpr int WG_TW = 16;
constexpr int WG_GROUPS = 8;  // 8-channel blocks one block's units can span
constexpr int WG_TARGET_BLOCKS = 4 * 132;  // about 4 per SM of an H100

template <int WM, int WN, int WARPS_N>
struct WgradTile {
  static constexpr int WM_ = WM, WN_ = WN, WARPS_N_ = WARPS_N;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int UB = 2 * WM * WARPS_M;  // units per block (<= 64)
  static constexpr int BN = 8 * WN * WARPS_N;  // columns per block
  static constexpr int CB = (UB + 7) / 9 + 1;  // 8-channel blocks spanned
  static_assert(CB <= WG_GROUPS,
                "a block's units span more channels than a window row holds");
};

// The tile of a call with N columns: rows 2 WM units a warp (WM = 2 in
// float32, whose split operands and per-chunk sums take more registers),
// columns the narrowest that hold N.
template <typename E, class Fn>
decltype(auto) with_wgrad_tile(int N, Fn fn) {
  constexpr int WM = tc::kTf32<E> ? 2 : 4;
  if (N <= 8) return fn(WgradTile<WM, 1, 1>{});
  if (N <= 16) return fn(WgradTile<WM, 2, 1>{});
  if (N <= 32) return fn(WgradTile<WM, 4, 1>{});
  return fn(WgradTile<WM, 4, 2>{});
}

// The shared memory of a wgrad block: the window ((WG_TH + 2) rows of
// SW = G::width(WG_TW) positions, a zero row, a row of ones), then g
// staged [BN][WG_TH x WG_TW positions]; float32 keeps two planes of each,
// the TF32 big and small parts (split once, as they stage).  Window rows:
// bf16 8 blocks of 8 channels + 16 bytes (9 16-byte slots, so the 8 rows
// an ldmatrix reads fall in distinct banks); float32 the tile's CB blocks
// + a pad that makes the row 8 words mod 32, so the 8 channels x 4
// positions of a warp's 32-bit A load fall in distinct banks (M_DOUBLE's
// positions, two columns apart, meet in pairs: a 4-word pad would avoid
// that, at the cost of the second block per SM).
template <int MODE, class Tile, typename E>
struct WgradSmem {
  static constexpr int MAP = kWgradMap<MODE>;
  static constexpr int SW = tc::Geo<MAP>::width(WG_TW);
  static constexpr int N_WIN = (WG_TH + 2) * SW;
  static constexpr int ROW_WORDS = 8 * Tile::CB;
  static constexpr int ROW =
      tc::kTf32<E> ? 4 * (ROW_WORDS + (8 - ROW_WORDS % 32 + 32) % 32)
                   : WG_GROUPS * tc::GROUP_BYTES + 16;
  static constexpr int GROW = WG_TH * WG_TW * (int)sizeof(E) + 16;
  static constexpr int WIN_PLANE = (N_WIN + 2) * ROW;
  static constexpr int GS_PLANE = Tile::BN * GROW;
  static constexpr int WIN_BYTES = tc::kPlanes<E> * WIN_PLANE;
  static constexpr int BYTES = WIN_BYTES + tc::kPlanes<E> * GS_PLANE;
};

// Columns of the GEMM: 9 C (c, tap) pairs, then one of ones (dbias).
__host__ __device__ inline int wgrad_cols(int C) { return 9 * C + 1; }

inline int wgrad_tc_chunks(int B, int T, int Fo) {
  return B * ((T + WG_TH - 1) / WG_TH) * ((Fo + WG_TW - 1) / WG_TW);
}

// Chunks per split of the wgrad: a function of the shapes alone, so the
// reduction order is the same from run to run; about 4 blocks per SM.
template <typename E>
int wgrad_tc_chunks_per_split(int N, int C, int B, int T, int Fo) {
  const int units = 9 * ((C + 7) / 8) + 1;
  const int tiles = with_wgrad_tile<E>(N, [&](auto tile) {
    using Tile = decltype(tile);
    return ((units + Tile::UB - 1) / Tile::UB) *
           ((N + Tile::BN - 1) / Tile::BN);
  });
  const int chunks = wgrad_tc_chunks(B, T, Fo);
  int splits = (WG_TARGET_BLOCKS + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, chunks));
  return (chunks + splits - 1) / splits;
}

template <typename E>
int wgrad_tc_splits(int N, int C, int B, int T, int Fo) {
  const int cps = wgrad_tc_chunks_per_split<E>(N, C, B, T, Fo);
  return (wgrad_tc_chunks(B, T, Fo) + cps - 1) / cps;
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

template <int MODE, int WM, int WN, int WARPS_N, typename E>
__global__ void __launch_bounds__(256, 2)
wgrad_tc_kernel(const E* __restrict__ g, int N, Sources<E> src,
                const float* __restrict__ scale,
                const float* __restrict__ mean, float* __restrict__ part,
                int B, int T, int Fin, int Fo, int chunks_per_split) {
  using G = tc::Geo<kWgradMap<MODE>>;
  using Tile = WgradTile<WM, WN, WARPS_N>;
  using L = WgradSmem<MODE, Tile, E>;
  constexpr bool F32 = tc::kTf32<E>;
  constexpr int BN = Tile::BN;
  constexpr int SW = L::SW;
  constexpr int N_WIN = L::N_WIN;
  constexpr int ROW = L::ROW;
  constexpr int GROW = L::GROW;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* win = wg_smem;
  unsigned char* gs = wg_smem + L::WIN_BYTES;
  const int C = src.C;
  const int n_groups = (C + 7) / 8;
  const int ones_unit = 9 * n_groups;
  const int u0 = blockIdx.x * Tile::UB;
  const int n0 = blockIdx.y * BN;
  const int g_lo = min(u0 / 9, n_groups - 1);
  const int groups = min(n_groups - 1, (u0 + Tile::UB - 1) / 9) - g_lo + 1;
  const int TFi = T * Fin;
  const int TFo = T * Fo;
  const int ntc = (Fo + WG_TW - 1) / WG_TW;
  const int per_b = ((T + WG_TH - 1) / WG_TH) * ntc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp - wm * WARPS_N;
  // the zero row and the row of ones after the window (float32: zero in
  // the small plane)
  for (int i = threadIdx.x; i < ROW / 4; i += blockDim.x) {
    reinterpret_cast<uint32_t*>(win + N_WIN * ROW)[i] = 0;
    reinterpret_cast<uint32_t*>(win + (N_WIN + 1) * ROW)[i] =
        F32 ? 0x3f800000u : 0x3f803f80u;  // 1.0 in each element
    if constexpr (F32) {
      reinterpret_cast<uint32_t*>(win + L::WIN_PLANE + N_WIN * ROW)[i] = 0;
      reinterpret_cast<uint32_t*>(win + L::WIN_PLANE +
                                  (N_WIN + 1) * ROW)[i] = 0;
    }
  }
  const uint32_t win_s = tc::smem_addr(win);
  // this lane's A rows.  bf16: matrix j = lane >> 3 of m16 tile i is (unit
  // 2 mt + (j & 1), positions 8 (j >> 1) .. + 7 of the k-step's row); the
  // window column of a tap does not depend on the chunk's origin, so the
  // address is fixed per lane, and chunk row r adds r window rows
  // (a_step).  float32: a_base[i][h] is channel lane / 4 of unit 2 mt + h
  // at position lane % 4 of the chunk's row 0 (its small part WIN_PLANE
  // further); positions + 4 step QSTEP bytes and rows RSTEP, a_step[i][h]
  // masks both (0 at the zero row or the row of ones, which stand for
  // every position).
  constexpr int MAP = L::MAP;
  constexpr uint32_t RSTEP = SW * ROW;
  constexpr uint32_t QSTEP =
      (MAP == tc::M_DOUBLE ? 8 : MAP == tc::M_HALF_T ? 2 : 4) * ROW;
  constexpr int NH = F32 ? 2 : 1;
  uint32_t a_base[WM][NH], a_step[WM][NH];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int kk = F32 ? (lane & 3) : (lane >> 4) * 8 + (lane & 7);
      const int u =
          u0 + 2 * (wm * WM + i) + (F32 ? h : ((lane >> 3) & 1));
      const uint32_t ch = F32 ? 4 * (lane >> 2) : 0;
      a_base[i][h] = win_s + N_WIN * ROW + ch;  // the zero row
      a_step[i][h] = 0;
      if (u < ones_unit) {
        const int gr = u / 9;
        const int tap = u - 9 * gr;
        const int kt = tap / 3;
        const int col = G::col(kk, tap - 3 * kt, G::lo(0));
        if (col >= 0) {
          a_base[i][h] = win_s + ((1 + G::TS * (kt - 1)) * SW + col) * ROW +
                         (gr - g_lo) * 8 * sizeof(E) + ch;
          a_step[i][h] = F32 ? 0xffffffffu : RSTEP;
        }
      } else if (u == ones_unit) {
        a_base[i][h] += ROW;  // the row of ones
      }
    }
  // B: matrix j of an x4 is (n8 tile + (j >> 1), k half j & 1: 8 bf16 or 4
  // float32 positions); an x2 reads matrices 0 and 1
  const int jb = lane >> 3;
  const uint32_t b_lane =
      tc::smem_addr(gs) +
      ((wn * WN + (WN == 1 ? 0 : (jb >> 1))) * 8 + (lane & 7)) * GROW +
      (jb & 1) * 16;

  // the staging of a chunk: the window holds the forward's normalized
  // input, (x - mean) * scale (bf16: rounded as it was there; float32:
  // split into its TF32 big and small planes), with the block's
  // coefficients of the chunk's batch element (scale 0 past C) and zero
  // outside the plane; g [n][position] (float32: split too)
  __shared__ float co_s[WG_GROUPS * 8], co_m[WG_GROUPS * 8];
  auto stage = [&](int k) {
    const int b = k / per_b;
    const int rem = k - b * per_b;
    const int t0 = (rem / ntc) * WG_TH;
    const int f0 = (rem % ntc) * WG_TW;
    const int lo = G::lo(f0);
    if constexpr (F32) {
      // a window item is 4 channels (one 16-byte group) of one position
#pragma unroll 2
      for (int i = threadIdx.x; i < N_WIN * 2 * groups; i += 256) {
        const int q4 = i / N_WIN;
        const int pos = i - q4 * N_WIN;
        const int wr = pos / SW;
        const int ts = t0 - 1 + wr;
        const int fs = lo + pos - wr * SW;
        const int c0 = 8 * g_lo + 4 * q4;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (ts >= 0 && ts < T && fs >= 0 && fs < Fin) {
          const int p = ts * Fin + fs;
          if (c0 + 4 <= C && (c0 + 4 <= src.c0 || c0 >= src.c0)) {
            // 4 channels of one source: consecutive planes
            const float* xp = src.ptr(c0) + src.plane(b, c0) * TFi + p;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = (__ldg(xp + (size_t)e * TFi) - co_m[4 * q4 + e]) *
                     co_s[4 * q4 + e];
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = c0 + e;
              if (c < C)
                v[e] = (__ldg(src.ptr(c) + src.plane(b, c) * TFi + p) -
                        co_m[4 * q4 + e]) *
                       co_s[4 * q4 + e];
            }
          }
        }
        const uint32_t q[4] = {__float_as_uint(v[0]), __float_as_uint(v[1]),
                               __float_as_uint(v[2]), __float_as_uint(v[3])};
        uint32_t hi[4], lo[4];
        tc::split_tf32(q, hi, lo);
        unsigned char* dst = win + pos * ROW + q4 * tc::GROUP_BYTES;
        *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2],
                                                    hi[3]);
        *reinterpret_cast<uint4*>(dst + L::WIN_PLANE) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      // g: consecutive threads consecutive positions of a chunk row
      for (int i = threadIdx.x; i < BN * WG_TH * WG_TW; i += 256) {
        const int n = i / (WG_TH * WG_TW);
        const int rem = i - n * (WG_TH * WG_TW);
        const int r = rem / WG_TW;
        const int t = t0 + r;
        const int f = f0 + rem - r * WG_TW;
        uint32_t v[1] = {0}, hi[1], lo[1];
        if (n0 + n < N && t < T && f < Fo)
          v[0] = __float_as_uint(
              __ldg(reinterpret_cast<const float*>(g) +
                    ((size_t)b * N + n0 + n) * TFo + (size_t)t * Fo + f));
        tc::split_tf32(v, hi, lo);
        reinterpret_cast<uint32_t*>(gs + n * GROW)[rem] = hi[0];
        reinterpret_cast<uint32_t*>(gs + L::GS_PLANE + n * GROW)[rem] = lo[0];
      }
    } else {
      // a window item is 8 channels of one window position, loaded raw
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
            const unsigned short* xp =
                reinterpret_cast<const unsigned short*>(
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
        *reinterpret_cast<uint4*>(win + pos * ROW + gr * tc::GROUP_BYTES) =
            make_uint4(q[0], q[1], q[2], q[3]);
      }
      // g: a thread takes one (n, tile row) run of WG_TW positions; inside
      // the row it reads aligned 32-bit words (one more, funnel-shifted,
      // for a run at an odd element) where g's base allows, at the plane's
      // edge 2-byte values
      const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
      const bool words = (reinterpret_cast<uintptr_t>(g) & 3) == 0;
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
        uint4* dst =
            reinterpret_cast<uint4*>(gs + n * GROW + r * WG_TW * 2);
#pragma unroll
        for (int k = 0; k < WG_TW / 8; ++k)
          dst[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                              v[4 * k + 3]);
      }
    }
  };

  // the split's sums (float32 adds each chunk's own sums, acc, to them)
  float tot[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;

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
    // float32 sums the chunk in fresh accumulators, added to tot after it
    // (see tc::gather_mma); bf16 into tot
    float acc[WM][WN][4];
    float(&d)[WM][WN][4] = F32 ? acc : tot;
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    // a chunk row is one k-step of 16 positions in bf16, two of 8 in
    // float32
#pragma unroll(F32 ? 1 : WG_TH)
    for (int r = 0; r < WG_TH; ++r)
#pragma unroll
      for (int kk = 0; kk < (F32 ? 2 : 1); ++kk) {
        uint32_t a[WM][4], as[WM][4];
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          if constexpr (F32) {
            // a0 / a1: units 2 mt / 2 mt + 1 at positions q = 2 kk of the
            // row; a2 / a3 the same at q + 1
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t ad =
                  a_base[i][e & 1] +
                  (a_step[i][e & 1] &
                   (r * RSTEP + (2 * kk + (e >> 1)) * QSTEP));
              a[i][e] = lds32(ad);
              as[i][e] = lds32(ad + L::WIN_PLANE);
            }
          } else {
            tc::ldsm_x4_trans(a_base[i][0] + r * a_step[i][0], a[i]);
          }
        }
#pragma unroll
        for (int jp = 0; jp < (WN + 1) / 2; ++jp) {
          uint32_t bf[4], bs[4] = {};
          const uint32_t ba = b_lane + jp * 16 * GROW +
                              (r * WG_TW + kk * 8) * (int)sizeof(E);
          if (WN == 1) {
            tc::ldsm_x2(ba, bf[0], bf[1]);
            if constexpr (F32) tc::ldsm_x2(ba + L::GS_PLANE, bs[0], bs[1]);
          } else {
            tc::ldsm_x4(ba, bf);
            if constexpr (F32) tc::ldsm_x4(ba + L::GS_PLANE, bs);
          }
#pragma unroll
          for (int i = 0; i < WM; ++i) {
            tc::mma_step<E>(d[i][2 * jp], a[i], as[i], bf[0], bf[1], bs[0],
                            bs[1]);
            if (WN > 1)
              tc::mma_step<E>(d[i][2 * jp + 1], a[i], as[i], bf[2], bf[3],
                              bs[2], bs[3]);
          }
        }
      }
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[i][j][e] += acc[i][j][e];
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
          if (n < N) part[(base + n) * CJ + col] = tot[i][j][2 * h + e];
        }
    }
}

template <int MODE, class Tile, typename E>
cudaError_t launch_wgrad_tc(const E* g, int N, Sources<E> src,
                            const float* scale, const float* mean,
                            float* wpart, int B, int T, int Fin, int Fo,
                            cudaStream_t st) {
  constexpr int BYTES = WgradSmem<MODE, Tile, E>::BYTES;
  auto kernel =
      wgrad_tc_kernel<MODE, Tile::WM_, Tile::WN_, Tile::WARPS_N_, E>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return e;
  const int units = 9 * ((src.C + 7) / 8) + 1;
  const int cps = wgrad_tc_chunks_per_split<E>(N, src.C, B, T, Fo);
  const dim3 grid((units + Tile::UB - 1) / Tile::UB,
                  (N + Tile::BN - 1) / Tile::BN,
                  wgrad_tc_splits<E>(N, src.C, B, T, Fo));
  kernel<<<grid, 256, BYTES, st>>>(g, N, src, scale, mean, wpart, B, T, Fin,
                                   Fo, cps);
  return cudaGetLastError();
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

template <int MODE, typename E>
cudaError_t launch_bwd_tc(const E* g, int N, Sources<E> src,
                          const float* scale, const float* mean, const E* w,
                          E* dx0, E* dx1, float* dpart, float* sg,
                          float* sgx, float* wpart, float* dw, float* dbias,
                          int B, int T, int Fin, int Fo, cudaStream_t st) {
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
  e = with_wgrad_tile<E>(N, [&](auto tile) {
    return launch_wgrad_tc<MODE, decltype(tile)>(g, N, src, scale, mean,
                                                 wpart, B, T, Fin, Fo, st);
  });
  if (e != cudaSuccess) return e;
  constexpr int kThreads = 256;
  wgrad_reduce_kernel<kTransposeMode<MODE>>
      <<<(N * wgrad_cols(C) + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          wpart, wgrad_tc_splits<E>(N, C, B, T, Fo), N, C, dw, dbias);
  return cudaGetLastError();
}

// Dispatch on the mode for storage type E (see the C entry points below).
template <typename E>
int stencil_bwd(int mode, const E* g, int N, const E* x0, int c0,
                const E* x1, int c1, const float* scale, const float* mean,
                const E* w, E* dx0, E* dx1, float* dpart, float* sg,
                float* sgx, float* wpart, float* dw, float* dbias, int B,
                int T, int Fin, int Fo, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sources<E> src{x0, x1 ? x1 : x0, c0, c0 + c1};
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
//   w packed by ops/kernels/tc_pack.py with output channel c and reduced
//   channel n, float32 [2, ceil(N/4), 9, C, 4] (TF32 big and small
//   planes) or bfloat16 [ceil(N/8), 9, C, 8], read only by the dgrad;
//   dx0, dx1 like x0, x1, or dx0 = NULL to skip the dgrad (then dpart, sg
//   and sgx are unused);
//   dpart [2, B, C, ntiles] scratch, ntiles = misonet_tc_pos_tiles(T, Fin),
//   and sg, sgx [B, C] (sum G, sum G (x - mean)), or dpart = NULL to skip
//   those sums;
//   wpart [splits, N, 9C + 1] scratch, splits from
//   misonet_stencil_bwd_splits (float32) or misonet_stencil_bwd_bf16_splits
//   (bfloat16);
//   dw of the weight's shape ([N, C, 3, 3] for modes 0, 1, 4, [C, N, 3, 3]
//   for modes 2, 3; float32), dbias [N].
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
  return misonet::stencil_bwd(mode, g, N, x0, c0, x1, c1, scale, mean, w,
                              dx0, dx1, dpart, sg, sgx, wpart, dw, dbias, B,
                              T, Fin, Fo, stream);
}

// Splits of the wgrad's position range for a call: the leading axis of its
// `wpart` scratch.  The B * T * Fo output positions go in chunks of 4 x 16
// positions of one batch element; float32 and bfloat16 tile the rows
// differently, so each mode has its own count.
extern "C" int misonet_stencil_bwd_splits(int N, int C, int B, int T,
                                          int Fo) {
  return misonet::wgrad_tc_splits<float>(N, C, B, T, Fo);
}

extern "C" int misonet_stencil_bwd_bf16_splits(int N, int C, int B, int T,
                                               int Fo) {
  return misonet::wgrad_tc_splits<__nv_bfloat16>(N, C, B, T, Fo);
}
