// dense_stack: one input-grouped ("stacked") DenseBlock call on Hopper.
//
// Replaces misonet_tpu/ops/pallas/dense_stack.py::dense_stack_flat (its
// Pallas `_kernel`) in its float32 ("precise") and bfloat16 (precise=False,
// the JAX package's default) modes; the int8 decode mode is
// dense_stack_int8.cu.  For the newly available source tensor(s) x_s (1 or
// 2 raw tensors [B, c_i, T, F]; the decoder's skip concat stays logical) it
// computes
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
// Modes: float32 throughout, or bfloat16 storage with the TPU kernel's
// rounding points: sources, weights, acc_in/acc_out and y are bfloat16;
// the normalized input is rounded to bfloat16 (the TPU kernel's bf16
// patch); sums and the epilogue run in float32; the statistics come from
// the float32 y before it is rounded for the store.
//
// float32 mode (dense_stack_kernel): CUDA-core FMAs.  Bound on the H100:
// float32 FMA throughput (N = 24..192 channels and K = 9 * (24..64) per
// call), so the inner loop is kept to FMAs: per block, each chunk of CK
// source channels is staged in shared memory already normalized, as the
// flat run of input rows the tile's outputs read (tile rows plus one above
// and below, zeros outside the plane), so a tap is one shared load at an
// immediate offset, masked only at the row's first and last column.  A
// thread holds 16 channels x 2 positions and reads its 16 weights per tap
// as four float4 broadcasts.  What limits it is latency hiding, not
// instruction count: a tile sweep on the H100 (PERF.md) found 256 threads
// capped at 64 registers, so 4 blocks (32 warps) share an SM, 1.4x faster
// than larger register tiles at fewer warps.
//
// bfloat16 mode (dense_stack_tc_kernel): tensor cores, `mma.sync
// m16n8k16` bf16 x bf16 -> float32 (conv_mma.cuh).  An implicit GEMM:
// rows are a 2-D tile of 128 output positions (8 x 16, or 16 x 8 for
// planes of 8 bins or fewer), columns BN = 16..96 output channels (the
// fewest blocks for N, tc::pick_nt8), the reduction runs over units of 8
// source channels at one tap.  Per chunk of up to 32 channels of one
// source, the block stages the tile's window (rows t0-1 .. t0+TH, columns
// f0-1 .. f0+TW) channels-last in shared memory, normalized and rounded
// as it loads, and starts cp.async copies of the chunk's weights, packed
// by the wrapper (ops/kernels/tc_pack.py) as [group][tap][n][8 channels]
// so a (unit, channel) row is one 16-byte copy.  Each warp then runs its
// 16 positions x BN channels: per k-step (two units) one ldmatrix.x4 of A
// at the lanes' window rows for the unit's tap (the zero halo of the
// window supplies the SAME padding) and one ldmatrix.x4 of B per 16
// channels.  Epilogue through shared memory (tc::stage_acc,
// tc::finish_tile), a warp per output channel with the positions along
// its lanes, so acc_in, y and acc_out move coalesced: bias, ELU, the bf16
// stores and the per-tile statistics partials in a fixed order.  Bound on
// the H100: its bytes (0.21 ms over phase 11's cases, the partials
// dominate them); what limits it is the staging of the window and the
// epilogue's traffic, not the mmas, at 1.6x cuDNN's bf16 conv (PERF.md).  The partial accumulator has to leave
// the kernel between calls (layer s+1 needs layer s's global InstanceNorm
// statistics), so acc_in/acc_out round-trip device memory.  Statistics:
// two passes, see conv_common.cuh.
//
// dense_layer (misonet_dense_layer*): the same kernel as one whole
// DenseBlock layer, replacing misonet_tpu/ops/pallas/dense_flat.py::
// dense_layer_flat: acc_in = NULL, n_fin = N, up to MAX_SOURCES raw sources
// (a DenseBlock's fifth layer reads the block input and four earlier
// outputs; the concat stays logical, each staged channel chunk is read
// from its own source), and two switches: fuse_elu = 0 stores z + bias
// (and takes the statistics of that pre-ELU value), want_stats = 0 skips
// the statistics passes and writes no sums.  Bound as dense_stack; in
// float32 a layer's N = 24 fills 24 of a block's 32 channel slots, in
// bf16 24 of a 32-wide tensor-core tile.

#include "conv_common.cuh"
#include "conv_mma.cuh"

namespace misonet {
namespace {

constexpr int PT = 2;                  // output positions per thread
constexpr int LANES = POS_TILE / PT;   // position lanes per channel half
constexpr int THREADS = 2 * LANES;     // two 16-channel halves
constexpr int CK = 8;                  // source channels staged per round
constexpr int MIN_BLOCKS = 4;          // per SM: caps registers at 64
constexpr int MAX_SOURCES = 8;         // raw sources of one call

// The raw sources of a call, passed by value: source s is x[s], c[s]
// channels [B, c[s], T, F]; their channel concatenation is the conv input.
template <typename T>
struct Sources {
  const T* x[MAX_SOURCES];
  int c[MAX_SOURCES];
  int n;
};

// Floats staged per source channel: the rows a tile of POS_TILE flattened
// positions spans, plus one row above and one below.
inline int stage_floats(int F) { return ((POS_TILE - 1) / F + 4) * F; }

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_stack_kernel(const Sources<T> src, int C,
                   const float* __restrict__ scale,
                   const float* __restrict__ mean,
                   const T* __restrict__ w,
                   const float* __restrict__ bias,
                   const T* __restrict__ acc_in,
                   T* __restrict__ y,
                   T* __restrict__ acc_out,
                   float* __restrict__ part,
                   int Tn, int F, int N, int n_fin, int xs_ch,
                   bool fuse_elu, bool want_stats) {
  extern __shared__ __align__(16) float smem[];
  float (*ws)[9][WS_ROW] = reinterpret_cast<float (*)[9][WS_ROW]>(smem);
  float* xs = smem + CK * 9 * WS_ROW;  // CK staged channels of xs_ch floats
  const int half = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int TF = Tn * F;

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

  int coff = 0;  // first channel of source s in the concatenation
  for (int s = 0; s < src.n; coff += src.c[s], ++s) {
    const T* xsrc = src.x[s];
    const int cs = src.c[s];
    for (int cb = 0; cb < cs; cb += CK) {
      const int ck = min(CK, cs - cb);
      __syncthreads();  // the previous chunk is consumed
      stage_weights<CK, THREADS>(ws, w, N, C, n0, coff + cb, ck);
      for (int k = 0; k < ck; ++k) {
        const float sc = scale[b * C + coff + cb + k];
        const float mu = mean[b * C + coff + cb + k];
        const T* xp = xsrc + ((size_t)b * cs + cb + k) * TF;
        float* dst = xs + k * xs_ch;
        for (int i = threadIdx.x; i < n_stage; i += THREADS) {
          const int gi = g0 + i;
          dst[i] = (gi >= 0 && gi < TF)
                       ? round_as<T>((ldg_f32(xp + gi) - mu) * sc)
                       : 0.f;
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
      if (acc_in) z += ldg_f32(acc_in + ((size_t)b * N + n) * TF + pos[j]);
      if (n < n_fin) {
        const float v = fuse_elu ? elu(z + bias[n]) : z + bias[n];
        store(y + ((size_t)b * n_fin + n) * TF + pos[j], v);
        su[i] += v;
        sq[i] += v * v;
      } else {
        store(acc_out + ((size_t)b * (N - n_fin) + (n - n_fin)) * TF + pos[j],
              z);
      }
    }
  }
  if (want_stats && n0 < n_fin)  // block-uniform
    block_stats<THREADS>(su, sq, part, b, B, n0, n_fin, tile, gridDim.x);
}

// Launch both passes of the float32 mode (see the C entry points below);
// without want_stats only the conv pass.
int launch_dense_stack(const Sources<float>& src, const float* scale,
                       const float* mean, const float* w, const float* bias,
                       const float* acc_in, float* y, float* acc_out,
                       float* part, float* sums, float* sqs, int B, int Tn,
                       int F, int N, int n_fin, bool fuse_elu,
                       bool want_stats, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (Tn * F + POS_TILE - 1) / POS_TILE;
  const dim3 grid(ntiles, (N + NB - 1) / NB, B);
  const int xs_ch = stage_floats(F);
  int C = 0;
  for (int s = 0; s < src.n; ++s) C += src.c[s];
  // weights, staged channels, and slack after the last channel: the masked
  // edge taps of a tile's first and last position read one float outside
  // their channel's run (into the weights before it or this slack)
  const size_t smem = (CK * 9 * WS_ROW + CK * xs_ch + 4) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dense_stack_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dense_stack_kernel<float><<<grid, THREADS, smem, st>>>(
      src, C, scale, mean, w, bias, acc_in, y, acc_out, part, Tn, F, N,
      n_fin, xs_ch, fuse_elu, want_stats);
  e = cudaGetLastError();
  if (e != cudaSuccess || !want_stats) return (int)e;
  return (int)launch_reduce_stats(part, sums, sqs, B * n_fin, ntiles, st);
}

// ---- the bfloat16 mode on tensor cores --------------------------------------

using bf16 = __nv_bfloat16;

// One block: a tile of tc::GM_POS output positions (tile_h rows x tile_w
// columns of the plane) x BN = 8 NT8 output channels of one batch
// element; see the note at the top of the file.
template <int NT8>
__global__ void __launch_bounds__(tc::GM_THREADS, tc::gm_min_blocks(NT8))
dense_stack_tc_kernel(const Sources<bf16> src, int C,
                      const float* __restrict__ scale,
                      const float* __restrict__ mean,
                      const bf16* __restrict__ w,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ acc_in, bf16* __restrict__ y,
                      bf16* __restrict__ acc_out, float* __restrict__ part,
                      int Tn, int F, int N, int n_fin, bool fuse_elu,
                      bool want_stats) {
  constexpr int BN = 8 * NT8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tw = tc::tile_w(F);
  const int ntc = (F + tw - 1) / tw;
  const int tile = blockIdx.x;
  const int t0 = (tile / ntc) * (tc::GM_POS / tw);
  const int f0 = (tile % ntc) * tw;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int TF = Tn * F;
  float acc[NT8][4] = {};

  int coff = 0;  // first channel of source s in the concatenation
  int goff = 0;  // its first group in the packed weights
  for (int s = 0; s < src.n; coff += src.c[s], goff += (src.c[s] + 7) / 8,
                             ++s) {
    const bf16* xsrc = src.x[s];
    const int cs = src.c[s];
    for (int cb = 0; cb < cs; cb += 8 * tc::GMAX) {
      const int rk = min(8 * tc::GMAX, cs - cb);
      const int c_first = coff + cb;
      const bf16* xp = xsrc + ((size_t)b * cs + cb) * TF;
      tc::gather_chunk<tc::Geo<tc::M_SAME>, NT8, bf16>(
          acc, tc_smem, tw, t0, f0, w, N, o0, goff + cb / 8, (rk + 7) / 8,
          rk, Tn, F, [&](int k, int p) {
            const int ch = b * C + c_first + k;
            return (tc::bf16_at(xp + (size_t)k * TF + p) - __ldg(mean + ch)) *
                   __ldg(scale + ch);
          });
    }
  }

  // epilogue: finalize rows < n_fin, pass the rest on as partials
  tc::finish_gather<NT8>(
      tc_smem, acc, tw, want_stats && o0 < n_fin, n_fin - o0, part,
      (size_t)b * n_fin + o0, (size_t)gridDim.z * n_fin, tile, gridDim.x,
      [&](int o, int pr, int pc, float z) {
        const int n = o0 + o;
        const int t = t0 + pr;
        const int f = f0 + pc;
        if (n >= N || t >= Tn || f >= F) return make_float2(0.f, 0.f);
        const int p = t * F + f;
        if (acc_in) z += tc::bf16_at(acc_in + ((size_t)b * N + n) * TF + p);
        if (n >= n_fin) {
          store(acc_out + ((size_t)b * (N - n_fin) + (n - n_fin)) * TF + p,
                z);
          return make_float2(0.f, 0.f);
        }
        const float v = fuse_elu ? elu(z + bias[n]) : z + bias[n];
        store(y + ((size_t)b * n_fin + n) * TF + p, v);
        return make_float2(v, v * v);
      });
}

template <int NT8>
cudaError_t launch_dense_tc(const Sources<bf16>& src, int C,
                            const float* scale, const float* mean,
                            const bf16* w, const float* bias,
                            const bf16* acc_in, bf16* y, bf16* acc_out,
                            float* part, int B, int Tn, int F, int N,
                            int n_fin, bool fuse_elu, bool want_stats,
                            cudaStream_t st) {
  constexpr int BN = 8 * NT8;
  const size_t smem =
      tc::gather_smem<tc::Geo<tc::M_SAME>>(BN, tc::tile_w(F));
  cudaError_t e = cudaFuncSetAttribute(
      dense_stack_tc_kernel<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tc::pos_tiles(Tn, F), (N + BN - 1) / BN, B);
  dense_stack_tc_kernel<NT8><<<grid, tc::GM_THREADS, smem, st>>>(
      src, C, scale, mean, w, bias, acc_in, y, acc_out, part, Tn, F, N,
      n_fin, fuse_elu, want_stats);
  return cudaGetLastError();
}

// Both passes of the bfloat16 mode: the tensor-core conv pass, then (with
// want_stats) the statistics' fixed-order pass over its pos_tiles partials.
int launch_dense_stack(const Sources<bf16>& src, const float* scale,
                       const float* mean, const bf16* w, const float* bias,
                       const bf16* acc_in, bf16* y, bf16* acc_out,
                       float* part, float* sums, float* sqs, int B, int Tn,
                       int F, int N, int n_fin, bool fuse_elu,
                       bool want_stats, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int C = 0;
  for (int s = 0; s < src.n; ++s) C += src.c[s];
  cudaError_t e;
  switch (tc::pick_nt8(N)) {
#define MISONET_DENSE_TC(NT8)                                                \
  case NT8:                                                                  \
    e = launch_dense_tc<NT8>(src, C, scale, mean, w, bias, acc_in, y,        \
                             acc_out, part, B, Tn, F, N, n_fin, fuse_elu,    \
                             want_stats, st);                                \
    break;
    MISONET_DENSE_TC(2)
    MISONET_DENSE_TC(4)
    MISONET_DENSE_TC(6)
    MISONET_DENSE_TC(8)
    MISONET_DENSE_TC(12)
#undef MISONET_DENSE_TC
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || !want_stats) return (int)e;
  return (int)launch_reduce_stats(part, sums, sqs, B * n_fin,
                                  tc::pos_tiles(Tn, F), st);
}

template <typename T>
Sources<T> two_sources(const T* x0, int c0, const T* x1, int c1) {
  Sources<T> src{};
  src.x[0] = x0;
  src.c[0] = c0;
  src.x[1] = x1;
  src.c[1] = c1;
  src.n = x1 ? 2 : 1;
  return src;
}

// Returns cudaErrorInvalidValue for a source count outside [1, MAX_SOURCES].
template <typename T>
int launch_dense_layer(const T* const* xs, const int* widths, int n_src,
                       const float* scale, const float* mean, const T* w,
                       const float* bias, T* y, float* part, float* sums,
                       float* sqs, int B, int Tn, int F, int N, int fuse_elu,
                       int want_stats, void* stream) {
  if (n_src < 1 || n_src > MAX_SOURCES) return (int)cudaErrorInvalidValue;
  Sources<T> src{};
  for (int s = 0; s < n_src; ++s) {
    src.x[s] = xs[s];
    src.c[s] = widths[s];
  }
  src.n = n_src;
  return launch_dense_stack(src, scale, mean, w, bias, (const T*)nullptr, y,
                            (T*)nullptr, part, sums, sqs, B, Tn, F, N, N,
                            fuse_elu != 0, want_stats != 0, stream);
}

}  // namespace
}  // namespace misonet

// C entry points.  All tensors contiguous, on the current device; x0, x1,
// w, acc_in, y and acc_out float32 (misonet_dense_stack) or bfloat16
// (misonet_dense_stack_bf16), scale, mean, bias, part, sums and sqs float32:
//   x0 [B, c0, T, F], x1 [B, c1, T, F] or NULL (c1 = 0),
//   scale, mean [B, c0 + c1], bias [n_fin],
//   w [N, c0 + c1, 3, 3] (float32), or bfloat16 packed by
//   ops/kernels/tc_pack.py for sources of widths (c0, c1):
//   [ceil(c0/8) + ceil(c1/8), 9, N, 8],
//   acc_in [B, N, T, F] or NULL, y [B, n_fin, T, F],
//   acc_out [B, N - n_fin, T, F] or NULL when N == n_fin,
//   part [2, B, n_fin, ntiles] scratch with ntiles = ceil(T*F / 256)
//   (float32) or misonet_tc_pos_tiles(T, F) (bfloat16),
//   sums, sqs [B, n_fin].
// Return cudaGetLastError() after the launches (0 on success).
extern "C" int misonet_dense_stack(const float* x0, int c0, const float* x1,
                                   int c1, const float* scale,
                                   const float* mean, const float* w,
                                   const float* bias, const float* acc_in,
                                   float* y, float* acc_out, float* part,
                                   float* sums, float* sqs, int B, int T,
                                   int F, int N, int n_fin, void* stream) {
  return misonet::launch_dense_stack(misonet::two_sources(x0, c0, x1, c1),
                                     scale, mean, w, bias, acc_in, y,
                                     acc_out, part, sums, sqs, B, T, F, N,
                                     n_fin, true, true, stream);
}

extern "C" int misonet_dense_stack_bf16(
    const __nv_bfloat16* x0, int c0, const __nv_bfloat16* x1, int c1,
    const float* scale, const float* mean, const __nv_bfloat16* w,
    const float* bias, const __nv_bfloat16* acc_in, __nv_bfloat16* y,
    __nv_bfloat16* acc_out, float* part, float* sums, float* sqs, int B,
    int T, int F, int N, int n_fin, void* stream) {
  return misonet::launch_dense_stack(misonet::two_sources(x0, c0, x1, c1),
                                     scale, mean, w, bias, acc_in, y,
                                     acc_out, part, sums, sqs, B, T, F, N,
                                     n_fin, true, true, stream);
}

// dense_layer: one whole DenseBlock layer over n_src (1..8) raw sources.
// xs[s] [B, widths[s], T, F] and w [N, sum(widths), 3, 3] float32
// (misonet_dense_layer) or bfloat16 (misonet_dense_layer_bf16, w packed
// as in misonet_dense_stack_bf16 for the widths), y [B, N, T, F] of the
// same type; scale, mean [B, sum(widths)], bias [N] float32.  With
// want_stats: part [2, B, N, ntiles] scratch (ntiles as in dense_stack)
// and sums, sqs [B, N] float32; without it the three may be NULL.
// fuse_elu = 0 skips the ELU.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int misonet_dense_layer(const float* const* xs, const int* widths,
                                   int n_src, const float* scale,
                                   const float* mean, const float* w,
                                   const float* bias, float* y, float* part,
                                   float* sums, float* sqs, int B, int T,
                                   int F, int N, int fuse_elu,
                                   int want_stats, void* stream) {
  return misonet::launch_dense_layer(xs, widths, n_src, scale, mean, w, bias,
                                     y, part, sums, sqs, B, T, F, N,
                                     fuse_elu, want_stats, stream);
}

extern "C" int misonet_dense_layer_bf16(
    const __nv_bfloat16* const* xs, const int* widths, int n_src,
    const float* scale, const float* mean, const __nv_bfloat16* w,
    const float* bias, __nv_bfloat16* y, float* part, float* sums,
    float* sqs, int B, int T, int F, int N, int fuse_elu, int want_stats,
    void* stream) {
  return misonet::launch_dense_layer(xs, widths, n_src, scale, mean, w, bias,
                                     y, part, sums, sqs, B, T, F, N,
                                     fuse_elu, want_stats, stream);
}

// The tiling constant the wrapper needs to size the partials scratch of
// the float32 modes.
extern "C" int misonet_pos_tile() { return misonet::POS_TILE; }

// The position tiles (statistics partials per (batch, channel)) of the
// bfloat16 tensor-core kernels over a T x F plane: dense_stack's and
// dense_layer's output plane, stencil_bwd's input plane.
extern "C" int misonet_tc_pos_tiles(int T, int F) {
  return misonet::tc::pos_tiles(T, F);
}
