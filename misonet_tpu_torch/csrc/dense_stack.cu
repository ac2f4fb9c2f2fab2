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
// Both modes run one kernel, dense_stack_tc_kernel<E, NT8, MT>, on the
// tensor cores: an implicit GEMM (conv_mma.cuh) whose rows are a 2-D tile
// of MT x 128 output positions (8 x 16 per 128, or 16 x 8 for planes of 8
// bins or fewer), whose columns are BN = 8..96 output channels (the
// fewest blocks for N, tc::pick_nt8), and whose reduction runs over units
// of one 16-byte group of source channels at one tap.  Per chunk of up to
// 4 groups of one source, the block stages the tile's window (rows t0-1 ..
// t0+TH, columns f0-1 .. f0+TW) channels-last in shared memory, normalized
// as it loads, and starts cp.async copies of the chunk's weights, packed
// by the wrapper (ops/kernels/tc_pack.py) as [group][tap][n][16 bytes] so
// a (unit, channel) row is one 16-byte copy; each source pads to its own
// groups.  Each warp then runs its MT x 16 positions x BN channels: per
// k-step (two units) one ldmatrix.x4 of A per fragment at the lanes'
// window rows for the unit's tap (the zero halo of the window supplies
// the SAME padding) and one ldmatrix.x4 of B per 16 channels.  Epilogue
// through shared memory (tc::finish_gather), a warp per output channel
// with the positions along its lanes, so acc_in, y and acc_out move
// coalesced: bias, ELU, the stores and the per-tile statistics partials
// in a fixed order.  The partial accumulator has to leave the kernel
// between calls (layer s+1 needs layer s's global InstanceNorm
// statistics), so acc_in/acc_out round-trip device memory.  Statistics:
// two passes, see conv_common.cuh.
//
//   float32 ("precise"): 4 channels a group (16 a chunk), the window
//   staged unrounded; each product three `mma.sync m16n8k8` TF32 passes
//   over split operands (conv_mma.cuh: big big + big small + small big,
//   float32 sums, each chunk in fresh accumulators), the window split in
//   registers after its ldmatrix, the weights packed split (two planes
//   [2, G4, 9, N, 4], by tc_pack.cu's pack_tf32_kernel once per weight
//   version).  Bound on the H100: its operations at a third of the TF32
//   rate (0.76 ms over chip_smoke.py phase 3's cases; 1.85 at the 67
//   TFLOP/s of the CUDA-core FMA loop this mode replaced).  What holds it
//   back: a block stages a chunk (the window's loads, and the weight
//   planes' copies, 4x the bf16 bytes per channel) and then runs its mmas,
//   one after the other, overlapped only with the other block of its SM;
//   and two blocks an SM leave a thread 128 registers for a chunk's sums,
//   its fresh partials and the split operands.  The design: MT = 2
//   fragments a warp (256 positions a block), so each B fragment read from
//   shared memory serves two A fragments and each staged weight byte twice
//   the positions; BN <= 48 (NT8 <= 6, where a few registers spill), the
//   widest tile those registers hold; and acc_in starts the accumulators,
//   a thread's loads all issued before the first chunk (added in the
//   epilogue, each position's load was a round trip the store after it
//   waited on).  The tile is kF32Mt / kF32MaxNt8 below, from a sweep of
//   MT 1-2 and NT8 caps 4-12 on the H100 (PERF.md).
//   bfloat16: 8 channels a group (32 a chunk), one fragment a warp,
//   normalized and rounded on load to bf16((x - mean) * scale), the TPU
//   kernel's bf16 patch; `mma.sync m16n8k16` bf16 x bf16 -> float32.
//   Bound on the H100: its bytes (0.21 ms over phase 11's cases, the
//   partials dominate them); what limits it is the staging of the window
//   and the epilogue's traffic, not the mmas, at 1.6x cuDNN's bf16 conv
//   (PERF.md).

// dense_layer (misonet_dense_layer*): the same kernel as one whole
// DenseBlock layer, replacing misonet_tpu/ops/pallas/dense_flat.py::
// dense_layer_flat: acc_in = NULL, n_fin = N, up to MAX_SOURCES raw sources
// (a DenseBlock's fifth layer reads the block input and four earlier
// outputs; the concat stays logical, each staged channel chunk is read
// from its own source), and two switches: fuse_elu = 0 stores z + bias
// (and takes the statistics of that pre-ELU value), want_stats = 0 skips
// the statistics passes and writes no sums.  Bound as dense_stack; a
// layer's N = 24 is three n8 tiles in float32, 24 of a 32-wide tile in
// bf16.

#include "conv_common.cuh"
#include "conv_mma.cuh"
#include "smem_limit.cuh"

namespace misonet {
namespace {

constexpr int MAX_SOURCES = 8;  // raw sources of one call

// The float32 tile: m16 fragments a warp, and the widest NT8 (BN = 8 NT8
// output channels a block); see the note above.
constexpr int kF32Mt = 2, kF32MaxNt8 = 6;

// m16 fragments a warp of the storage type's kernel.
template <typename E>
constexpr int kMt = tc::kTf32<E> ? kF32Mt : 1;

// The raw sources of a call, passed by value: source s is x[s], c[s]
// channels [B, c[s], T, F]; their channel concatenation is the conv input.
template <typename T>
struct Sources {
  const T* x[MAX_SOURCES];
  int c[MAX_SOURCES];
  int n;
};

// One block: a tile of MT * tc::GM_POS output positions (tile_h rows x
// tile_w columns of the plane) x BN = 8 NT8 output channels of one batch
// element, in storage type E (float: the weights' small plane `plane`
// 16-byte units after the big one); see the note at the top of the file.
template <typename E, int NT8, int MT>
__global__ void __launch_bounds__(tc::GM_THREADS, tc::gm_min_blocks<E>(NT8, MT))
dense_stack_tc_kernel(const Sources<E> src, int C,
                      const float* __restrict__ scale,
                      const float* __restrict__ mean,
                      const E* __restrict__ w, size_t plane,
                      const float* __restrict__ bias,
                      const E* __restrict__ acc_in, E* __restrict__ y,
                      E* __restrict__ acc_out, float* __restrict__ part,
                      int Tn, int F, int N, int n_fin, bool fuse_elu,
                      bool want_stats) {
  constexpr int BN = 8 * NT8;
  constexpr int EPG = tc::GROUP_BYTES / sizeof(E);  // channels a group
  constexpr int CH = EPG * tc::GMAX;                // channels a chunk
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tw = tc::tile_w(F);
  const int ntc = (F + tw - 1) / tw;
  const int tile = blockIdx.x;
  const int t0 = (tile / ntc) * tc::tile_h(F, MT);
  const int f0 = (tile % ntc) * tw;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int TF = Tn * F;
  float acc[MT * NT8][4] = {};
  if constexpr (tc::kTf32<E>) {
    // float32: acc_in starts the sums, all of a thread's loads issued at
    // once (added in the epilogue, one dependent round trip per position,
    // they set the pace of the calls with partials in)
    if (acc_in) {
      const int shift = tw == 16 ? 4 : 3;
      tc::for_each_acc<NT8, MT>(acc, [&](int o, int m, float& z) {
        const int n = o0 + o;
        const int t = t0 + (m >> shift);
        const int f = f0 + (m & (tw - 1));
        if (n < N && t < Tn && f < F)
          z = ldg_f32(acc_in + ((size_t)b * N + n) * TF + t * F + f);
      });
    }
  }

  int coff = 0;  // first channel of source s in the concatenation
  int goff = 0;  // its first group in the packed weights
  for (int s = 0; s < src.n; coff += src.c[s],
           goff += (src.c[s] + EPG - 1) / EPG, ++s) {
    const E* xsrc = src.x[s];
    const int cs = src.c[s];
    for (int cb = 0; cb < cs; cb += CH) {
      const int rk = min(CH, cs - cb);
      const int c_first = coff + cb;
      const E* xp = xsrc + ((size_t)b * cs + cb) * TF;
      tc::gather_chunk<tc::Geo<tc::M_SAME>, NT8, E, MT>(
          acc, tc_smem, tw, t0, f0, w, plane, N, o0, goff + cb / EPG,
          (rk + EPG - 1) / EPG, rk, Tn, F, [&](int k, int p) {
            const int ch = b * C + c_first + k;
            return (ldg_f32(xp + (size_t)k * TF + p) - __ldg(mean + ch)) *
                   __ldg(scale + ch);
          });
    }
  }

  // epilogue: finalize rows < n_fin, pass the rest on as partials
  tc::finish_gather<NT8, MT>(
      tc_smem, acc, tw, want_stats && o0 < n_fin, n_fin - o0, part,
      (size_t)b * n_fin + o0, (size_t)gridDim.z * n_fin, tile, gridDim.x,
      [&](int o, int pr, int pc, float z) {
        const int n = o0 + o;
        const int t = t0 + pr;
        const int f = f0 + pc;
        if (n >= N || t >= Tn || f >= F) return make_float2(0.f, 0.f);
        const int p = t * F + f;
        if (!tc::kTf32<E> && acc_in)  // bf16: acc_in joins here
          z += ldg_f32(acc_in + ((size_t)b * N + n) * TF + p);
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

template <typename E, int NT8>
cudaError_t launch_dense_tc(const Sources<E>& src, int C,
                            const float* scale, const float* mean,
                            const E* w, size_t plane, const float* bias,
                            const E* acc_in, E* y, E* acc_out, float* part,
                            int B, int Tn, int F, int N, int n_fin,
                            bool fuse_elu, bool want_stats,
                            cudaStream_t st) {
  constexpr int BN = 8 * NT8;
  constexpr int MT = kMt<E>;
  const size_t smem =
      tc::gather_smem<tc::Geo<tc::M_SAME>, E, MT>(BN, tc::tile_w(F));
  static SmemLimit limit;
  const cudaError_t e = limit.raise(dense_stack_tc_kernel<E, NT8, MT>);
  if (e != cudaSuccess) return e;
  const dim3 grid(tc::pos_tiles(Tn, F, MT), (N + BN - 1) / BN, B);
  dense_stack_tc_kernel<E, NT8, MT><<<grid, tc::GM_THREADS, smem, st>>>(
      src, C, scale, mean, w, plane, bias, acc_in, y, acc_out, part, Tn, F,
      N, n_fin, fuse_elu, want_stats);
  return cudaGetLastError();
}

// Both passes of a call in storage type E: the tensor-core conv pass, then
// (with want_stats) the statistics' fixed-order pass over its pos_tiles
// partials.  float32 takes tiles of up to kF32MaxNt8 n8 tiles, an
// odd count allowed (N = 24 is three); bf16 the widest even tile.
template <typename E>
int launch_dense_stack(const Sources<E>& src, const float* scale,
                       const float* mean, const E* w, const float* bias,
                       const E* acc_in, E* y, E* acc_out, float* part,
                       float* sums, float* sqs, int B, int Tn, int F, int N,
                       int n_fin, bool fuse_elu, bool want_stats,
                       void* stream) {
  constexpr bool kF32 = tc::kTf32<E>;
  constexpr int EPG = tc::GROUP_BYTES / sizeof(E);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int C = 0, groups = 0;
  for (int s = 0; s < src.n; ++s) {
    C += src.c[s];
    groups += (src.c[s] + EPG - 1) / EPG;
  }
  // float32: the small plane's offset in 16-byte units
  const size_t plane = kF32 ? (size_t)groups * 9 * N : 0;
  const int nt8 = kF32 ? tc::pick_nt8(N, kF32MaxNt8, true)
                       : tc::pick_nt8(N);
  cudaError_t e;
  switch (nt8) {
#define MISONET_DENSE_TC(NT8)                                                \
  case NT8:                                                                  \
    if constexpr (kF32 ? NT8 <= kF32MaxNt8 : NT8 % 2 == 0) {                 \
      e = launch_dense_tc<E, NT8>(src, C, scale, mean, w, plane, bias,       \
                                  acc_in, y, acc_out, part, B, Tn, F, N,     \
                                  n_fin, fuse_elu, want_stats, st);          \
      break;                                                                 \
    }                                                                        \
    return (int)cudaErrorInvalidValue;
    MISONET_DENSE_TC(1)
    MISONET_DENSE_TC(2)
    MISONET_DENSE_TC(3)
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
                                  tc::pos_tiles(Tn, F, kMt<E>), st);
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
//   w the stacked weights [N, c0 + c1, 3, 3] packed by
//   ops/kernels/tc_pack.py (tc_pack.packed) for sources of widths (c0,
//   c1): float32 as its TF32 big and small planes
//   [2, ceil(c0/4) + ceil(c1/4), 9, N, 4] (pack_tf32), bfloat16
//   [ceil(c0/8) + ceil(c1/8), 9, N, 8],
//   acc_in [B, N, T, F] or NULL, y [B, n_fin, T, F],
//   acc_out [B, N - n_fin, T, F] or NULL when N == n_fin,
//   part [2, B, n_fin, ntiles] scratch with ntiles =
//   misonet_dense_pos_tiles(T, F, bf16), sums, sqs [B, n_fin].
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
// (misonet_dense_layer) or bfloat16 (misonet_dense_layer_bf16), w packed
// as in misonet_dense_stack of its type for the widths, y [B, N, T, F] of the
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

// The position tiles (statistics partials per (batch, channel)) of the
// one-fragment tensor-core kernels over a T x F plane: the int8 call's
// output plane, stencil_bwd's input plane.
extern "C" int misonet_tc_pos_tiles(int T, int F) {
  return misonet::tc::pos_tiles(T, F);
}

// The position tiles of dense_stack's and dense_layer's output plane
// T x F in either mode (bf16 != 0: bfloat16): the last axis of `part`.
extern "C" int misonet_dense_pos_tiles(int T, int F, int bf16) {
  return misonet::tc::pos_tiles(
      T, F, bf16 ? 1 : misonet::kMt<float>);
}
