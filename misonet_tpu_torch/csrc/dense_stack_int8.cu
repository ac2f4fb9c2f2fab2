// dense_stack_int8: the int8 decode mode of the stacked DenseBlock call.
//
// Replaces misonet_tpu/ops/pallas/dense_stack.py::dense_stack_flat with
// quant=True (its Pallas `_kernel` in qmode, :182-186, :209-233, and the
// weight-row quantization of :357-375).  It computes the same function as
// the TPU kernel, with the same quantized quantities:
//
//   q_x[b, c, t, f] = clip(rint(16 * (x[b, c, t, f] * scale[b, c])), +-127)
//
// from the stored bfloat16 raw source (uncentred; zero halo), and, per batch
// element b and output row n, the weight row of the TPU kernel's stack_wb
// (the 9 x C conv weights followed by the 9 mean-correction coefficients
// built from beta = -sum_c w * mean * scale), quantized with ONE row scale
// rs[b, n] = max(max|row|, 1e-20) / 127 over the whole row.  Two kernels:
//
// quantize_rows_kernel (one launch a call, a warp per (b, n) row) builds
// the rows on the card, as ops/kernels/dense_stack_int8.py::quantize_rows
// (its plain twin) does: beta per tap and the 9 coefficients as float64
// sums of the float32 products w * (mean * scale) (exact in float64),
// rounded once to float32, so the two agree but at a float64 tie; the row
// max, rs, and with float32 divisions and rint
//
//   qw   int8 [B, G16, 9, N, 16]  the conv part, packed for the tensor-core
//                                 kernel (tc_pack.py::pack_int8_rows): G16
//                                 groups of 16 channels, each source
//                                 zero-padded to a multiple of 16
//   corr int32 [B, N, 16]    16 * sum_j q_coef[b, n, j] * field_j for each of
//                            the 16 edge classes (t == 0, t == T-1, f == 0,
//                            f == F-1) a position can sit in
//   rq   f32 [B, N]          rs / 16
//
// dense_stack_int8_tc_kernel runs the conv on the int8 tensor cores,
// `mma.sync m16n8k32` s8 x s8 -> s32 (conv_mma.cuh's gather conv with a
// unit of 16 channels at one tap, its fragments from the same ldmatrix
// addresses as the bf16 kernels'): the window of each chunk of up to 64
// channels of a source is quantized on load, channels-last; each batch
// element's weight rows are copied by cp.async (the B tile differs for
// every b, so nothing is shared across b); the int32 sums are exact (|sum|
// <= 127^2 * 576 < 2^31) and z = rq * (sum + corr[class(t, f)]) exactly
// as the TPU kernel's int32 dot with its 0/16 indicator rows.  Then the
// bfloat16 epilogue of dense_stack.cu, through shared memory: + acc_in
// (bfloat16, in float32), + bias, ELU, y stored bfloat16 with its
// statistics from the float32 y, the remaining rows stored bfloat16 as
// acc_out.  The float products and sums are written with explicit
// round-to-nearest intrinsics so that no multiply-add contraction makes
// them differ from the plain version's.
//
// Bound on the H100: its bytes (0.204 ms over phase 11's cases; its
// operations at the int8 tensor-core rate take 0.062).  What limits it is
// staging the window, quantized on load (PERF.md).  Source widths of 24
// pad to 32 channels, a third more MACs in the enc0 and dec6 calls: those
// take 0.94-1.16x the bf16 kernel's time, the unpadded enc1 calls
// 0.85-0.88x.  Source widths must be multiples of 4, the wrapper's
// contract (the default plan's are 24, 32, 64).

#include "conv_common.cuh"
#include "conv_mma.cuh"

namespace misonet {
namespace {

using bf16 = __nv_bfloat16;

constexpr float QS = 16.f;   // static activation scale
constexpr int QR_WARPS = 8;  // rows per block of quantize_rows_kernel

__device__ __forceinline__ float quantize(float x, float sc) {
  const float q = rintf(__fmul_rn(__fmul_rn(x, sc), QS));
  return fminf(fmaxf(q, -127.f), 127.f);
}

// One warp per (b, n) row: w [N, C, 3, 3] float32, scale and mean [B, C];
// writes qw, corr and rq as in the note at the top of the file.
__global__ void __launch_bounds__(32 * QR_WARPS)
quantize_rows_kernel(const float* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ mean, int c0, int c1, int B,
                     int N, signed char* __restrict__ qw,
                     int* __restrict__ corr, float* __restrict__ rq) {
  const int row = blockIdx.x * QR_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * N) return;  // whole warps leave together
  const int b = row / N;
  const int n = row - b * N;
  const int C = c0 + c1;
  const float* wr = w + (size_t)n * C * 9;

  // sum_c w * (mean * scale) per tap in float64 (each product exact), and
  // the largest |w| of the row
  double acc[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) acc[tap] = 0.0;
  float wmax = 0.f;
  for (int c = lane; c < C; c += 32) {
    const double ms =
        (double)__fmul_rn(__ldg(mean + b * C + c), __ldg(scale + b * C + c));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float v = __ldg(wr + c * 9 + tap);
      acc[tap] += (double)v * ms;
      wmax = fmaxf(wmax, fabsf(v));
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      acc[tap] += __shfl_xor_sync(0xffffffffu, acc[tap], d);
    wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, d));
  }
  // every lane holds the same sums: beta = -acc, taps kt * 3 + kf
  double bt[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) bt[tap] = -acc[tap];
  double all = 0.0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) all += bt[tap];
  const double cd[9] = {all,
                        -(bt[0] + bt[1] + bt[2]),
                        -(bt[6] + bt[7] + bt[8]),
                        -(bt[0] + bt[3] + bt[6]),
                        -(bt[2] + bt[5] + bt[8]),
                        bt[0], bt[2], bt[6], bt[8]};
  float coef[9];
  float rmax = wmax;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    coef[j] = __double2float_rn(cd[j]);
    rmax = fmaxf(rmax, fabsf(coef[j]));
  }
  const float rs = __fdiv_rn(fmaxf(rmax, 1e-20f), 127.f);
  auto q = [&](float v) {
    return fminf(fmaxf(rintf(__fdiv_rn(v, rs)), -127.f), 127.f);
  };

  if (lane < 16) {  // corr of edge class `lane`
    const int t0 = lane & 1, tn = lane >> 1 & 1;
    const int f0 = lane >> 2 & 1, fn = lane >> 3 & 1;
    const int field[9] = {1, t0, tn, f0, fn, t0 * f0, t0 * fn, tn * f0,
                          tn * fn};
    int s = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) s += (int)q(coef[j]) * field[j];
    corr[(size_t)row * 16 + lane] = s * (int)QS;
  }
  if (lane == 0) rq[row] = __fdiv_rn(rs, QS);

  // the conv part, packed [b][group][tap][n][16]; pad channels zero
  const int g0 = (c0 + 15) / 16;
  const int groups = g0 + (c1 + 15) / 16;
  for (int slot = lane; slot < groups * 16; slot += 32) {
    const int g = slot >> 4;
    const int e = slot & 15;
    const int c = g < g0 ? 16 * g + e : 16 * (g - g0) + e;
    const bool ok = g < g0 ? c < c0 : c < c1;
    const int ch = g < g0 ? c : c0 + c;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float v = ok ? q(__ldg(wr + ch * 9 + tap)) : 0.f;
      qw[(((size_t)(b * groups + g) * 9 + tap) * N + n) * 16 + e] =
          (signed char)(int)v;
    }
  }
}

// One block: a tile of tc::GM_POS output positions (tile_h rows x tile_w
// columns of the plane) x BN = 8 NT8 output channels of one batch element.
template <int NT8>
__global__ void __launch_bounds__(tc::GM_THREADS, tc::gm_min_blocks(NT8))
dense_stack_int8_tc_kernel(const bf16* __restrict__ x0, int c0,
                           const bf16* __restrict__ x1, int c1,
                           const float* __restrict__ scale,
                           const signed char* __restrict__ qw,
                           const int* __restrict__ corr,
                           const float* __restrict__ rq,
                           const float* __restrict__ bias,
                           const bf16* __restrict__ acc_in,
                           bf16* __restrict__ y, bf16* __restrict__ acc_out,
                           float* __restrict__ part, int T, int F, int N,
                           int n_fin) {
  constexpr int BN = 8 * NT8;
  constexpr int CPG = 16;  // int8 channels per group
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tw = tc::tile_w(F);
  const int ntc = (F + tw - 1) / tw;
  const int tile = blockIdx.x;
  const int t0 = (tile / ntc) * (tc::GM_POS / tw);
  const int f0 = (tile % ntc) * tw;
  const int o0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int C = c0 + c1;
  const int TF = T * F;
  const int g0 = (c0 + CPG - 1) / CPG;
  const int groups = g0 + (c1 + CPG - 1) / CPG;
  const signed char* wb = qw + (size_t)b * groups * 9 * N * CPG;
  int acc[NT8][4] = {};

  for (int s = 0; s < 2; ++s) {
    const bf16* xsrc = s ? x1 : x0;
    const int cs = s ? c1 : c0;
    const float* sc = scale + b * C + (s ? c0 : 0);
    for (int cb = 0; cb < cs; cb += CPG * tc::GMAX) {
      const int rk = min(CPG * tc::GMAX, cs - cb);
      const bf16* xp = xsrc + ((size_t)b * cs + cb) * TF;
      tc::gather_chunk<tc::Geo<tc::M_SAME>, NT8, signed char>(
          acc, tc_smem, tw, t0, f0, wb, 0, N, o0, (s ? g0 : 0) + cb / CPG,
          (rk + CPG - 1) / CPG, rk, T, F, [&](int k, int p) {
            return quantize(tc::bf16_at(xp + (size_t)k * TF + p),
                            __ldg(sc + cb + k));
          });
    }
  }

  // epilogue: dequantize, then finalize rows < n_fin and pass the rest on
  tc::finish_gather<NT8>(
      tc_smem, acc, tw, o0 < n_fin, n_fin - o0, part,
      (size_t)b * n_fin + o0, (size_t)gridDim.z * n_fin, tile, gridDim.x,
      [&](int o, int pr, int pc, float zi) {
        const int n = o0 + o;
        const int t = t0 + pr;
        const int f = f0 + pc;
        if (n >= N || t >= T || f >= F) return make_float2(0.f, 0.f);
        // the edge class: bit 0 t == 0, bit 1 t == T-1, bit 2 f == 0,
        // bit 3 f == F-1 (the TPU kernel's indicator fields)
        const int cls = (t == 0) | (t == T - 1) << 1 | (f == 0) << 2 |
                        (f == F - 1) << 3;
        const size_t r = (size_t)b * N + n;
        const int p = t * F + f;
        // zi holds the int32 sum's bits (tc::stage_acc)
        float z = __fmul_rn(
            __int2float_rn(__float_as_int(zi) + __ldg(corr + r * 16 + cls)),
            __ldg(rq + r));
        if (acc_in) z = __fadd_rn(z, tc::bf16_at(acc_in + r * TF + p));
        if (n >= n_fin) {
          store(acc_out + ((size_t)b * (N - n_fin) + (n - n_fin)) * TF + p,
                z);
          return make_float2(0.f, 0.f);
        }
        const float v = elu(__fadd_rn(z, __ldg(bias + n)));
        store(y + ((size_t)b * n_fin + n) * TF + p, v);
        return make_float2(v, v * v);
      });
}

template <int NT8>
cudaError_t launch_int8_tc(const bf16* x0, int c0, const bf16* x1, int c1,
                           const float* scale, const signed char* qw,
                           const int* corr, const float* rq,
                           const float* bias, const bf16* acc_in, bf16* y,
                           bf16* acc_out, float* part, int B, int T, int F,
                           int N, int n_fin, cudaStream_t st) {
  constexpr int BN = 8 * NT8;
  const size_t smem =
      tc::gather_smem<tc::Geo<tc::M_SAME>>(BN, tc::tile_w(F));
  cudaError_t e = cudaFuncSetAttribute(
      dense_stack_int8_tc_kernel<NT8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tc::pos_tiles(T, F), (N + BN - 1) / BN, B);
  dense_stack_int8_tc_kernel<NT8><<<grid, tc::GM_THREADS, smem, st>>>(
      x0, c0, x1, c1, scale, qw, corr, rq, bias, acc_in, y, acc_out, part, T,
      F, N, n_fin);
  return cudaGetLastError();
}

}  // namespace
}  // namespace misonet

// C entry points.  All tensors contiguous, on the current device.
//
// misonet_quantize_rows_int8: w [N, c0 + c1, 3, 3], scale and mean
// [B, c0 + c1] float32 -> qw int8 [B, G16, 9, N, 16] (G16 = ceil(c0/16) +
// ceil(c1/16)), corr int32 [B, N, 16], rq float32 [B, N].  One launch.
//
// misonet_dense_stack_int8:
//   x0 [B, c0, T, F], x1 [B, c1, T, F] or NULL (c1 = 0) bfloat16, with c0
//   and c1 multiples of 4; scale [B, c0 + c1] float32;
//   qw, corr, rq from misonet_quantize_rows_int8; bias [n_fin] float32;
//   acc_in [B, N, T, F] bfloat16 or NULL;
//   y [B, n_fin, T, F] and acc_out [B, N - n_fin, T, F] (NULL when
//   N == n_fin) bfloat16;
//   part [2, B, n_fin, ntiles] float32 scratch with ntiles =
//   misonet_tc_pos_tiles(T, F), sums, sqs [B, n_fin] float32.
//
// Both return cudaGetLastError() after their launches (0 on success); the
// second cudaErrorInvalidValue for source widths that are not multiples
// of 4.
extern "C" int misonet_quantize_rows_int8(const float* w, const float* scale,
                                          const float* mean, int c0, int c1,
                                          int B, int N, signed char* qw,
                                          int* corr, float* rq,
                                          void* stream) {
  using namespace misonet;
  const int rows = B * N;
  quantize_rows_kernel<<<(rows + QR_WARPS - 1) / QR_WARPS, 32 * QR_WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      w, scale, mean, c0, c1, B, N, qw, corr, rq);
  return (int)cudaGetLastError();
}

extern "C" int misonet_dense_stack_int8(
    const __nv_bfloat16* x0, int c0, const __nv_bfloat16* x1, int c1,
    const float* scale, const signed char* qw, const int* corr,
    const float* rq, const float* bias, const __nv_bfloat16* acc_in,
    __nv_bfloat16* y, __nv_bfloat16* acc_out, float* part, float* sums,
    float* sqs, int B, int T, int F, int N, int n_fin, void* stream) {
  using namespace misonet;
  if (c0 % 4 || c1 % 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (tc::pick_nt8(N)) {
#define MISONET_INT8_TC(NT8)                                              \
  case NT8:                                                               \
    e = launch_int8_tc<NT8>(x0, c0, x1, c1, scale, qw, corr, rq, bias,    \
                            acc_in, y, acc_out, part, B, T, F, N, n_fin,  \
                            st);                                          \
    break;
    MISONET_INT8_TC(2)
    MISONET_INT8_TC(4)
    MISONET_INT8_TC(6)
    MISONET_INT8_TC(8)
    MISONET_INT8_TC(12)
#undef MISONET_INT8_TC
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce_stats(part, sums, sqs, B * n_fin,
                                  tc::pos_tiles(T, F), st);
}
