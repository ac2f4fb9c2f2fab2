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
// rs[b, n] = max(max|row|, 1e-20) / 127 over the whole row.  The row
// quantization runs in PyTorch before the launch (ops/kernels/
// dense_stack_int8.py::quantize_rows) and hands the kernel
//
//   qw   int8 [B, N, 9, C]   the conv part, tap-major, channels fastest
//   corr int32 [B, N, 16]    16 * sum_j q_coef[b, n, j] * field_j for each of
//                            the 16 edge classes (t == 0, t == T-1, f == 0,
//                            f == F-1) a position can sit in
//   rq   f32 [B, N]          rs / 16
//
// so that z = rq * (sum_{c, tap} qw * q_x + corr[class(t, f)]) exactly as the
// TPU kernel's int32 dot with its 0/16 indicator rows.  Then the bfloat16
// epilogue of dense_stack.cu: + acc_in (bfloat16, in float32), + bias, ELU,
// y stored bfloat16 with its statistics from the float32 y, the remaining
// rows stored bfloat16 as acc_out.  The float products and sums are
// written with explicit round-to-nearest intrinsics so that no multiply-add
// contraction makes them differ from the plain version's.
//
// Bound on the H100: integer dot throughput.  K = 9 * C (216..576) and
// N = 24..192 per call; at the int8 tensor-core rate the call is bound by
// its bytes, but this first version runs on the CUDA cores: `__dp4a` takes
// 4 channels packed in one 32-bit word, so a tap costs a quarter of the
// float32 kernel's FMAs.  The design follows dense_stack.cu: a block holds
// 32 output channels x 256 positions of one batch element; each round
// stages 16 source channels (4 packed words per position), quantized once
// on load, as the flat run of input rows the tile reads, and each thread
// holds 16 channels x 2 positions of int32 sums and reads its 16 packed
// weights per (word, tap) as four int4 broadcasts.  Source widths must be
// multiples of 4 (the default plan's are 24, 32, 64).

#include "conv_common.cuh"

namespace misonet {
namespace {

constexpr int PT = 2;                  // output positions per thread
constexpr int LANES = POS_TILE / PT;   // position lanes per channel half
constexpr int THREADS = 2 * LANES;     // two 16-channel halves
constexpr int CW = 4;                  // packed 4-channel words per round
constexpr int MIN_BLOCKS = 4;          // per SM: caps registers at 64
constexpr float QS = 16.f;             // static activation scale

// Words staged per packed word of channels: the rows a tile spans, plus one
// row above and one below (as dense_stack.cu's stage_floats).
inline int stage_words(int F) { return ((POS_TILE - 1) / F + 4) * F; }

__device__ __forceinline__ int quantize(float x, float sc) {
  const float q = rintf(__fmul_rn(__fmul_rn(x, sc), QS));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_stack_int8_kernel(const __nv_bfloat16* __restrict__ x0, int c0,
                        const __nv_bfloat16* __restrict__ x1, int c1,
                        const float* __restrict__ scale,
                        const int* __restrict__ qw,
                        const int* __restrict__ corr,
                        const float* __restrict__ rq,
                        const float* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ acc_in,
                        __nv_bfloat16* __restrict__ y,
                        __nv_bfloat16* __restrict__ acc_out,
                        float* __restrict__ part,
                        int T, int F, int N, int n_fin, int xs_w) {
  extern __shared__ __align__(16) int smem_i[];
  int (*ws)[9][WS_ROW] = reinterpret_cast<int (*)[9][WS_ROW]>(smem_i);
  int* xs = smem_i + CW * 9 * WS_ROW;  // CW staged words of xs_w positions
  const int half = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int C = c0 + c1;
  const int C4 = C / 4;
  const int TF = T * F;

  // staged run: rows r0-1 .. r1+1 of the plane, flat from index g0
  const int p0 = tile * POS_TILE;
  const int r0 = p0 / F;
  const int r1 = (min(p0 + POS_TILE, TF) - 1) / F;
  const int g0 = (r0 - 1) * F;
  const int n_stage = (r1 - r0 + 3) * F;

  int pos[PT], li[PT], edge[PT];
  bool pv[PT], has_left[PT], has_right[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    pos[j] = p0 + j * LANES + lane;
    pv[j] = pos[j] < TF;
    const int pc = pv[j] ? pos[j] : TF - 1;  // ragged tail reads in range
    const int t = pc / F;
    const int f = pc - t * F;
    li[j] = pc - g0;
    has_left[j] = f > 0;
    has_right[j] = f < F - 1;
    // the edge class: bit 0 t == 0, bit 1 t == T-1, bit 2 f == 0, bit 3
    // f == F-1 (the TPU kernel's indicator fields)
    edge[j] = (t == 0) | (t == T - 1) << 1 | (f == 0) << 2 | (f == F - 1) << 3;
  }

  int acc[NT][PT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[i][j] = 0;

  for (int s = 0; s < 2; ++s) {
    const __nv_bfloat16* xsrc = s ? x1 : x0;
    const int cs = s ? c1 : c0;
    const int coff = s ? c0 : 0;
    for (int cb = 0; cb < cs; cb += 4 * CW) {
      const int nw = min(CW, (cs - cb) / 4);
      __syncthreads();  // the previous round is consumed
      // ws[g][tap][nn] = the packed weights of channels coff+cb+4g .. +3
      for (int i = threadIdx.x; i < CW * 9 * NB; i += THREADS) {
        const int g = i % CW;
        const int r = i / CW;
        const int tap = r % 9;
        const int nn = r / 9;
        const int n = n0 + nn;
        int v = 0;
        if (n < N && g < nw)
          v = __ldg(qw + ((size_t)(b * N + n) * 9 + tap) * C4 +
                    (coff + cb) / 4 + g);
        ws[g][tap][nn] = v;
      }
      // xs[g][i]: channels cb+4g .. +3 at flat index g0+i, quantized and
      // packed (byte k = channel 4g+k, as the int8 weights lie in memory)
      for (int i = threadIdx.x; i < nw * n_stage; i += THREADS) {
        const int g = i / n_stage;
        const int k = i - g * n_stage;
        const int gi = g0 + k;
        int word = 0;
        if (gi >= 0 && gi < TF) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = cb + 4 * g + q;
            const float x = ldg_f32(xsrc + ((size_t)b * cs + c) * TF + gi);
            word |= (quantize(x, scale[b * C + coff + c]) & 0xff) << (8 * q);
          }
        }
        xs[g * xs_w + k] = word;
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < CW; ++g) {
        if (g >= nw) break;
        const int* xg = xs + g * xs_w;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            int xv[PT];
#pragma unroll
            for (int j = 0; j < PT; ++j) {
              const int v = xg[li[j] + (dt - 1) * F + df - 1];
              const bool ok = df == 0 ? has_left[j]
                            : df == 2 ? has_right[j] : true;
              xv[j] = ok ? v : 0;
            }
            const int4* w4 =
                reinterpret_cast<const int4*>(&ws[g][dt * 3 + df][half * NT]);
#pragma unroll
            for (int q = 0; q < NT / 4; ++q) {
              const int4 wv = w4[q];
#pragma unroll
              for (int j = 0; j < PT; ++j) {
                acc[4 * q + 0][j] = __dp4a(wv.x, xv[j], acc[4 * q + 0][j]);
                acc[4 * q + 1][j] = __dp4a(wv.y, xv[j], acc[4 * q + 1][j]);
                acc[4 * q + 2][j] = __dp4a(wv.z, xv[j], acc[4 * q + 2][j]);
                acc[4 * q + 3][j] = __dp4a(wv.w, xv[j], acc[4 * q + 3][j]);
              }
            }
          }
        }
      }
    }
  }

  // epilogue: dequantize, then finalize rows < n_fin and pass the rest on
  float su[NT], sq[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    su[i] = 0.f;
    sq[i] = 0.f;
    const int n = n0 + half * NT + i;
    if (n >= N) continue;
    const float r = rq[b * N + n];
    const int* cr = corr + (size_t)(b * N + n) * 16;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      if (!pv[j]) continue;
      float z = __fmul_rn(__int2float_rn(acc[i][j] + __ldg(cr + edge[j])), r);
      if (acc_in)
        z = __fadd_rn(z, ldg_f32(acc_in + ((size_t)b * N + n) * TF + pos[j]));
      if (n < n_fin) {
        const float v = elu(__fadd_rn(z, bias[n]));
        store(y + ((size_t)b * n_fin + n) * TF + pos[j], v);
        su[i] += v;
        sq[i] += v * v;
      } else {
        store(acc_out + ((size_t)b * (N - n_fin) + (n - n_fin)) * TF + pos[j],
              z);
      }
    }
  }
  if (n0 < n_fin)  // block-uniform
    block_stats<THREADS>(su, sq, part, b, B, n0, n_fin, tile, gridDim.x);
}

}  // namespace
}  // namespace misonet

// C entry point.  All tensors contiguous, on the current device:
//   x0 [B, c0, T, F], x1 [B, c1, T, F] or NULL (c1 = 0) bfloat16, with c0
//   and c1 multiples of 4; scale [B, c0 + c1] float32;
//   qw int8 [B, N, 9, c0 + c1]; corr int32 [B, N, 16]; rq [B, N], bias
//   [n_fin] float32; acc_in [B, N, T, F] bfloat16 or NULL;
//   y [B, n_fin, T, F] and acc_out [B, N - n_fin, T, F] (NULL when
//   N == n_fin) bfloat16;
//   part [2, B, n_fin, ntiles] float32 scratch with ntiles = ceil(T*F/256),
//   sums, sqs [B, n_fin] float32.
// Returns cudaGetLastError() after the launches (0 on success), and
// cudaErrorInvalidValue for source widths that are not multiples of 4.
extern "C" int misonet_dense_stack_int8(
    const __nv_bfloat16* x0, int c0, const __nv_bfloat16* x1, int c1,
    const float* scale, const signed char* qw, const int* corr,
    const float* rq, const float* bias, const __nv_bfloat16* acc_in,
    __nv_bfloat16* y, __nv_bfloat16* acc_out, float* part, float* sums,
    float* sqs, int B, int T, int F, int N, int n_fin, void* stream) {
  using namespace misonet;
  if (c0 % 4 || c1 % 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (T * F + POS_TILE - 1) / POS_TILE;
  const dim3 grid(ntiles, (N + NB - 1) / NB, B);
  const int xs_w = stage_words(F);
  // weights, staged words, and slack after the last word: the masked edge
  // taps of a tile's first and last position read one word outside their
  // run (into the weights before it or this slack)
  const size_t smem = (CW * 9 * WS_ROW + CW * xs_w + 4) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      dense_stack_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dense_stack_int8_kernel<<<grid, THREADS, smem, st>>>(
      x0, c0, x1, c1, scale, reinterpret_cast<const int*>(qw), corr, rq,
      bias, acc_in, y, acc_out, part, T, F, N, n_fin, xs_w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce_stats(part, sums, sqs, B * n_fin, ntiles, st);
}
