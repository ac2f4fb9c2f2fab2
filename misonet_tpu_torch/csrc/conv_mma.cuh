// Tensor-core pieces of the bf16 modes of dense_stack.cu (the forward, and
// through it dense_layer) and stencil_bwd.cu (dgrad and wgrad): every
// product is `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` (bf16
// x bf16 products, float32 sums), its operands loaded from shared memory by
// `ldmatrix`.
//
// Layout.  A 3x3 conv is an implicit GEMM whose reduction runs over
// (tap, channel).  The reduced tensor is staged channels-last in shared
// memory: one row per position of a window of the plane, 8 channels (16
// bytes) per "group", rows padded by 16 bytes so that the 8 rows one
// `ldmatrix` reads fall in distinct banks, plus one zero row.  A unit of
// the reduction is (group, tap): 8 channels read at one tap.  Every tap of
// every geometry is then a row pointer per lane: a shifted position, a
// stride-2 position (DOWN, UP), or the zero row for a tap of the wrong
// parity (the window holds zeros outside the plane).  Nothing is masked
// in the inner loop, and the 8 channels of a unit need not be a multiple
// of 16 of the call's channels: C = 24 is 3 groups, 27 units, 14 k-steps.
//
// Operands: the gather kernels (the forward, the dgrad) take A from the
// window with ldmatrix (rows = positions) and B from the weights; the
// wgrad takes A from the window with ldmatrix.trans (rows = channels,
// reduction over positions) and B from g staged [n][position].  Weights
// arrive packed [group][tap][output][8] (ops/kernels/tc_pack.py), so a
// block copies them with 16-byte cp.async while it stages the window.
//
// Geometry (Map): for an output column f and freq tap kf, the window
// column of the source, and the window row r + 1 + TS (kt - 1) for a tile
// row r.  The forward, the dgrad and the wgrad of the five stencil_bwd
// modes use six maps between them (see stencil_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace misonet {
namespace tc {

enum Map {
  M_SAME = 0,     // fs = f + kf - 1, ts = t + kt - 1  (SAME conv)
  M_SAME_T = 1,   // fs = f - kf + 1, ts = t + 1 - kt  (its transpose)
  M_SHIFT = 2,    // fs = f + kf,     ts = t + kt - 1
  M_SHIFT_T = 3,  // fs = f - kf,     ts = t + 1 - kt
  M_DOUBLE = 4,   // fs = 2 f + kf,   ts = t + kt - 1
  M_HALF_T = 5,   // fs = (f - kf) / 2 where f - kf is even, ts = t + 1 - kt
};

template <int MAP>
struct Geo {
  static constexpr int TS =
      (MAP == M_SAME || MAP == M_SHIFT || MAP == M_DOUBLE) ? 1 : -1;
  // first source column of the window of output columns f0 .. f0+tw-1
  // (f0 a multiple of tw, tw even)
  __device__ static int lo(int f0) {
    switch (MAP) {
      case M_SAME: case M_SAME_T: return f0 - 1;
      case M_SHIFT: return f0;
      case M_SHIFT_T: return f0 - 2;
      case M_DOUBLE: return 2 * f0;
      default: return f0 / 2 - 1;
    }
  }
  // window columns for tw output columns
  __host__ __device__ static constexpr int width(int tw) {
    return MAP == M_DOUBLE ? 2 * tw + 1 : MAP == M_HALF_T ? tw / 2 + 1
                                                          : tw + 2;
  }
  // window column of output column f at freq tap kf, or -1 (wrong parity)
  __device__ static int col(int f, int kf, int lo) {
    switch (MAP) {
      case M_SAME: return f + kf - 1 - lo;
      case M_SAME_T: return f - kf + 1 - lo;
      case M_SHIFT: return f + kf - lo;
      case M_SHIFT_T: return f - kf - lo;
      case M_DOUBLE: return 2 * f + kf - lo;
      default: {
        const int d = f - kf;
        return (d & 1) ? -1 : (d >> 1) - lo;
      }
    }
  }
};

constexpr int GROUP_BYTES = 16;  // 8 bf16 channels

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t a, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// ---- the gather conv's main loop --------------------------------------------
//
// A block computes M = 128 positions (8 warps x 16) by BN = 8 * NT8 output
// channels; each warp holds its 16 positions x all BN channels (NT8 * 4
// floats a thread).  Per staged chunk of up to GMAX groups (32 channels)
// the reduction runs over n_units = 9 * groups units, two per k-step.  The
// weights of a chunk sit in shared memory as [unit][BN][8] bf16 (16 bytes
// per (unit, output channel), copied by cp.async from the packed weights
// of ops/kernels/tc_pack.py), units unit_bytes(BN) apart (the 8 rows one
// ldmatrix reads are 128 contiguous bytes); a unit past n_units is zero.

constexpr int GM_WARPS = 8;
constexpr int GM_THREADS = 32 * GM_WARPS;
constexpr int GM_POS = 16 * GM_WARPS;  // positions per block tile
constexpr int GMAX = 4;                // groups (of 8 channels) per chunk
constexpr int GM_UNITS = 9 * GMAX + 1; // + a zero unit for an odd count
constexpr int WIN_ROW = GMAX * GROUP_BYTES + 16;  // bytes per window row

__host__ __device__ constexpr int unit_bytes(int bn) { return bn * 16 + 16; }

// Blocks per SM the gather kernels ask registers for (at most 85 a thread
// up to 32 accumulators, 128 for the widest tile).
__host__ __device__ constexpr int gm_min_blocks(int nt8) {
  return nt8 > 8 ? 2 : 3;
}

// A gather tile is tile_h x tile_w positions of the output plane (8 x 16,
// or 16 x 8 for planes of 8 bins or fewer); its window (tile_h + 2) rows
// x Geo::width(tile_w) columns, + the zero row.
__host__ __device__ inline int tile_w(int F) { return F > 8 ? 16 : 8; }
__host__ __device__ inline int tile_h(int F) { return GM_POS / tile_w(F); }
__host__ __device__ inline int pos_tiles(int T, int F) {
  return ((T + tile_h(F) - 1) / tile_h(F)) * ((F + tile_w(F) - 1) / tile_w(F));
}

// acc[j] += A (this warp's 16 positions x the chunk's units) * B (units x
// the n8 tile j), A's row for unit u given by a_row(u) (a shared-memory
// byte address of 16 channels' worth of row, or of the zero row).
template <int NT8, class ARow>
__device__ __forceinline__ void gather_mma(float (&acc)[NT8][4], int n_units,
                                           uint32_t ws, ARow a_row) {
  static_assert(NT8 % 2 == 0, "n8 tiles come in pairs");
  constexpr int US = unit_bytes(8 * NT8);
  const int lane = threadIdx.x & 31;
  const int j = lane >> 3;
  // B: matrix j of an x4 is (unit 2s + (j & 1), channels 8 (j >> 1) + row)
  const uint32_t b_lane = ws + (j & 1) * US + ((j >> 1) * 8 + (lane & 7)) * 16;
  const int steps = (n_units + 1) >> 1;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    uint32_t a[4];
    ldsm_x4(a_row(2 * s + (lane >> 4)), a);
#pragma unroll
    for (int jp = 0; jp < NT8 / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b_lane + 2 * s * US + jp * 16 * 16, b);
      mma(acc[2 * jp], a, b[0], b[1]);
      mma(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of a chunk's weights: ws[u = g * 9 + tap][o] (16 bytes,
// 8 reduced channels) = wp[gbase + g][tap][o0 + o] of the packed weights
// [G, 9, n_out, 8] (ops/kernels/tc_pack.py), zero for o0 + o >= n_out;
// unit 9 * groups (the pad of an odd count) zero.  Asynchronous: the
// caller waits (cp_async_wait_all) and synchronises before reading.
template <int BN>
__device__ __forceinline__ void stage_weights_tc(
    unsigned char* ws, const __nv_bfloat16* __restrict__ wp, int n_out,
    int o0, int gbase, int groups) {
  constexpr int US = unit_bytes(BN);
  const uint32_t ws_s = smem_addr(ws);
  for (int i = threadIdx.x; i < groups * 9 * BN; i += GM_THREADS) {
    const int u = i / BN;
    const int o = i - u * BN;
    const bool ok = o0 + o < n_out;
    cp_async16(ws_s + u * US + o * 16,
               wp + ((size_t)(gbase * 9 + u) * n_out + (ok ? o0 + o : 0)) * 8,
               ok);
  }
  if ((groups * 9) & 1) {
    uint4* z = reinterpret_cast<uint4*>(ws + groups * 9 * US);
    for (int i = threadIdx.x; i < BN; i += GM_THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
  }
}

// Stage a window of the reduced tensor channels-last: window position i =
// (wr, wc) of rows x sw is plane position (t0 - 1 + wr, lo + wc); its group
// g (< groups) holds channels 8 g .. 8 g + 7 of the chunk, load(k, plane
// index) for k < rk and zero past rk or outside the plane, written as one
// 16-byte store at win + i * row_bytes + 16 g.  Consecutive threads take
// consecutive positions, so each of the 8 loads is coalesced.
template <int THREADS, class Load>
__device__ __forceinline__ void stage_window(unsigned char* win,
                                             int row_bytes, int rows, int sw,
                                             int t0, int lo, int T, int F,
                                             int groups, int rk, Load load) {
  const int n_win = rows * sw;
  for (int i = threadIdx.x; i < n_win * groups; i += THREADS) {
    const int g = i / n_win;
    const int pos = i - g * n_win;
    const int wr = pos / sw;
    const int ts = t0 - 1 + wr;
    const int fs = lo + pos - wr * sw;
    float v[8];
    const bool in = ts >= 0 && ts < T && fs >= 0 && fs < F;
    const int p = ts * F + fs;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (in && 8 * g + e < rk) ? load(8 * g + e, p) : 0.f;
    *reinterpret_cast<uint4*>(win + pos * row_bytes + g * GROUP_BYTES) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// The epilogue goes through shared memory: stage_acc writes the warps'
// accumulators as zt[channel][position] (float, rows Z_ROW apart: the
// fragment stores of a warp fall in distinct banks), and finish_tile walks
// them with the tile's positions along the lanes, so the loads and stores
// of the NCHW planes it does (through fn) are coalesced (tw must be 8 or
// 16, tile_w's widths).
constexpr int Z_ROW = GM_POS + 4;

template <int NT8>
__device__ __forceinline__ void stage_acc(float* zt,
                                          const float (&acc)[NT8][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        zt[(8 * j + 2 * (lane & 3) + e) * Z_ROW + warp * 16 + (lane >> 2) +
           8 * h] = acc[j][2 * h + e];
}

// fn(o, tile row, tile column, z) finishes output channel o0 + o at one
// position of the tile and returns its (sum, sum of squares) terms, zero
// where it writes no statistics.  A warp takes whole channels, its lanes
// along the positions; with stats, a channel's sums over the tile are
// taken in a fixed order (each lane's 4 positions, then the warp's
// butterfly) and written for o < n_stats as part[(row0 + o) * ntiles +
// tile] and part[(rows + row0 + o) * ntiles + tile].
template <int BN, class Fn>
__device__ __forceinline__ void finish_tile(const float* zt, int tw,
                                            bool stats, int n_stats,
                                            float* __restrict__ part,
                                            size_t row0, size_t rows,
                                            int tile, int ntiles, Fn fn) {
  const int lane = threadIdx.x & 31;
  const int shift = tw == 16 ? 4 : 3;
  for (int o = threadIdx.x >> 5; o < BN; o += GM_WARPS) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int c = lane; c < GM_POS; c += 32) {
      const int pr = c >> shift;
      const float2 t = fn(o, pr, c - (pr << shift), zt[o * Z_ROW + c]);
      s += t.x;
      q += t.y;
    }
    if (!stats) continue;  // block-uniform
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, d);
      q += __shfl_xor_sync(0xffffffffu, q, d);
    }
    if (lane == 0 && o < n_stats) {
      part[(row0 + o) * ntiles + tile] = s;
      part[(rows + row0 + o) * ntiles + tile] = q;
    }
  }
}

// The NT8 (n8 tiles a warp, up to max_nt8) of a call with n_out output
// channels: the fewest blocks' worth of (BN + a staging cost of 32
// channels), the widest BN on a tie.
inline int pick_nt8(int n_out, int max_nt8 = 12) {
  const int opts[] = {12, 8, 6, 4, 2};
  int best = 0, best_cost = 1 << 30;
  for (int nt8 : opts) {
    if (nt8 > max_nt8) continue;
    const int bn = 8 * nt8;
    const int cost = ((n_out + bn - 1) / bn) * (bn + 32);
    if (cost < best_cost) {
      best_cost = cost;
      best = nt8;
    }
  }
  return best;
}

}  // namespace tc
}  // namespace misonet
