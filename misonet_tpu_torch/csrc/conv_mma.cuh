// Tensor-core pieces of the gather convs: the float32 and bf16 modes of
// dense_stack.cu (the forward, and through it dense_layer), stencil.cu and
// stencil_bwd.cu (dgrad and wgrad), and the int8 kernel
// dense_stack_int8.cu.  bf16 products are
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` (bf16 x bf16
// products, float32 sums), int8 products
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (exact int32 sums),
// float32 products three `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`
// over split operands (below), their operands loaded from shared memory by
// `ldmatrix`.
//
// float32 on TF32 tensor cores.  Each float32 operand x splits into big =
// tf32(x) and small = tf32(x - big) (cvt.rna: 10 explicit mantissa bits,
// ties away from zero; x - big is exact in float32), so x = big + small
// + O(2^-22 |x|).  A product is then big big + big small + small big,
// summed in the mma's float32 accumulators (small terms first); only
// small small, about 2^-22 of the product, is left out.  That is
// float32's accuracy class at a third of the TF32 rate (495 / 3 = 165
// TFLOP/s on the H100 against 67 for float32 FMAs); one TF32 pass would
// keep about three decimal digits.  The window splits in registers after
// its ldmatrix; the weights arrive split, as two packed planes (big,
// small) made once per weight version by one launch of
// pack_tf32_kernel (tc_pack.cu, through tc_pack.packed of a float32
// weight), which a block stages side by side: splitting them in registers
// as well cost the dgrad more than the second plane's staging does (a
// diagnostic build on the H100, PERF.md).  The wgrad, whose operands are both
// activations, splits both once as it stages them, into big and small
// planes in shared memory.
//
// Layout.  A 3x3 conv is an implicit GEMM whose reduction runs over
// (tap, channel).  The reduced tensor is staged channels-last in shared
// memory: one row per position of a window of the plane, 16 bytes (4
// float32, 8 bf16 or 16 int8 channels) per "group", rows padded by 16
// bytes so that the 8 rows one `ldmatrix` reads fall in distinct banks,
// plus one zero row.  A unit of the reduction is (group, tap): one group
// read at one tap.  Every tap of every geometry is then a row pointer per
// lane: a shifted position, a stride-2 position (DOWN, UP), or the zero
// row for a tap of the wrong parity (the window holds zeros outside the
// plane).  Nothing is masked in the inner loop, and a group need not be a
// multiple of a k-step of the call's channels: bf16 C = 24 is 3 groups, 27
// units, 14 k-steps.  A k-step is two units in every type (8 float32, 16
// bf16 or 32 int8 values), so the fragments of m16n8k8 tf32, m16n8k16
// bf16 and m16n8k32 s8 come out of the same ldmatrix addresses: a 32-bit
// register holds 1 float32, 2 bf16 or 4 int8 values of one row.
//
// Operands: the gather kernels (the forwards, the dgrad) take A from the
// window with ldmatrix (rows = positions) and B from the weights; the
// wgrad takes A from the window (rows = channels, reduction over
// positions: ldmatrix.trans in bf16, 32-bit loads in float32, whose
// elements ldmatrix.trans would cut in half) and B from g staged
// [n][position].  Weights arrive packed [group][tap][output][16 bytes]
// (ops/kernels/tc_pack.py), so a block copies them with 16-byte cp.async
// while it stages the window.
//
// Geometry: for an output column f and freq tap kf, the window column of
// the source, and the window row r + 1 + TS (kt - 1) for a tile row r.  The
// forwards, the dgrad and the wgrad of the five stencil_bwd modes use six
// maps between them (tc::Geo; see stencil_bwd.cu); stencil.cu adds the two
// parity planes of its stride-2 transpose (UpGeo there).  A geometry class
// also names the taps a block reduces over (NTAP of them, tap(i)): all 9,
// or those of one parity plane.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  static constexpr int NTAP = 9;              // every tap
  static constexpr bool SKIP = MAP == M_HALF_T;  // col() may be -1
  __device__ static int tap(int i) { return i; }
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

constexpr int GROUP_BYTES = 16;  // 4 float32, 8 bf16 or 16 int8 channels

// Element types whose products run as three TF32 passes, and the packed
// weight planes of each type (float32: TF32 big and small).
template <typename E>
constexpr bool kTf32 = std::is_same_v<E, float>;
template <typename E>
constexpr int kPlanes = kTf32<E> ? 2 : 1;

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

// d += a (16 x 32, row) * b (32 x 8, col), int8 operands, int32 sums.
// Register a0 holds row g = lane / 4 at k = 4 (lane % 4) .. + 3, a1 row
// g + 8, a2 and a3 the same at k + 16; b0 column g at k = 4 (lane % 4) ..
// + 3, b1 at k + 16; d as the bf16 product's (rows g, g + 8, columns
// 2 (lane % 4) + 0, 1).
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 operands, float32 sums.
// Register a0 holds row g = lane / 4 at k = lane % 4, a1 row g + 8, a2 and
// a3 the same at k + 4; b0 column g at k = lane % 4, b1 at k + 4; d as the
// bf16 product's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x (float32 bits) -> big = tf32(x), small = tf32(x - big), both rounded
// to nearest with ties away from zero (cvt.rna), as tc_pack.tf32_split.
template <int K>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[K],
                                           uint32_t (&big)[K],
                                           uint32_t (&small)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const float v = __uint_as_float(x[e]);
    uint32_t hi, lo;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
    big[e] = hi;
    small[e] = lo;
  }
}

// d += (ab + as) (bb + bs) but for as bs: the three TF32 products of split
// operands, small terms first (b0, b1 as mma_tf32's).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four int8 values (exact integers in [-127, 127], held as floats), byte
// k the k-th.
__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c,
                                            float d) {
  return ((uint32_t)(int)a & 0xffu) | ((uint32_t)(int)b & 0xffu) << 8 |
         ((uint32_t)(int)c & 0xffu) << 16 | ((uint32_t)(int)d & 0xffu) << 24;
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// ---- the gather conv's main loop --------------------------------------------
//
// A block computes M = MT * 128 positions (8 warps x MT m16 fragments) by
// BN = 8 * NT8 output channels; each warp holds its MT x 16 positions x
// all BN channels (MT * NT8 * 4 sums a thread), fragment i of warp w the
// tile positions i * 128 + 16 w .. + 15.  MT = 2 reads each B fragment
// once for two A fragments, which halves the shared-memory reads of B per
// mma (the float32 dense_stack and dense_layer; every other kernel runs
// MT = 1).  Per staged chunk of up to GMAX groups the reduction runs over
// n_units = NTAP * groups units, two per k-step.  The weights of a chunk
// sit in shared memory as [unit][BN][16 bytes] (copied by cp.async from
// the packed weights), units unit_bytes(BN) apart (the 8 rows one
// ldmatrix reads are 128 contiguous bytes); a unit past n_units is zero.

constexpr int GM_WARPS = 8;
constexpr int GM_THREADS = 32 * GM_WARPS;
constexpr int GM_POS = 16 * GM_WARPS;  // positions per block tile
constexpr int GMAX = 4;                // groups per chunk
constexpr int GM_UNITS = 9 * GMAX + 1; // + a zero unit for an odd count
constexpr int WIN_ROW = GMAX * GROUP_BYTES + 16;  // bytes per window row

__host__ __device__ constexpr int unit_bytes(int bn) { return bn * 16 + 16; }

// Blocks per SM the gather kernels ask registers for (at most 85 a thread
// up to 32 accumulators, 128 for the widest tile; float32, which keeps a
// chunk's sums apart and splits its operands, 128 past 8 accumulators).
template <typename E = void>
__host__ __device__ constexpr int gm_min_blocks(int nt8, int mt = 1) {
  return mt * nt8 > (kTf32<E> ? 2 : 8) ? 2 : 3;
}

// A gather tile is tile_h x tile_w positions of the output plane (8 x 16,
// or 16 x 8 for planes of 8 bins or fewer, MT times the rows at MT
// fragments a warp); its window (tile_h + 2) rows x G::width(tile_w)
// columns, + the zero row.
__host__ __device__ inline int tile_w(int F) { return F > 8 ? 16 : 8; }
__host__ __device__ inline int tile_h(int F, int mt = 1) {
  return mt * GM_POS / tile_w(F);
}
__host__ __device__ inline int pos_tiles(int T, int F, int mt = 1) {
  return ((T + tile_h(F, mt) - 1) / tile_h(F, mt)) *
         ((F + tile_w(F) - 1) / tile_w(F));
}

// The epilogue's rows of sums in shared memory (stage_acc): one per
// output channel, the tile's positions + 4 floats apart.
__host__ __device__ constexpr int z_row(int mt) { return mt * GM_POS + 4; }

// Dynamic shared memory of a gather kernel: the weights of a chunk (one
// plane, or float32's two), then the window and its zero row; the
// epilogue's sums (z_row) reuse these bytes from the start.
template <class G, typename E = void, int MT = 1>
__host__ __device__ constexpr size_t gather_smem(int bn, int tw) {
  const size_t main = (size_t)kPlanes<E> * GM_UNITS * unit_bytes(bn) +
                      (size_t)((MT * GM_POS / tw + 2) * G::width(tw) + 1) *
                          WIN_ROW;
  const size_t sums = (size_t)bn * z_row(MT) * sizeof(float);
  return main > sums ? main : sums;
}

// d += a b for a k-step: one mma of bf16 or int8 operands, or float32's
// three TF32 passes over split operands (the small parts as, bs0, bs1).
template <typename E, typename Acc>
__device__ __forceinline__ void mma_step(Acc (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&as)[4], uint32_t b0,
                                         uint32_t b1, uint32_t bs0,
                                         uint32_t bs1) {
  if constexpr (kTf32<E>)
    mma3(d, a, as, b0, b1, bs0, bs1);
  else
    mma(d, a, b0, b1);
}

// d[i * NT8 + j] += A (fragment i: 16 of this warp's positions x the
// chunk's units) * B (units x the n8 tile j), A's row for unit u given by
// a_row(u, i) (a shared-memory byte address of 16 bytes of one window row,
// or of the zero row), both of element type E; float32: A split in
// registers, B's small plane GM_UNITS units after its big one.  n8 tiles
// go in pairs (ldmatrix.x4 of B), an odd last one alone (.x2), so a
// narrow output (N = 2, 4) takes one n8 tile; each B fragment serves the
// MT fragments of A.
template <int NT8, typename E, int MT, typename Acc, class ARow>
__device__ __forceinline__ void gather_steps(Acc (&d)[MT * NT8][4],
                                             int n_units, uint32_t ws,
                                             ARow a_row) {
  constexpr int US = unit_bytes(8 * NT8);
  constexpr uint32_t SMALL = GM_UNITS * US;  // B's small plane (float32)
  const int lane = threadIdx.x & 31;
  const int j = lane >> 3;
  // B: matrix j of an x4 is (unit 2s + (j & 1), channels 8 (j >> 1) + row)
  const uint32_t b_lane = ws + (j & 1) * US + ((j >> 1) * 8 + (lane & 7)) * 16;
  const int steps = (n_units + 1) >> 1;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    uint32_t a[MT][4], as[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      ldsm_x4(a_row(2 * s + (lane >> 4), i), a[i]);
      if constexpr (kTf32<E>) split_tf32(a[i], a[i], as[i]);
    }
#pragma unroll
    for (int jp = 0; jp < NT8 / 2; ++jp) {
      const uint32_t ba = b_lane + 2 * s * US + jp * 16 * 16;
      uint32_t b[4], bs[4] = {};
      ldsm_x4(ba, b);
      if constexpr (kTf32<E>) ldsm_x4(ba + SMALL, bs);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_step<E>(d[i * NT8 + 2 * jp], a[i], as[i], b[0], b[1], bs[0],
                    bs[1]);
        mma_step<E>(d[i * NT8 + 2 * jp + 1], a[i], as[i], b[2], b[3], bs[2],
                    bs[3]);
      }
    }
    if constexpr ((NT8 & 1) != 0) {
      const uint32_t ba = b_lane + 2 * s * US + (NT8 - 1) * 8 * 16;
      uint32_t b0, b1, bs0 = 0, bs1 = 0;
      ldsm_x2(ba, b0, b1);
      if constexpr (kTf32<E>) ldsm_x2(ba + SMALL, bs0, bs1);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_step<E>(d[i * NT8 + NT8 - 1], a[i], as[i], b0, b1, bs0, bs1);
    }
  }
}

// acc += the chunk's products (gather_steps).  float32 sums them in fresh
// accumulators, added to acc once at the end: the tensor cores' float32
// sums are not rounded to nearest, so a long run drifts (with one
// accumulator over all chunks the dgrad missed the float64 run by 1.15e-5
// of max-abs on the H100, PERF.md); no accumulator runs longer than one
// chunk (at most 18 k-steps, 54 mmas) and the chunks add in float32.
template <int NT8, typename E, int MT, typename Acc, class ARow>
__device__ __forceinline__ void gather_mma(Acc (&acc)[MT * NT8][4],
                                           int n_units, uint32_t ws,
                                           ARow a_row) {
  if constexpr (kTf32<E>) {
    float part[MT * NT8][4] = {};
    gather_steps<NT8, E, MT>(part, n_units, ws, a_row);
#pragma unroll
    for (int j = 0; j < MT * NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  } else {
    gather_steps<NT8, E, MT>(acc, n_units, ws, a_row);
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

// Start the copy of a chunk's weights: ws[u = g * NTAP + i][o] (16 bytes,
// one group of reduced channels) = wp[gbase + g][G::tap(i)][o0 + o] of the
// packed weights [groups][9][n_out][16 bytes] (ops/kernels/tc_pack.py),
// zero for o0 + o >= n_out; unit NTAP * groups (the pad of an odd count)
// zero.  PLANES = 2 (float32): the small plane, `plane` 16-byte units
// after the big one in wp, goes GM_UNITS units after it in ws.
// Asynchronous: the caller waits (cp_async_wait_all) and synchronises
// before reading.
template <int BN, class G, int PLANES>
__device__ __forceinline__ void stage_weights_tc(unsigned char* ws,
                                                 const void* wp,
                                                 size_t plane, int n_out,
                                                 int o0, int gbase,
                                                 int groups) {
  constexpr int US = unit_bytes(BN);
  const uint4* w16 = static_cast<const uint4*>(wp);
  const uint32_t ws_s = smem_addr(ws);
  const int per = groups * G::NTAP * BN;
  for (int i = threadIdx.x; i < PLANES * per; i += GM_THREADS) {
    const int pl = PLANES > 1 ? i / per : 0;
    const int k = i - pl * per;
    const int u = k / BN;
    const int o = k - u * BN;
    const int g = u / G::NTAP;
    const int tap = G::tap(u - g * G::NTAP);
    const bool ok = o0 + o < n_out;
    cp_async16(ws_s + (pl * GM_UNITS + u) * US + o * 16,
               w16 + pl * plane + ((size_t)(gbase + g) * 9 + tap) * n_out +
                   (ok ? o0 + o : 0),
               ok);
  }
  if ((groups * G::NTAP) & 1) {
    for (int i = threadIdx.x; i < PLANES * BN; i += GM_THREADS) {
      const int pl = i / BN;
      reinterpret_cast<uint4*>(
          ws + (pl * GM_UNITS + groups * G::NTAP) * US)[i - pl * BN] =
          make_uint4(0, 0, 0, 0);
    }
  }
}

// Stage a window of the reduced tensor channels-last, in elements E
// (float32, 4 a group, stored as loaded; bf16, 8 a group; or int8, 16 a
// group): window position i = (wr, wc) of rows x
// sw is plane position (t0 - 1 + wr, lo + wc); its group g (< groups <=
// GMAX) holds channels EPG g .. EPG g + EPG - 1 of the chunk, load(k,
// plane index) for k < rk and zero past rk or outside the plane (int8:
// load returns the quantized integer as a float), written as one 16-byte
// store at win + i * row_bytes + 16 g.  A thread takes one position and
// all its groups (decoded once, the groups' loads independent of each
// other), consecutive threads consecutive positions, so each load is
// coalesced.
template <int THREADS, typename E = __nv_bfloat16, class Load>
__device__ __forceinline__ void stage_window(unsigned char* win,
                                             int row_bytes, int rows, int sw,
                                             int t0, int lo, int T, int F,
                                             int groups, int rk, Load load) {
  constexpr int EPG = GROUP_BYTES / sizeof(E);
  const int n_win = rows * sw;
  for (int pos = threadIdx.x; pos < n_win; pos += THREADS) {
    const int wr = pos / sw;
    const int ts = t0 - 1 + wr;
    const int fs = lo + pos - wr * sw;
    const bool in = ts >= 0 && ts < T && fs >= 0 && fs < F;
    const int p = ts * F + fs;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= groups) break;
      float v[EPG];
#pragma unroll
      for (int e = 0; e < EPG; ++e)
        v[e] = (in && EPG * g + e < rk) ? load(EPG * g + e, p) : 0.f;
      uint4 q;
      if constexpr (EPG == 4) {
        q = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                       __float_as_uint(v[2]), __float_as_uint(v[3]));
      } else if constexpr (EPG == 8) {
        q = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else {
        q = make_uint4(pack_s8(v[0], v[1], v[2], v[3]),
                       pack_s8(v[4], v[5], v[6], v[7]),
                       pack_s8(v[8], v[9], v[10], v[11]),
                       pack_s8(v[12], v[13], v[14], v[15]));
      }
      *reinterpret_cast<uint4*>(win + pos * row_bytes + g * GROUP_BYTES) = q;
    }
  }
}

// One chunk of a gather conv over geometry G: the block's tile has tile_w
// = tw columns from output column f0 and tile_h(., MT) rows from t0 of its
// plane (MT m16 fragments a warp, see gather_steps); the
// chunk is `groups` groups of the packed weights wp from group gbase
// (n_out output channels, the block's from o0; float32: the big plane,
// the small one `plane` 16-byte units after it) and `rk` channels of the
// source plane T x F, read through load(k, plane index) (see
// stage_window).  Stages both (synchronising before, so the previous
// chunk's or nothing's reads are done) and adds the chunk's products to
// acc.
template <class G, int NT8, typename E, int MT = 1, typename Acc,
          class Load>
__device__ __forceinline__ void gather_chunk(Acc (&acc)[MT * NT8][4],
                                             unsigned char* smem, int tw,
                                             int t0, int f0, const void* wp,
                                             size_t plane, int n_out, int o0,
                                             int gbase, int groups, int rk,
                                             int T, int F, Load load) {
  constexpr int BN = 8 * NT8;
  const int th = MT * GM_POS / tw;
  const int sw = G::width(tw);
  const int n_win = (th + 2) * sw;
  const int lo = G::lo(f0);
  unsigned char* ws = smem;
  unsigned char* win = smem + kPlanes<E> * GM_UNITS * unit_bytes(BN);
  __syncthreads();  // the previous chunk is consumed
  for (int i = threadIdx.x; i < WIN_ROW / 16; i += GM_THREADS)
    reinterpret_cast<uint4*>(win + n_win * WIN_ROW)[i] =
        make_uint4(0, 0, 0, 0);
  stage_weights_tc<BN, G, kPlanes<E>>(ws, wp, plane, n_out, o0, gbase,
                                      groups);
  stage_window<GM_THREADS, E>(win, WIN_ROW, th + 2, sw, t0, lo, T, F,
                              groups, rk, load);
  cp_async_wait_all();
  __syncthreads();
  const uint32_t win_s = smem_addr(win);
  const uint32_t zero_s = win_s + n_win * WIN_ROW;
  const int lane = threadIdx.x & 31;
  // this lane's A row of fragment 0: position m of the tile; fragment i
  // is GM_POS positions (GM_POS / tw tile rows) further on
  const int m = (threadIdx.x >> 5) * 16 + (lane & 15);
  const int mr = m / tw;
  const int mf = f0 + m - mr * tw;
  const int n_units = groups * G::NTAP;
  gather_mma<NT8, E, MT>(
      acc, n_units, smem_addr(ws), [&](int u, int i) -> uint32_t {
        if (u >= n_units) return zero_s;
        const int g = u / G::NTAP;
        const int tap = G::tap(u - G::NTAP * g);
        const int kt = tap / 3;
        const int col = G::col(mf, tap - 3 * kt, lo);
        if (G::SKIP && col < 0) return zero_s;  // a tap of the other parity
        const int row = mr + i * (GM_POS / tw) + 1 + G::TS * (kt - 1);
        return win_s + (row * sw + col) * WIN_ROW + g * GROUP_BYTES;
      });
}

// The epilogue goes through shared memory: stage_acc writes the warps'
// accumulators as zt[channel][position] (float, rows z_row(MT) apart: the
// fragment stores of a warp fall in distinct banks; an int32 sum as its
// bits, which the int8 epilogue reads back with __float_as_int), and
// finish_tile walks them with the tile's positions along the lanes, so the
// loads and stores of the NCHW planes it does (through fn) are coalesced
// (tw must be 8 or 16, tile_w's widths).

__device__ __forceinline__ float z_bits(float v) { return v; }
__device__ __forceinline__ float z_bits(int v) { return __int_as_float(v); }

// fn(o, m, sum) for each sum of this thread's accumulators (the mma's
// fragment layout): output channel o of the block's BN, tile position m
// (0 .. MT * GM_POS - 1; fragment i holds i * GM_POS + 16 warp + 0 .. 15).
template <int NT8, int MT, typename Acc, class Fn>
__device__ __forceinline__ void for_each_acc(Acc (&acc)[MT * NT8][4],
                                             Fn fn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fn(8 * j + 2 * (lane & 3) + e,
             i * GM_POS + warp * 16 + (lane >> 2) + 8 * h,
             acc[i * NT8 + j][2 * h + e]);
}

template <int NT8, int MT, typename Acc>
__device__ __forceinline__ void stage_acc(float* zt,
                                          const Acc (&acc)[MT * NT8][4]) {
  for_each_acc<NT8, MT>(acc, [&](int o, int m, Acc v) {
    zt[o * z_row(MT) + m] = z_bits(v);
  });
}

// fn(o, tile row, tile column, z) finishes output channel o0 + o at one
// position of the tile and returns its (sum, sum of squares) terms, zero
// where it writes no statistics.  A warp takes whole channels, its lanes
// along the positions; with stats, a channel's sums over the tile are
// taken in a fixed order (each lane's 4 positions, then the warp's
// butterfly) and written for o < n_stats as part[(row0 + o) * ntiles +
// tile] and part[(rows + row0 + o) * ntiles + tile].
template <int BN, int MT, class Fn>
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
    for (int c = lane; c < MT * GM_POS; c += 32) {
      const int pr = c >> shift;
      const float2 t = fn(o, pr, c - (pr << shift), zt[o * z_row(MT) + c]);
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

// The epilogue of a gather kernel: its sums through shared memory (the
// weights' bytes, once every warp is done with them) into finish_tile.
template <int NT8, int MT = 1, typename Acc, class Fn>
__device__ __forceinline__ void finish_gather(unsigned char* smem,
                                              const Acc (&acc)[MT * NT8][4],
                                              int tw, bool stats,
                                              int n_stats, float* part,
                                              size_t row0, size_t rows,
                                              int tile, int ntiles, Fn fn) {
  float* zt = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the weights and the window
  stage_acc<NT8, MT>(zt, acc);
  __syncthreads();
  finish_tile<8 * NT8, MT>(zt, tw, stats, n_stats, part, row0, rows, tile,
                           ntiles, fn);
}

// The NT8 (n8 tiles a warp, up to max_nt8; odd counts only with odd) of a
// call with n_out output channels: the fewest blocks' worth of (BN + a
// staging cost of 32 channels), the widest BN on a tie.
inline int pick_nt8(int n_out, int max_nt8 = 12, bool odd = false) {
  const int opts[] = {12, 8, 6, 4, 3, 2, 1};
  int best = 0, best_cost = 1 << 30;
  for (int nt8 : opts) {
    if (nt8 > max_nt8 || (!odd && (nt8 & 1))) continue;
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
