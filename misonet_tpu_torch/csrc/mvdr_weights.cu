// mvdr_weights: the weights of one MVDR call in one launch on Hopper.
//
// Replaces misonet_tpu/ops/pallas/mvdr_solve.py::hermitian_solve_pallas (its
// Pallas `_solve_kernel`) together with the chain that XLA fused around it in
// misonet_tpu/beamforming/mvdr.py::mvdr_beamform (power-iteration steering,
// reference-mic normalization, phase correction across frequency, the
// diagonally loaded solve, the MVDR normalization).  For every row n of N
// (the flattened leading axes) and bin f of F, from the source SCM rs and the
// noise SCM rn, both complex64 [N, F, M, M], already hermitized:
//
//   v = rs 1, normalized (1/sqrt(M) each where rs 1 = 0); `iters` times:
//       w = rs v; v = w / |w| where |w| > 1e-30, else v unchanged
//   d = v / v[ref];  d = d sqrt(M / |d|)                (norm, not norm^2)
//   s[f] = sum_m d[f,m] conj(d[f-1,m]) from the uncorrected vectors,
//   p[f] = prod_{k <= f} conj(s[k] / |s[k]|) (1 where |s| = 0; p[0] = 1)
//   x = (rn + diag I)^-1 (d p)   (csrc/hermitian_chol.cuh, hermitian_solve's)
//   w = x / ((d p)^H x)
//
// each step as beamforming/mvdr.py does it (principal_eigenvector,
// normalize_steering, phase_correct, mvdr_weights), in float32, with
// PyTorch's complex division (c10::complex, Smith's algorithm).
//
// What bounds it: neither bytes nor operations.  At M = 6 a bin reads 576
// bytes, writes 48 and does ~33 kflop, so the 258 bins of a 12.3 s request
// need ~0.13 us at the card's float32 rate.  The 100 trips of the power
// iteration are a dependent chain (matvec, |w|^2, reciprocal square root,
// scaling), which sets a floor of several microseconds however many SMs
// run.  The eager PyTorch loop this replaces made ~1,000 launches a call;
// one launch is the design's first goal, the chain's latency its pace.
//
// Design.  The phase correction couples the bins of a row, so one thread
// block cluster owns a row: up to kMaxCluster blocks of ~kBinsPerBlock bins
// each on as many SMs (F = 129: 5 blocks of 26 bins), so the rows' and the
// blocks' chains run side by side.
//   1. Each block copies its bins' rs and rn into shared memory with
//      cp.async (a block's bins are one contiguous range; every load in
//      flight at once, where a loop through registers waits on each load in
//      turn), waits for rs only, runs the power iteration and the
//      normalization per bin, and writes the uncorrected d into the output
//      w, which holds it until step 3 overwrites it.
//   2. After a cluster barrier each bin's phasor conj(unit(s[f])) comes from
//      its own and the previous bin's d (read back from L2); one thread
//      scans its block's phasors, and each block's carry is the product of
//      the lower ranks' block products, read from their shared memory
//      (distributed shared memory).
//   3. Each block corrects d, solves and normalizes, rn already in place.
// The power iteration runs on G = 2/4/8 lanes a bin (lanes_steering):
// lane i holds row i of the bin's rs in registers; after each lane's row
// times v the M results go to every lane by shuffles, so each lane
// normalizes the whole vector itself (the same sums in the same order on
// every lane) and no reduction round sits between trips.  One thread a bin
// with the matrix in registers or read from shared memory every trip was
// measured beside it on one H100 at 700 W and is slower at the cascade's
// 2-8 rows of 129 bins, where one warp a block is issue-bound with one
// thread a bin (PERF.md §6).
// Any F >= 1 up to ~130,000 bins (the phasors' shared memory): blocks loop
// over their bins in rounds of at most kMaxThreads / G.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "hermitian_chol.cuh"
#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace misonet {
namespace {

constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kBinsPerBlock = 32;  // bins a block aims for
constexpr int kMaxRows = 6144;     // float2 of a staging buffer: 48 KB
// threads a block: 8 lanes a bin take 264 for F = 257's 33 bins a block
constexpr int kMaxThreads = 512;

template <int M>
__host__ __device__ constexpr int lanes_of() {
  return M <= 2 ? 2 : M <= 4 ? 4 : 8;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// x / b as c10::complex<float>::operator/ computes it (Smith's algorithm),
// with the divisor's ratio and scale prepared once for many x
struct CDiv {
  float2 b;
  float rat, scl;
  bool re_major, zero;
  __device__ __forceinline__ explicit CDiv(float2 d) : b(d) {
    const float ac = fabsf(d.x), ad = fabsf(d.y);
    re_major = ac >= ad;
    zero = ac == 0.f && ad == 0.f;
    rat = re_major ? d.y / d.x : d.x / d.y;
    scl = 1.f / (re_major ? d.x + d.y * rat : d.y + d.x * rat);
  }
  __device__ __forceinline__ float2 operator()(float2 x) const {
    if (zero) return make_float2(x.x / fabsf(b.x), x.y / fabsf(b.y));
    return re_major
        ? make_float2((x.x + x.y * rat) * scl, (x.y - x.x * rat) * scl)
        : make_float2((x.x * rat + x.y) * scl, (x.y * rat - x.x) * scl);
  }
};

// sum of x over each aligned group of G lanes
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// principal_eigenvector + normalize_steering of one bin on G lanes: lane r
// of the group holds row r of the matrix (zeros for r >= M) and returns the
// r-th component of d; every lane of the warp must call it.  A trip: each
// lane's row times v, the M results broadcast by shuffles, and every lane
// normalizes the whole vector itself (the same sums in the same order, so
// the lanes agree bit for bit) -- no reduction round between trips.
template <int M>
__device__ __forceinline__ float2 lanes_steering(const float2 (&row)[M],
                                                 int r, int ref, int iters) {
  constexpr int G = lanes_of<M>();
  const bool live = r < M;
  float2 own = row[0];  // this lane's component of v
#pragma unroll
  for (int j = 1; j < M; ++j)
    own = make_float2(own.x + row[j].x, own.y + row[j].y);
  float2 v[M];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    v[j] = make_float2(__shfl_sync(0xffffffffu, own.x, j, G),
                       __shfl_sync(0xffffffffu, own.y, j, G));
    ss += v[j].x * v[j].x + v[j].y * v[j].y;
  }
  const float nrm = sqrtf(ss);
  const float inv = 1.f / fmaxf(nrm, 1e-30f);
  const float flat = 1.f / sqrtf((float)M);
#pragma unroll
  for (int j = 0; j < M; ++j)
    v[j] = nrm > 0.f ? make_float2(v[j].x * inv, v[j].y * inv)
                     : make_float2(flat, 0.f);
  own = nrm > 0.f ? make_float2(own.x * inv, own.y * inv)
                  : make_float2(live ? flat : 0.f, 0.f);
#pragma unroll 2
  for (int it = 0; it < iters; ++it) {
    float re = 0.f, im = 0.f, re2 = 0.f, im2 = 0.f;
#pragma unroll
    for (int j = 0; j < M; j += 2) {
      re = fmaf(row[j].x, v[j].x, re);
      re = fmaf(-row[j].y, v[j].y, re);
      im = fmaf(row[j].x, v[j].y, im);
      im = fmaf(row[j].y, v[j].x, im);
      if (j + 1 < M) {
        re2 = fmaf(row[j + 1].x, v[j + 1].x, re2);
        re2 = fmaf(-row[j + 1].y, v[j + 1].y, re2);
        im2 = fmaf(row[j + 1].x, v[j + 1].y, im2);
        im2 = fmaf(row[j + 1].y, v[j + 1].x, im2);
      }
    }
    re += re2;
    im += im2;
    float2 s[M];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      s[j] = make_float2(__shfl_sync(0xffffffffu, re, j, G),
                         __shfl_sync(0xffffffffu, im, j, G));
      if (j & 1) s1 = fmaf(s[j].y, s[j].y, fmaf(s[j].x, s[j].x, s1));
      else s0 = fmaf(s[j].y, s[j].y, fmaf(s[j].x, s[j].x, s0));
    }
    const float q = s0 + s1, rq = rsqrtf(q);
    const bool ok = q > 0.f;
#pragma unroll
    for (int j = 0; j < M; ++j)
      v[j] = ok ? make_float2(s[j].x * rq, s[j].y * rq) : v[j];
    own = ok ? make_float2(re * rq, im * rq) : own;
  }
  const CDiv by(make_float2(__shfl_sync(0xffffffffu, own.x, ref, G),
                            __shfl_sync(0xffffffffu, own.y, ref, G)));
  const float2 d = live ? by(own) : make_float2(0.f, 0.f);
  const float g =
      sqrtf((float)M / sqrtf(group_sum<G>(d.x * d.x + d.y * d.y)));
  return make_float2(d.x * g, d.y * g);
}

// k matrices from global (one contiguous range) into rows of stride SR by
// asynchronous copies (cp.async: every load in flight at once, none through
// registers); the caller commits and waits
template <int M>
__device__ __forceinline__ void stage_async(float2* mat, const float2* src,
                                            int k) {
  constexpr int MM = M * M, SR = MM | 1;
  for (int i = threadIdx.x; i < k * MM; i += blockDim.x)
    __pipeline_memcpy_async(mat + (i / MM) * SR + i % MM, src + i,
                            sizeof(float2));
}

// One cluster per row n (blockIdx.x / cluster size); block `rank` of the
// cluster owns bins [rank * bpb, rank * bpb + bpb) of it, `rows` a round.
// With one round (every row of F <= 8 x rows bins) rn is copied in at the
// start, behind the power iteration; else each round of step 3 copies it.
template <int M>
__global__ void __launch_bounds__(kMaxThreads)
mvdr_weights_kernel(const float2* __restrict__ rs,
                    const float2* __restrict__ rn, float2* w, int nf,
                    int bpb, int rows, int ref, float diag, int iters) {
  constexpr int MM = M * M, SR = MM | 1, G = lanes_of<M>();
  extern __shared__ float2 smem[];
  float2* ms = smem;                // rows x SR: a round's rs
  float2* mn = smem + rows * SR;    // rows x SR: a round's rn
  float2* ph = mn + rows * SR;      // bpb: phasors, then their prefix
  __shared__ float2 agg, carry;     // the block's product; lower ranks'
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long row = (long long)(blockIdx.x / cluster.dim_blocks().x) * nf;
  const int f0 = rank * bpb;
  const int cnt = min(bpb, nf - f0);
  const bool one_round = cnt <= rows;
  const int t = threadIdx.x;

  // 1. steering: d (uncorrected) into w
  for (int base = 0; base < cnt; base += rows) {
    const int k = min(rows, cnt - base);
    const long long b0 = row + f0 + base;
    __syncthreads();
    stage_async<M>(ms, rs + b0 * MM, k);
    __pipeline_commit();
    if (one_round) stage_async<M>(mn, rn + b0 * MM, k);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // rs is in; rn may still be on its way
    __syncthreads();
    const int bin = t / G, r = t % G;
    const bool live = bin < k && r < M;
    float2 rowv[M];
#pragma unroll
    for (int j = 0; j < M; ++j)
      rowv[j] = live ? ms[bin * SR + r * M + j] : make_float2(0.f, 0.f);
    const float2 d = lanes_steering<M>(rowv, r, ref, iters);
    if (live) w[(b0 + bin) * M + r] = d;
  }
  // the cluster barrier releases the block's writes of d and acquires the
  // others' (cluster scope); they are read back past L1 (ld.global.cg)
  cluster.sync();

  // 2. phasors conj(unit(s[f])), their prefix in the block, the carry
  for (int i = t; i < cnt; i += blockDim.x) {
    const int f = f0 + i;
    float2 u = make_float2(1.f, 0.f);
    if (f > 0) {
      const float2* dc = w + (row + f) * M;
      float2 s = cmul(__ldcg(dc), conjf2(__ldcg(dc - M)));
#pragma unroll
      for (int j = 1; j < M; ++j) {
        const float2 p = cmul(__ldcg(dc + j), conjf2(__ldcg(dc - M + j)));
        s = make_float2(s.x + p.x, s.y + p.y);
      }
      const float mag = hypotf(s.x, s.y);
      const float inv = 1.f / fmaxf(mag, 1e-30f);
      if (mag > 0.f) u = make_float2(s.x * inv, s.y * inv);
    }
    ph[i] = conjf2(u);
  }
  __syncthreads();
  if (t == 0) {
    float2 p = ph[0];
    for (int i = 1; i < cnt; ++i) ph[i] = p = cmul(p, ph[i]);
    agg = p;
  }
  cluster.sync();
  if (t == 0) {
    float2 c = make_float2(1.f, 0.f);
    for (int r = 0; r < rank; ++r) c = cmul(c, *cluster.map_shared_rank(&agg, r));
    carry = c;
  }
  cluster.sync();  // also: no block leaves while another reads its agg

  // 3. correct d, solve (rn + diag I) x = d, w = x / (d^H x)
  const float2 cy = carry;
  for (int base = 0; base < cnt; base += rows) {
    const int k = min(rows, cnt - base);
    const long long b0 = row + f0 + base;
    if (!one_round) {
      __syncthreads();
      stage_async<M>(mn, rn + b0 * MM, k);
      __pipeline_commit();
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    if (t < k) {
      const float2 p = cmul(cy, ph[base + t]);
      float2* out = w + (b0 + t) * M;
      float2 d[M], x[M];
#pragma unroll
      for (int j = 0; j < M; ++j) d[j] = cmul(__ldcg(out + j), p);
      hermitian_chol_solve<M>(mn + t * SR, d, diag, x);
      float2 den = cmul(conjf2(d[0]), x[0]);
#pragma unroll
      for (int j = 1; j < M; ++j) {
        const float2 q = cmul(conjf2(d[j]), x[j]);
        den = make_float2(den.x + q.x, den.y + q.y);
      }
      const CDiv by(den);
#pragma unroll
      for (int j = 0; j < M; ++j) out[j] = by(x[j]);
    }
  }
}

// A row's cluster: cl blocks of bpb bins, every block at least one bin
struct RowSplit {
  int cl, bpb;
  explicit RowSplit(int nf) {
    cl = max(1, min(kMaxCluster, (nf + kBinsPerBlock - 1) / kBinsPerBlock));
    bpb = (nf + cl - 1) / cl;
    cl = (nf + bpb - 1) / bpb;
  }
};

template <int M>
cudaError_t launch(const float2* rs, const float2* rn, float2* w,
                   long long n, int nf, int ref, float diag, int iters,
                   cudaStream_t st) {
  constexpr int SR = (M * M) | 1, G = lanes_of<M>();
  const RowSplit split(nf);
  const int cl = split.cl, bpb = split.bpb;
  // rows a round: G lanes a bin, both buffers within the
  // card's 227 KB of shared memory
  const int rows = min(min(bpb, kMaxThreads / G), kMaxRows / SR);
  const int threads = (rows * G + 31) / 32 * 32;
  const size_t smem = ((size_t)2 * rows * SR + bpb) * sizeof(float2);
  if (n * cl > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* kernel = mvdr_weights_kernel<M>;
  static SmemLimit limit;
  if (const cudaError_t e = limit.raise(kernel); e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cl));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, rs, rn, w, nf, bpb,
                                           rows, ref, diag, iters);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
}  // namespace misonet

// C entry point.  rs, rn complex64 [n, f, m, m] (float2 pairs), contiguous,
// hermitized, on the current device; w complex64 [n, f, m] (output).
// Returns the launch's CUDA error (0 on success; a launch the card refuses,
// f beyond ~130,000, its error); m outside 2..8, f < 1, ref outside
// 0..m-1 or iters < 0 return cudaErrorInvalidValue; n = 0 launches nothing.
extern "C" int misonet_mvdr_weights(int m, const void* rs, const void* rn,
                                    void* w, long long n, int f, int ref,
                                    float diag, int iters, void* stream) {
  using namespace misonet;
  if (n <= 0) return 0;
  if (f < 1 || ref < 0 || ref >= m || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float2*>(rs);
  const auto* b = static_cast<const float2*>(rn);
  auto* out = static_cast<float2*>(w);
  switch (m) {
    case 2: return (int)launch<2>(a, b, out, n, f, ref, diag, iters, st);
    case 3: return (int)launch<3>(a, b, out, n, f, ref, diag, iters, st);
    case 4: return (int)launch<4>(a, b, out, n, f, ref, diag, iters, st);
    case 5: return (int)launch<5>(a, b, out, n, f, ref, diag, iters, st);
    case 6: return (int)launch<6>(a, b, out, n, f, ref, diag, iters, st);
    case 7: return (int)launch<7>(a, b, out, n, f, ref, diag, iters, st);
    case 8: return (int)launch<8>(a, b, out, n, f, ref, diag, iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
