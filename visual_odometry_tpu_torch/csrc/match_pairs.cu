// K1: both-direction top-1 appearance matches for a batch of frame pairs.
//
// Replaces visual_odometry_tpu/ops/pallas/matcher_kernel.py:match_pairs_pallas
// (body _pairs_kernel). For pair b, with a = frame-1 descriptors (N, D) and
// c = frame-2 descriptors (N, D):
//   d(i, j) = max((|a_i|^2 + |c_j|^2) - 2 * dot(a_i, c_j), 0), or 3.4e38 where
//             either slot is masked (selected BEFORE any comparison, so NaN
//             garbage in padded slots never changes a match);
//   best1[j] = first argmin_i d(i, j)   (per frame-2 point, best frame-1 row)
//   best2[i] = first argmin_j d(i, j)   (per frame-1 point, best frame-2 column)
// The (N, N) distances never reach device memory.
//
// Bound on this card: FP32 issue. Every distance is 2 D - 1 separately
// rounded multiplies and adds (the exactness below forbids fused multiply-
// adds, so they issue at half the FMA rate), 3 more to form it, and a clamp
// and a compare-and-select to rank it; D = 10 is too thin for tensor cores,
// and TF32 would break the exact radius decisions. Each direction computes
// its own distances, so a pair costs 2 N^2 of them.
//
// Design: a CTA takes one direction of one pair and a tile of 128 "rows" (the
// frame whose best match it finds); the pair's 2 x ceil(N / 128) CTAs spread
// one pair over 16 SMs at N = 1024, and a batch of pairs runs in even waves.
// The CTA stages the other frame's N "columns" in shared memory as records
// of 12 floats (10 descriptor floats, the squared norm, the mask), read as
// three float4 broadcasts. Lane l of warp w holds rows l, l + 32, l + 64,
// l + 96 of the tile in registers and scans column split w (an eighth of the
// columns, ascending) against all four: three shared loads serve four
// distances. The eight splits' (distance, index) pairs of a row then meet
// in ascending split order. A strict '<' in ascending order within a split
// and across splits gives the first index on ties, with no atomics; a split
// that found nothing keeps (inf, 0), so an all-masked row returns index 0
// with 3.4e38, as the TPU kernel's min(where(d <= min, iota, big)) does.
// Masked columns skip the arithmetic (the branch is the same for the whole
// warp), and a masked row's result is (3.4e38, 0) whatever its descriptors.
//
// Exactness: every distance goes through pair_dist(), whose every operation
// is an explicit round-to-nearest intrinsic, in descriptor order, so the two
// directions (and the plain PyTorch version, which sums the products in the
// same order with separate multiplies and adds) see bit-identical distances.
// The clamp is max.NaN: it keeps a NaN as NaN, like torch.clamp_min, and the
// distance is never -0.0 (the squared norms are +0.0 or more).
#include "common.cuh"

#define VO_BIG 3.4e38f
#define VO_MAX_D 32

namespace {

constexpr int kThreads = 256;
constexpr int kSplits = kThreads / 32;  // column splits, one a warp

template <int DT>
__device__ __forceinline__ float sq_norm(const float* x, int d) {
  float acc = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int k = 1; k < (DT > 0 ? DT : d); ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  return acc;
}

__device__ __forceinline__ float clamp0(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(0.0f));
  return r;
}

// d(i, j) for descriptors x and y (both registers); multiplication commutes
// bitwise, so pair_dist(a_i, c_j) == pair_dist(c_j, a_i).
template <int DT>
__device__ __forceinline__ float pair_dist(const float* x, const float* y, float x2, float y2,
                                           int d) {
  float dot = __fmul_rn(x[0], y[0]);
#pragma unroll
  for (int k = 1; k < (DT > 0 ? DT : d); ++k) dot = __fadd_rn(dot, __fmul_rn(x[k], y[k]));
  return clamp0(__fsub_rn(__fadd_rn(x2, y2), __fmul_rn(2.0f, dot)));
}

// DT > 0 fixes the descriptor width at compile time (registers, unrolled
// loops) and RB = 4 rows a lane; DT == 0 reads it from d at run time, one
// row a lane.
template <int DT, int RB>
__global__ void __launch_bounds__(kThreads)
    match_pairs_kernel(const float* __restrict__ app1, const uint8_t* __restrict__ mask1,
                       const float* __restrict__ app2, const uint8_t* __restrict__ mask2,
                       float* __restrict__ best1_d, int* __restrict__ best1,
                       float* __restrict__ best2_d, int* __restrict__ best2, int n, int d_rt,
                       int tiles) {
  constexpr int DMAX = DT > 0 ? DT : VO_MAX_D;
  constexpr int DSMAX = ((DMAX + 2 + 3) / 4) * 4;
  const int d = DT > 0 ? DT : d_rt;
  const int ds = ((d + 2 + 3) / 4) * 4;  // floats a staged column record
  extern __shared__ float4 smem4[];
  float* col = reinterpret_cast<float*>(smem4);            // (n, ds)
  float* part_d = col + static_cast<size_t>(n) * ds;       // (kSplits, RB * 32)
  int* part_i = reinterpret_cast<int*>(part_d + kSplits * RB * 32);

  // This CTA's pair, direction and row tile. Direction 0: rows are frame 1,
  // the result is best2; direction 1: rows are frame 2, the result is best1.
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const long long rest = blockIdx.x / tiles;
  const int dir = static_cast<int>(rest & 1);
  const long long b = rest >> 1;
  const float* rows = (dir == 0 ? app1 : app2) + b * n * d;
  const uint8_t* rmask = (dir == 0 ? mask1 : mask2) + b * n;
  const float* cols = (dir == 0 ? app2 : app1) + b * n * d;
  const uint8_t* cmask = (dir == 0 ? mask2 : mask1) + b * n;
  float* out_d = (dir == 0 ? best2_d : best1_d) + b * n;
  int* out_i = (dir == 0 ? best2 : best1) + b * n;

  for (int e = threadIdx.x; e < n; e += kThreads) {
    float y[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (DT > 0 || k < d) y[k] = __ldg(cols + static_cast<long long>(e) * d + k);
    float* rec = col + static_cast<size_t>(e) * ds;
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (DT > 0 || k < d) rec[k] = y[k];
    rec[d] = sq_norm<DT>(y, d);
    rec[d + 1] = __ldg(cmask + e) ? 1.0f : 0.0f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = tile * RB * 32;
  float x[RB][DMAX], x2[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int i = row0 + lane + 32 * k;
    const int ic = i < n ? i : n - 1;
#pragma unroll
    for (int q = 0; q < DMAX; ++q)
      if (DT > 0 || q < d) x[k][q] = __ldg(rows + static_cast<long long>(ic) * d + q);
    x2[k] = sq_norm<DT>(x[k], d);
  }
  __syncthreads();

  const int chunk = (n + kSplits - 1) / kSplits;
  const int j0 = warp * chunk;
  const int j1 = (j0 + chunk) < n ? (j0 + chunk) : n;
  float best[RB];
  int arg[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    best[k] = INFINITY;
    arg[k] = 0;
  }
  for (int j = j0; j < j1; ++j) {
    float y[DSMAX];
    const float4* rec = reinterpret_cast<const float4*>(col + static_cast<size_t>(j) * ds);
#pragma unroll
    for (int q = 0; q < DSMAX / 4; ++q) {
      if (DT > 0 || 4 * q < ds) {
        const float4 v = rec[q];
        y[4 * q] = v.x;
        y[4 * q + 1] = v.y;
        y[4 * q + 2] = v.z;
        y[4 * q + 3] = v.w;
      }
    }
    const float y2 = DT > 0 ? y[DT] : col[static_cast<size_t>(j) * ds + d];
    const bool cok = (DT > 0 ? y[DT + 1] : col[static_cast<size_t>(j) * ds + d + 1]) != 0.0f;
    if (cok) {
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const float v = pair_dist<DT>(x[k], y, x2[k], y2, d);
        if (v < best[k]) {
          best[k] = v;
          arg[k] = j;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        if (VO_BIG < best[k]) {
          best[k] = VO_BIG;
          arg[k] = j;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    part_d[warp * RB * 32 + lane + 32 * k] = best[k];
    part_i[warp * RB * 32 + lane + 32 * k] = arg[k];
  }
  __syncthreads();

  // The splits of a row in ascending column order, first index on ties.
  for (int t = threadIdx.x; t < RB * 32; t += kThreads) {
    const int i = row0 + t;
    if (i >= n) continue;
    float bd = part_d[t];
    int bi = part_i[t];
    for (int w = 1; w < kSplits; ++w) {
      const float v = part_d[w * RB * 32 + t];
      if (v < bd) {
        bd = v;
        bi = part_i[w * RB * 32 + t];
      }
    }
    if (!__ldg(rmask + i)) {
      bd = VO_BIG;
      bi = 0;
    }
    out_d[i] = bd;
    out_i[i] = bi;
  }
}

template <int DT, int RB>
int launch_match_pairs(const float* app1, const uint8_t* mask1, const float* app2,
                       const uint8_t* mask2, float* best1_d, int* best1, float* best2_d,
                       int* best2, int batch, int n, int d, cudaStream_t stream) {
  const int ds = ((d + 2 + 3) / 4) * 4;
  const size_t smem = static_cast<size_t>(n) * ds * sizeof(float) +
                      static_cast<size_t>(kSplits) * RB * 32 * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(match_pairs_kernel<DT, RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + RB * 32 - 1) / (RB * 32);
  const long long blocks = static_cast<long long>(batch) * 2 * tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  match_pairs_kernel<DT, RB><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      app1, mask1, app2, mask2, best1_d, best1, best2_d, best2, n, d, tiles);
  return vo_launch_status();
}

}  // namespace

VO_EXPORT int vo_match_pairs(const float* app1, const uint8_t* mask1, const float* app2,
                             const uint8_t* mask2, float* best1_d, int* best1, float* best2_d,
                             int* best2, int batch, int n, int d, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (d < 1 || d > VO_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 10)
    return launch_match_pairs<10, 4>(app1, mask1, app2, mask2, best1_d, best1, best2_d, best2,
                                     batch, n, d, st);
  return launch_match_pairs<0, 1>(app1, mask1, app2, mask2, best1_d, best1, best2_d, best2, batch,
                                  n, d, st);
}

VO_EXPORT const char* vo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
