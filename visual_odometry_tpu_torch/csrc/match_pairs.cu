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
// Bound on this card: FP32 issue. Per pair 2 * N^2 * D multiply-adds (both
// directions recompute the distance); D = 10 is too thin for tensor cores,
// and TF32 would break the exact radius decisions, so the kernel runs on
// the FP32 pipes. Design: one CTA per pair with both frames' descriptors,
// squared norms and masks in shared memory (2 * N * (D + 1) floats = 90 KB
// at N = 1024, D = 10). Pass 1: a thread per frame-1 row holds its
// descriptor in registers and scans every column in ascending order; pass 2
// does the same per frame-2 column. A strict '<' in ascending order gives the
// first-index tie-break with no atomics; an all-masked row returns index 0
// with 3.4e38, as the TPU kernel's min(where(d <= min, iota, big)) does.
//
// Exactness: both passes evaluate d(i, j) through pair_dist(), whose every
// operation is an explicit round-to-nearest intrinsic, so the two directions
// (and the plain PyTorch version, which sums the products in the same order
// with separate multiplies and adds) see bit-identical distances.
#include "common.cuh"

#define VO_BIG 3.4e38f
#define VO_MAX_D 32

template <int DT>
__device__ __forceinline__ float sq_norm(const float* x, int d) {
  float acc = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int k = 1; k < (DT > 0 ? DT : d); ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  return acc;
}

// d(i, j) for descriptors x (registers) and y (shared memory); multiplication
// commutes bitwise, so pair_dist(a_i, c_j) == pair_dist(c_j, a_i). The clamp
// keeps a NaN as NaN, like torch.clamp_min and jnp.maximum.
template <int DT>
__device__ __forceinline__ float pair_dist(const float* x, const float* y, float x2, float y2,
                                           int d) {
  float dot = __fmul_rn(x[0], y[0]);
#pragma unroll
  for (int k = 1; k < (DT > 0 ? DT : d); ++k) dot = __fadd_rn(dot, __fmul_rn(x[k], y[k]));
  float v = __fsub_rn(__fadd_rn(x2, y2), __fmul_rn(2.0f, dot));
  return v < 0.0f ? 0.0f : v;
}

// DT > 0 fixes the descriptor width at compile time (registers, unrolled
// loops); DT == 0 reads it from d at run time.
template <int DT>
__global__ void match_pairs_kernel(const float* __restrict__ app1, const uint8_t* __restrict__ mask1,
                                   const float* __restrict__ app2, const uint8_t* __restrict__ mask2,
                                   float* __restrict__ best1_d, int* __restrict__ best1,
                                   float* __restrict__ best2_d, int* __restrict__ best2, int n,
                                   int d_rt) {
  const int d = DT > 0 ? DT : d_rt;
  extern __shared__ float smem[];
  float* sa = smem;              // (n, d) frame-1 descriptors
  float* sc = sa + n * d;        // (n, d) frame-2 descriptors
  float* sa2 = sc + n * d;       // (n,) |a|^2
  float* sc2 = sa2 + n;          // (n,) |c|^2
  uint8_t* sm1 = reinterpret_cast<uint8_t*>(sc2 + n);
  uint8_t* sm2 = sm1 + n;

  const long long b = blockIdx.x;
  const float* a = app1 + b * n * d;
  const float* c = app2 + b * n * d;
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    sa[e] = a[e];
    sc[e] = c[e];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sm1[i] = mask1[b * n + i];
    sm2[i] = mask2[b * n + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sa2[i] = sq_norm<DT>(sa + i * d, d);
    sc2[i] = sq_norm<DT>(sc + i * d, d);
  }
  __syncthreads();

  float x[DT > 0 ? DT : VO_MAX_D];
  // Pass 1: per frame-1 row i, the first best frame-2 column (best2).
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    #pragma unroll
    for (int k = 0; k < (DT > 0 ? DT : d); ++k) x[k] = sa[i * d + k];
    const float x2 = sa2[i];
    const bool mi = sm1[i] != 0;
    float best = INFINITY;
    int arg = 0;
    for (int j = 0; j < n; ++j) {
      float v = (mi && sm2[j]) ? pair_dist<DT>(x, sc + j * d, x2, sc2[j], d) : VO_BIG;
      if (v < best) {
        best = v;
        arg = j;
      }
    }
    best2_d[b * n + i] = best;
    best2[b * n + i] = arg;
  }
  // Pass 2: per frame-2 column j, the first best frame-1 row (best1).
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    #pragma unroll
    for (int k = 0; k < (DT > 0 ? DT : d); ++k) x[k] = sc[j * d + k];
    const float x2 = sc2[j];
    const bool mj = sm2[j] != 0;
    float best = INFINITY;
    int arg = 0;
    for (int i = 0; i < n; ++i) {
      float v = (mj && sm1[i]) ? pair_dist<DT>(x, sa + i * d, x2, sa2[i], d) : VO_BIG;
      if (v < best) {
        best = v;
        arg = i;
      }
    }
    best1_d[b * n + j] = best;
    best1[b * n + j] = arg;
  }
}

VO_EXPORT int vo_match_pairs(const float* app1, const uint8_t* mask1, const float* app2,
                             const uint8_t* mask2, float* best1_d, int* best1, float* best2_d,
                             int* best2, int batch, int n, int d, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (d < 1 || d > VO_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = static_cast<size_t>(n) * (2 * d + 2) * sizeof(float) + 2 * static_cast<size_t>(n);
  auto kernel = d == 10 ? match_pairs_kernel<10> : match_pairs_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = n < 1024 ? ((n + 31) / 32) * 32 : 1024;
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      app1, mask1, app2, mask2, best1_d, best1, best2_d, best2, n, d);
  return vo_launch_status();
}

VO_EXPORT const char* vo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
