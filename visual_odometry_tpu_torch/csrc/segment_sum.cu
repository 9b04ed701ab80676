// K9: segment sum into a small segment space,
// out[t, r] = sum over n of values[n, r] * (seg[n] == t).
//
// Replaces visual_odometry_tpu/ops/pallas/segsum_kernel.py:segment_sum_small
// (body _kernel), which builds a one-hot (block, T) matrix per block and
// contracts it on the MXU because XLA's scatter-add ran on the scalar core.
// The one-hot product is not kept: values (N, R) float32 row-major, seg (N,)
// int32, T <= 1024 segments (the cameras of a bundle adjustment); rows whose
// id lies outside [0, T) add nothing, as in the TPU kernel. out (T, R) must
// come zeroed.
//
// Bound on this card: bytes, 4 N (R + 1) read once and 4 T R written.
// Design: each CTA takes a contiguous block of rows and adds them into a
// (T, R_tile) table in shared memory with shared-memory atomics, walking the
// block's elements in memory order so that the loads coalesce; then it adds
// the table's non-zero entries into the output with global atomics. The
// table's width R_tile is the most columns that fit the 227 KB a CTA may ask
// for (all of them for R = 36 at T <= 1024); wider rows are tiled over
// blockIdx.y. The order in which atomics land is not fixed, so the sums
// differ in their last bits from run to run; the plain version (index_add_
// into T + 1 rows, the last dropped) is held to rtol 2e-5, atol 1e-4.
#include "common.cuh"

#define SEGSUM_MAX_SMEM (227 * 1024)

__global__ void __launch_bounds__(1024)
    segment_sum_kernel(const float* __restrict__ values, const int* __restrict__ seg,
                       float* __restrict__ out, long long n, int r, int t, int r_tile,
                       long long rows_per_cta) {
  extern __shared__ float tab[];  // (t, cw)
  const int c0 = blockIdx.y * r_tile;
  const int cw = (r - c0) < r_tile ? (r - c0) : r_tile;
  const int cells = t * cw;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) tab[e] = 0.0f;
  __syncthreads();

  const long long row0 = blockIdx.x * rows_per_cta;
  const long long row1 = (row0 + rows_per_cta) < n ? (row0 + rows_per_cta) : n;
  const int total = static_cast<int>(row1 - row0) * cw;  // the launcher keeps it below 2^31
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const long long row = row0 + e / cw;
    const int c = e % cw;
    const int sg = seg[row];
    if (sg >= 0 && sg < t) atomicAdd(&tab[sg * cw + c], values[row * r + c0 + c]);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < cells; e += blockDim.x) {
    const float v = tab[e];
    if (v != 0.0f) atomicAdd(&out[(e / cw) * r + c0 + (e % cw)], v);
  }
}

VO_EXPORT int vo_segment_sum(const float* values, const int* seg, float* out, long long n, int r,
                             int t, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (t < 1 || t > 1024) return static_cast<int>(cudaErrorInvalidValue);
  int r_tile = SEGSUM_MAX_SMEM / (static_cast<int>(sizeof(float)) * t);
  if (r_tile > r) r_tile = r;
  const int tiles = (r + r_tile - 1) / r_tile;
  // One CTA of 1024 threads per SM and column tile, at least 1024 rows each.
  const int threads = 1024;
  long long ctas = 132;
  if (ctas * threads > n) ctas = (n + threads - 1) / threads;
  const long long rows_per_cta = (n + ctas - 1) / ctas;
  if (rows_per_cta * r_tile >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  ctas = (n + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = static_cast<size_t>(t) * r_tile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(segment_sum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_sum_kernel<<<dim3(static_cast<unsigned>(ctas), tiles), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(values, seg, out, n, r, t, r_tile,
                                                            rows_per_cta);
  return vo_launch_status();
}
