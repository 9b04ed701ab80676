// K10: gather from a small shared table, out[r, n] = table[r, idx[n]].
//
// Replaces visual_odometry_tpu/ops/pallas/gather_kernel.py:take_table (body
// _tab_kernel, _table_gather). The TPU kernel exists because XLA ran general
// gathers on the scalar core; it pads the table to 8 rows and whole 128-lane
// tiles, takes the indices replicated over 8 sublanes and selects among
// single-vreg gathers. None of that is part of the function and none is kept:
// table (R, T) float32 with R <= 12 and T <= 1024 (the 12 pose rows of a
// bundle adjustment's F <= 1024 cameras, or an (F, 6) vector transposed),
// idx (N,) int32, clipped to [0, T - 1] (the TPU kernel clips to the end of
// its lane-padded table, the same thing at a whole-tile T), out (R, N).
//
// Bound on this card: bytes, 4 N of indices in and 4 R N out; the table (at
// most 48 KB) is read once per CTA from L2. Design: each CTA stages the whole
// table in shared memory once and walks the observations with a grid stride;
// a thread owns observation n, reads idx[n] once and writes R values, each
// store coalesced along n. It is a copy, so it equals the plain version
// (table[:, idx.clamp(0, T - 1)]) exactly.
#include "common.cuh"

__global__ void take_table_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                                  float* __restrict__ out, long long n, int r, int t) {
  extern __shared__ float tab[];  // (r, t)
  for (int e = threadIdx.x; e < r * t; e += blockDim.x) tab[e] = table[e];
  __syncthreads();
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int c = idx[i];
    c = c < 0 ? 0 : (c > t - 1 ? t - 1 : c);
    for (int q = 0; q < r; ++q) out[q * n + i] = tab[q * t + c];
  }
}

VO_EXPORT int vo_take_table(const float* table, const int* idx, float* out, long long n, int r,
                            int t, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (r > 12 || t < 1 || t > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4 * 132) blocks = 4 * 132;  // a few CTAs per SM, each staging the table once
  const size_t smem = static_cast<size_t>(r) * t * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(take_table_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  take_table_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(table, idx, out, n, r, t);
  return vo_launch_status();
}
