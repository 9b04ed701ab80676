// K3: batched lane gather, out[f, r, j] = src[f, r, idx[f, r, j]].
//
// Replaces visual_odometry_tpu/ops/pallas/gather_kernel.py:gather_rows (body
// _kernel). The TPU needed a kernel because XLA ran general gathers on its
// scalar core; the Mosaic tile-select decomposition has no reason to exist
// here. Contract: indices are pre-sanitized to [0, S) by the caller (the
// pipeline replaces invalid correspondence lanes by 0 first); the kernel does
// not bound-check them.
//
// Bound on this card: device-memory bandwidth, 12 bytes moved per output
// element (index, source, output); one thread per output element with
// coalesced index and output accesses, the source reads are scattered within
// one (S,) row and hit L1/L2.
#include "common.cuh"

__global__ void gather_rows_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                                   float* __restrict__ out, long long total, int s) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = e / s;
    out[e] = src[row * s + idx[e]];
  }
}

VO_EXPORT int vo_gather_rows(const float* src, const int* idx, float* out, long long rows, int s,
                             void* stream) {
  const long long total = rows * s;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  gather_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(src, idx, out, total, s);
  return vo_launch_status();
}
