// K9: segment sum into a small segment space,
// out[t, r] = sum over n of values[n, r] * (seg[n] == t), in one fixed order.
//
// Replaces visual_odometry_tpu/ops/pallas/segsum_kernel.py:segment_sum_small
// (body _kernel), which builds a one-hot (block, T) matrix per block and
// contracts it on the MXU because XLA's scatter-add ran on the scalar core.
// The one-hot product is not kept, nor a table per CTA, nor any atomic.
//
// Inputs: values (N, R) float32 row-major, any R; a plan of the segment ids
// (ops/kernels/segsum_kernel.plan_segments): order (N,) int32, the rows whose
// id lies in [0, T) stably sorted by id, and offsets (T + 1,) int32, segment t
// being order[offsets[t] .. offsets[t + 1]). Rows whose id lies outside
// [0, T) are not in any segment and add nothing, as in the TPU kernel. The
// ids of a bundle adjustment are fixed for the whole run, so the plan is made
// once and every launch reuses it. out (T, R), every entry written.
//
// The order of the sum, which the plain version repeats: one warp owns one
// segment and a group of up to 4 columns. Lane l adds the rows at ranks l,
// l + 32, l + 64, ... of its segment, serially from 0.0f in ascending rank;
// then the 32 lane partials meet in a shuffle-down tree (offsets 16, 8, 4, 2,
// 1) and lane 0 writes the sum. Two launches on the same input give the same
// bits, and the plain version gives them too.
//
// Bound on this card: bytes, 4 N (R + 1) read once (values and order) and
// 4 T R written. Design: T x ceil(R / 4) warps, the column groups of a
// segment in neighbouring warps of a CTA so that they share the rows' cache
// lines; each lane loads four ranks ahead before it adds them in order, and
// reads a 16-byte group as one float4 where R is a multiple of 4. A segment
// is one warp's serial work, so a segment holding most of N runs at one
// warp's pace; the frames of a bundle adjustment hold similar counts.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // columns a warp owns

template <bool VEC>
__device__ __forceinline__ void load_group(const float* __restrict__ values, long long row, int r,
                                           int c0, int cw, float* v) {
  const float* p = values + row * r + c0;
  if (VEC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = c < cw ? __ldg(p + c) : 0.0f;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ values, const int* __restrict__ order,
                       const int* __restrict__ offsets, float* __restrict__ out, int r, int t,
                       int groups) {
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (gw >= static_cast<long long>(t) * groups) return;
  const int seg = static_cast<int>(gw / groups);
  const int c0 = static_cast<int>(gw % groups) * kCols;
  const int cw = (r - c0) < kCols ? (r - c0) : kCols;
  const int begin = __ldg(offsets + seg), end = __ldg(offsets + seg + 1);

  float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  int p = begin + lane;
  // Four ranks of this lane at a time: loads first, then the adds in rank order.
  for (; p + 96 < end; p += 128) {
    float v[4][kCols];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_group<VEC>(values, __ldg(order + p + 32 * u), r, c0, cw, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = acc[c] + v[u][c];
  }
  for (; p < end; p += 32) {
    float v[kCols];
    load_group<VEC>(values, __ldg(order + p), r, c0, cw, v);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = acc[c] + v[c];
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[c] = acc[c] + __shfl_down_sync(0xffffffffu, acc[c], o);
  }
  if (lane == 0) {
    float* dst = out + static_cast<long long>(seg) * r + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < cw) dst[c] = acc[c];
  }
}

}  // namespace

VO_EXPORT int vo_segment_sum(const float* values, const int* order, const int* offsets, float* out,
                             int r, int t, void* stream) {
  if (r <= 0 || t <= 0) return 0;
  const int groups = (r + kCols - 1) / kCols;
  const long long blocks = (static_cast<long long>(t) * groups + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (r % 4 == 0) && (reinterpret_cast<uintptr_t>(values) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    segment_sum_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        values, order, offsets, out, r, t, groups);
  } else {
    segment_sum_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        values, order, offsets, out, r, t, groups);
  }
  return vo_launch_status();
}
