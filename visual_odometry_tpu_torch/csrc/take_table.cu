// K10: gather from a small shared table, out[q, n] = table[q, clamp(idx[n], 0, T - 1)].
//
// Replaces visual_odometry_tpu/ops/pallas/gather_kernel.py:take_table (body
// _tab_kernel, _table_gather). The TPU kernel exists because XLA ran general
// gathers on the scalar core; it pads the table to 8 rows and whole 128-lane
// tiles, takes the indices replicated over 8 sublanes and selects among
// single-vreg gathers. None of that is part of the function and none is kept:
// table (R, T) float32 with R <= 12 and any T (the 12 pose rows of a
// bundle adjustment's F cameras, or an (F, 6) vector), read through
// its two strides so that the transpose of an (F, R) tensor needs no copy;
// idx (N,) int32, clipped to [0, T - 1] (the TPU kernel clips to the end of
// its lane-padded table, the same thing at a whole-tile T); out (R, N), or
// its transpose (N, R) when the consumer reads records (TRANSPOSED).
//
// Bound on this card: bytes, 4 N of indices in and 4 R N out; the table
// (48 B a column) is read in place through the read-only cache. Design: a warp
// owns 32 observations; lane l reads idx[n0 + l] once. (R, N): lane l writes
// its R values, each store coalesced along n. (N, R): the warp's 32 records
// are 32 R contiguous floats; element e = l + 32 k takes its index from lane
// e / R by a shuffle, (e / R, e % R) stepped without a division, so every
// store is coalesced too. No shared memory and no cudaFuncSetAttribute. A
// copy: it equals the plain version exactly.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool TRANSPOSED>
__global__ void take_table_kernel(const float* __restrict__ table, long long st_r,
                                  long long st_t, const int* __restrict__ idx,
                                  float* __restrict__ out, long long n, int r, int t) {
  const int lane = threadIdx.x & 31;
  const long long n0 = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  const long long i = n0 + lane;
  int c = i < n ? __ldg(idx + i) : 0;
  c = c < 0 ? 0 : (c > t - 1 ? t - 1 : c);
  auto value = [&](int q, int col) { return __ldg(table + q * st_r + col * st_t); };
  if (!TRANSPOSED) {
    if (i < n) {
      for (int q = 0; q < r; ++q) out[q * n + i] = value(q, c);
    }
  } else {
    const int step_n = 32 / r, step_q = 32 - step_n * r;  // 32 = step_n r + step_q
    int m = lane / r, q = lane - m * r;                    // element lane + 32 k = m r + q
    float* o = out + n0 * r + lane;
    for (int k = 0; k < r; ++k) {
      const int cm = __shfl_sync(0xffffffffu, c, m);
      if (n0 + m < n) o[32 * k] = value(q, cm);
      m += step_n;
      q += step_q;
      if (q >= r) {
        q -= r;
        ++m;
      }
    }
  }
}

}  // namespace

VO_EXPORT int vo_take_table(const float* table, long long st_r, long long st_t, const int* idx,
                            float* out, long long n, int r, int t, int transposed, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (r > 12 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (transposed) {
    take_table_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        table, st_r, st_t, idx, out, n, r, t);
  } else {
    take_table_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        table, st_r, st_t, idx, out, n, r, t);
  }
  return vo_launch_status();
}
