// K3: lane gather of records, out[g, j, :] = src[g, clamp(idx[g, j], 0, S - 1), :].
//
// Replaces visual_odometry_tpu/ops/pallas/gather_kernel.py:gather_rows (body
// _kernel) for the one case every caller has: the D rows of a record (a
// point's 2 coordinates, an appearance's 10 values) share one index row. The
// TPU kernel takes them as (F, R, S) rows with the index repeated R times,
// because XLA ran general gathers on its scalar core and Mosaic gathers along
// lanes; here the records stay in the (F, S, D) layout the pipeline holds,
// and the caller gets (F, S, D) back with no stack or transpose around it.
//
// Frames: g runs over B sequences of F frames; frame (b, f) of the source
// starts at b * seq_stride + f * frame_stride floats, so a strided slice of
// a (B, F', S, D) batch is read in place. idx and out are contiguous.
//
// Bound on this card: bytes, 4 S D in, 4 S D out and 4 S of index a frame.
// Design: a frame axis in the grid (blockIdx.x), so no 64-bit division per
// element. A record is P values of type V and a thread moves one value: for
// the pipeline's D = 2 and D = 10, V is float2 and P = D / 2 a template
// constant (e / P is a multiply), so a warp's stores are 256 contiguous bytes
// and the P threads of a record read its index from one L1 line. Any other D,
// or a source that is not 8-byte aligned with even strides, takes V = float
// and P = D at run time. Each thread takes kPerThread outputs a block-width
// apart, for loads in flight. Indices are clipped, so a bad one cannot read
// outside its frame. A copy: it equals the plain version (torch.gather on the
// clipped index) exactly.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;

template <typename V, int P>  // P == 0: p values a record, given at run time
__global__ void gather_rows_kernel(const V* __restrict__ src, const int* __restrict__ idx,
                                   V* __restrict__ out, int frames, int s, int p_run,
                                   long long seq_stride, long long frame_stride) {
  const int p = P > 0 ? P : p_run;
  const int g = blockIdx.x;
  const int b = g / frames;
  const V* sf = src + b * seq_stride + (g - b * frames) * frame_stride;
  const int* ix = idx + static_cast<long long>(g) * s;
  V* of = out + static_cast<long long>(g) * s * p;
  const int n = s * p;
  const int base = blockIdx.y * kChunk + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int e = base + u * kThreads;
    if (e < n) {
      const int j = e / p;
      int k = __ldg(ix + j);
      k = k < 0 ? 0 : (k > s - 1 ? s - 1 : k);
      of[e] = __ldg(sf + k * p + (e - j * p));
    }
  }
}

template <typename V, int P>
void launch(const float* src, const int* idx, float* out, long long groups, long long chunks,
            int frames, int s, int p, long long seq_stride, long long frame_stride,
            cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(chunks));
  gather_rows_kernel<V, P><<<grid, kThreads, 0, st>>>(reinterpret_cast<const V*>(src), idx,
                                                      reinterpret_cast<V*>(out), frames, s, p,
                                                      seq_stride, frame_stride);
}

}  // namespace

VO_EXPORT int vo_gather_rows(const float* src, const int* idx, float* out, int seqs, int frames,
                             int s, int d, long long seq_stride, long long frame_stride,
                             void* stream) {
  const long long groups = static_cast<long long>(seqs) * frames;
  if (groups <= 0 || s <= 0 || d <= 0) return 0;
  const bool pairs = (d == 2 || d == 10) &&
                     (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) % 8 == 0 &&
                     seq_stride % 2 == 0 && frame_stride % 2 == 0;
  const int v = pairs ? 2 : 1;  // floats a moved value
  const long long chunks = (static_cast<long long>(s) * (d / v) + kChunk - 1) / kChunk;
  if (groups > 2147483647LL || chunks > 65535 || static_cast<long long>(s) * d > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pairs) {
    launch<float, 0>(src, idx, out, groups, chunks, frames, s, d, seq_stride, frame_stride, st);
  } else if (d == 2) {
    launch<float2, 1>(src, idx, out, groups, chunks, frames, s, 1, seq_stride / 2,
                      frame_stride / 2, st);
  } else {
    launch<float2, 5>(src, idx, out, groups, chunks, frames, s, 5, seq_stride / 2,
                      frame_stride / 2, st);
  }
  return vo_launch_status();
}
