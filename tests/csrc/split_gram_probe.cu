// The chained split-bf16 gram of K7's exact mode on its own, for
// tests/test_torch_cuda.py::test_split_gram_accumulation_within_the_bound.
//
// Block b (one warp) takes queries q[16 b .. 16 b + 16) and rows
// k[8 b .. 8 b + 8), each of d f32 values, packs them as the exact mode of
// best_match_tc_kernel does (packed_element: the pairs hi.hi, mid.hi,
// hi.mid, d elements each, zero past 3 d), chains the ceil(3 d / 16)
// m16n8k16 MMAs through the f32 accumulators (mma_bf16_16816) and writes the
// 16 x 8 result to out[128 b ..). The fragments are read straight from
// global memory in the instruction's register layout, where the kernel uses
// ldmatrix on its staged rows; the products and their accumulation are the
// same instructions.
#include "../../visual_odometry_tpu_torch/csrc/best_match.cu"

__global__ void split_gram_probe_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                        float* __restrict__ out, int d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float* qb = q + static_cast<long long>(blockIdx.x) * 16 * d;
  const float* kb = k + static_cast<long long>(blockIdx.x) * 8 * d;
  const int chunks = (TC_PAIRS * d + 15) / 16;
  float c[4];
  for (int ch = 0; ch < chunks; ++ch) {
    // a[h + 2 half]: query row g + 8 h, elements ch 16 + 8 half + 2 t (+1).
    uint32_t a[4];
    for (int half = 0; half < 2; ++half) {
      for (int h = 0; h < 2; ++h) {
        const float* row = qb + (g + 8 * h) * d;
        const int e = ch * 16 + half * 8 + 2 * t;
        a[h + 2 * half] = packed_element<true, true>(row, e, d) |
                          (static_cast<uint32_t>(packed_element<true, true>(row, e + 1, d)) << 16);
      }
    }
    // b[i]: database row g, elements ch 16 + 8 i + 2 t (+1).
    uint32_t b[2];
    for (int i = 0; i < 2; ++i) {
      const float* row = kb + g * d;
      const int e = ch * 16 + 8 * i + 2 * t;
      b[i] = packed_element<true, false>(row, e, d) |
             (static_cast<uint32_t>(packed_element<true, false>(row, e + 1, d)) << 16);
    }
    if (ch == 0) {
      mma_bf16_16816<false>(c, a, b[0], b[1]);
    } else {
      mma_bf16_16816<true>(c, a, b[0], b[1]);
    }
  }
  // c[e]: query row g + 8 (e / 2), column 2 t + e % 2.
  float* ob = out + static_cast<long long>(blockIdx.x) * 128;
  for (int e = 0; e < 4; ++e) ob[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = c[e];
}

VO_EXPORT int vo_split_gram_probe(const float* q, const float* k, float* out, int blocks, int d,
                                  void* stream) {
  if (blocks < 1 || d < 1 || d > VO_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  split_gram_probe_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(q, k, out, d);
  return vo_launch_status();
}
