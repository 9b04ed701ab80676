// K2: the world join's first-wins candidate chains, one frame per CTA.
//
// Replaces visual_odometry_tpu/ops/pallas/frame_kernel.py:join_candidates
// (body _cand_kernel). For frame f and current lane j', candidate level
// k < depth is the k-th smallest source lane j (ascending) with
// src_valid[j] and src_idx2[j] == dst_idx1[j']. Outputs:
//   idx[f, k, j']    the candidate lane, 0 where absent or j' is invalid;
//   ok[f, k, j']     the candidate exists AND dst_valid[j'];
//   overflow[f, j']  a (depth+1)-th candidate exists AND dst_valid[j'] — the
//                    lane's multiplicity exceeds the chain, which the
//                    pipeline turns into FusedJoinDepthError.
// The TPU kernel's lo/hi (index % 128, index // 128) split was a Mosaic
// gather layout and is gone: idx holds the lane itself.
//
// Bound on this card: shared-memory reads, S^2 compares per frame (1M at
// S = 1024), trivial next to the frame loop. Design: the frame's source row
// (indices and validity) is staged in shared memory; one thread per
// current lane scans it in ascending order and stops after depth+1 hits.
#include "common.cuh"

__global__ void join_candidates_kernel(const int* __restrict__ src_idx2,
                                       const uint8_t* __restrict__ src_valid,
                                       const int* __restrict__ dst_idx1,
                                       const uint8_t* __restrict__ dst_valid, int* __restrict__ idx,
                                       uint8_t* __restrict__ ok, uint8_t* __restrict__ overflow,
                                       int s, int depth) {
  extern __shared__ int sh[];
  int* s_tgt = sh;                                         // (s,) source targets
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(sh + s);      // (s,) source validity
  const long long f = blockIdx.x;
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    s_tgt[j] = src_idx2[f * s + j];
    s_ok[j] = src_valid[f * s + j];
  }
  __syncthreads();

  for (int jp = threadIdx.x; jp < s; jp += blockDim.x) {
    const int target = dst_idx1[f * s + jp];
    const uint8_t live = dst_valid[f * s + jp] != 0;
    int found = 0;
    uint8_t over = 0;
    for (int j = 0; j < s; ++j) {
      if (s_ok[j] && s_tgt[j] == target) {
        if (found == depth) {
          over = live;
          break;
        }
        const long long o = (f * depth + found) * s + jp;
        idx[o] = live ? j : 0;
        ok[o] = live;
        ++found;
      }
    }
    for (int k = found; k < depth; ++k) {
      const long long o = (f * depth + k) * s + jp;
      idx[o] = 0;
      ok[o] = 0;
    }
    overflow[f * s + jp] = over;
  }
}

VO_EXPORT int vo_join_candidates(const int* src_idx2, const uint8_t* src_valid,
                                 const int* dst_idx1, const uint8_t* dst_valid, int* idx,
                                 uint8_t* ok, uint8_t* overflow, int frames, int s, int depth,
                                 void* stream) {
  if (frames <= 0 || s <= 0) return 0;
  size_t smem = static_cast<size_t>(s) * (sizeof(int) + 1);
  int threads = s < 1024 ? ((s + 31) / 32) * 32 : 1024;
  join_candidates_kernel<<<frames, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      src_idx2, src_valid, dst_idx1, dst_valid, idx, ok, overflow, s, depth);
  return vo_launch_status();
}
