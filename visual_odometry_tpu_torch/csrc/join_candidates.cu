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
// Bound on this card: bytes, the four (F, S) input rows read once and the
// (F, depth, S) and (F, S) outputs written once (11 MB at F = 510, S = 1024,
// depth 2: 3.3 us at 3.35 TB/s). Design: per-target first-lane tables in
// shared memory instead of a scan of all S source lanes by each current lane
// (S^2 compares a frame). Level k's table holds, for every target t in
// [0, S), the k-th smallest valid source lane aimed at t, or S for none:
//   pass k: each valid source lane j with target t in [0, S) and
//           j > level[k-1][t] does atomicMin(&level[k][t], j);
// a minimum does not depend on the order of the atomics, so the tables are
// deterministic. After pass k every live current lane reads
// level[k][dst_idx1[j']] and writes its level-k output (level depth is the
// overflow flag). Only two tables are live at a time (the previous and the
// current level), so shared memory is 13 S bytes at any depth: 13 KB at
// S = 1024, and up to S = 17,880 with the opt-in above 48 KB. The cost is
// (depth+1) passes of S shared atomics and S table reads a frame.
//
// Targets outside [0, S). The pipeline never makes one (K1 and the id join
// return a slot in [0, S) on every lane, valid or not), but the function is
// defined for any int32, as the plain version compares them. A source lane
// with such a target stays out of the tables; a live current lane with one
// scans the staged source row for its target alone, as the former kernel
// scanned every lane, and stops after depth+1 hits.
#include "common.cuh"

__global__ void join_candidates_kernel(const int* __restrict__ src_idx2,
                                       const uint8_t* __restrict__ src_valid,
                                       const int* __restrict__ dst_idx1,
                                       const uint8_t* __restrict__ dst_valid, int* __restrict__ idx,
                                       uint8_t* __restrict__ ok, uint8_t* __restrict__ overflow,
                                       int s, int depth) {
  extern __shared__ int sh[];
  int* s_tgt = sh;                                          // (s,) source targets
  int* tab = sh + s;                                        // (2, s) level tables
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(sh + 3 * s);   // (s,) source validity
  const long long f = blockIdx.x;
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    s_tgt[j] = src_idx2[f * s + j];
    s_ok[j] = src_valid[f * s + j];
    tab[j] = s;
    tab[s + j] = s;
  }
  __syncthreads();

  for (int k = 0; k <= depth; ++k) {
    int* cur = tab + (k & 1) * s;
    int* prev = tab + ((k + 1) & 1) * s;   // level k-1; unread at k = 0
    for (int j = threadIdx.x; j < s; j += blockDim.x) {
      const int t = s_tgt[j];
      if (s_ok[j] && t >= 0 && t < s && (k == 0 || j > prev[t])) atomicMin(&cur[t], j);
    }
    __syncthreads();
    // Level k is final: write it, and clear level k-1 to take level k+1.
    for (int jp = threadIdx.x; jp < s; jp += blockDim.x) {
      prev[jp] = s;
      const int t = dst_idx1[f * s + jp];
      const bool live = dst_valid[f * s + jp] != 0;
      if (live && (t < 0 || t >= s)) continue;   // the scan below writes this lane
      const int c = live ? cur[t] : s;
      const bool found = c < s;
      if (k < depth) {
        const long long o = (f * depth + k) * s + jp;
        idx[o] = found ? c : 0;
        ok[o] = found;
      } else {
        overflow[f * s + jp] = found;
      }
    }
    __syncthreads();
  }

  for (int jp = threadIdx.x; jp < s; jp += blockDim.x) {
    const int target = dst_idx1[f * s + jp];
    if (!dst_valid[f * s + jp] || (target >= 0 && target < s)) continue;
    int found = 0;
    uint8_t over = 0;
    for (int j = 0; j < s; ++j) {
      if (s_ok[j] && s_tgt[j] == target) {
        if (found == depth) {
          over = 1;
          break;
        }
        const long long o = (f * depth + found) * s + jp;
        idx[o] = j;
        ok[o] = 1;
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
  const size_t smem = static_cast<size_t>(s) * (3 * sizeof(int) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        join_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = s < 1024 ? ((s + 31) / 32) * 32 : 1024;
  join_candidates_kernel<<<frames, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      src_idx2, src_valid, dst_idx1, dst_valid, idx, ok, overflow, s, depth);
  return vo_launch_status();
}
