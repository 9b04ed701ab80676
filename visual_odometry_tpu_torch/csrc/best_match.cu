// K7: streaming top-1 appearance match of a query set against a map-scale
// database, exact and fast.
//
// Replaces visual_odometry_tpu/ops/pallas/matcher_kernel.py:best_match_pallas
// (body _make_kernel). For query q_i (Q, D) and database row k_j (K, D):
//   d(i, j) = (|q_i|^2 + n_j) - 2 * dot(q_i, k_j),  NOT clamped in selection,
//   n_j     = |k_j|^2, or 3.4e38 with the row zeroed where the row is masked
//             (NaN or inf garbage in a masked row never reaches a sum);
//   idx[i]  = first argmin_j d(i, j), starting from (3.4e38, 0) with a strict
//             '<', so a masked row never wins and an all-masked database
//             gives index 0;
//   dist[i] = max(d(i, idx[i]), 0), or 3.4e38 for a masked query.
// The (Q, K) distances never reach device memory.
//
// Fast mode: select on a cheap gram, rescore the winner exactly. The gram
// takes q and the database rounded to bf16 and accumulates in f32 (the norms
// stay f32); the distance is clamped to >= 0, so its bit pattern is
// monotonic, and selection is one min over a 64-bit key (distance bits high,
// global column low: first index on ties, no mantissa bits stolen). The
// winner's distance is then recomputed in f32 as sum((q - k)^2) over the
// unrounded rows; a masked winner gives 3.4e38. The returned distance is
// exact for the returned index, so radius decisions stay exact.
//
// Bound on this card: the FP32 instruction rate, Q * K * (2 D + 3) operations against
// (Q + K) * D * 4 bytes; D = 10 is too thin for tensor cores and the exact
// mode rules out TF32. Design: grid = (query tiles of 128) x (database
// splits). A CTA stages 256 database rows at a time in shared memory
// (descriptor + norm per row); each thread keeps one query in registers and
// scans the tile in ascending row order with a strict '<'. Each split writes
// its partial (distance, index) per query; a second small kernel folds the
// splits in ascending order, again with a strict '<', and finishes the
// distance. That is deterministic and needs no atomics.
//
// Exactness: products and sums go through explicit round-to-nearest
// intrinsics in descriptor order, as in match_pairs.cu, so the kernel and
// its plain PyTorch version (ops/kernels/matcher_kernel.best_match_plain)
// agree bit for bit.
#include <cuda_bf16.h>

#include "common.cuh"

#define VO_BIG 3.4e38f
#define VO_MAX_D 32
#define BM_TQ 128   // queries (threads) per CTA
#define BM_TK 256   // database rows staged per tile

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int DT>
__device__ __forceinline__ float ordered_sq_norm(const float* x, int d) {
  float acc = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int k = 1; k < (DT > 0 ? DT : d); ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  return acc;
}

__device__ __forceinline__ unsigned long long pack_key(float dist, int col) {
  return (static_cast<unsigned long long>(__float_as_uint(dist)) << 32) |
         static_cast<unsigned int>(col);
}

// Partial top-1 of one (query tile, database split). part_key holds, per
// (split, query): exact mode the distance bits (high) and index (low) of the
// split's first minimum; fast mode the 64-bit selection key itself.
template <int DT, bool FAST>
__global__ void __launch_bounds__(BM_TQ)
    best_match_scan_kernel(const float* __restrict__ queries, const float* __restrict__ db,
                           const uint8_t* __restrict__ db_mask,
                           unsigned long long* __restrict__ part_key, int nq, int nk, int d_rt,
                           int rows_per_split) {
  const int d = DT > 0 ? DT : d_rt;
  const int rs = d + 1;  // staged row: descriptor, then its norm term
  extern __shared__ float tile[];

  const int qi = blockIdx.x * BM_TQ + threadIdx.x;
  const bool has_q = qi < nq;
  float x[DT > 0 ? DT : VO_MAX_D];
  float qn = 0.0f;
  if (has_q) {
#pragma unroll
    for (int k = 0; k < (DT > 0 ? DT : d); ++k) x[k] = queries[static_cast<long long>(qi) * d + k];
    qn = ordered_sq_norm<DT>(x, d);
    if (FAST) {
#pragma unroll
      for (int k = 0; k < (DT > 0 ? DT : d); ++k) x[k] = bf16_round(x[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < (DT > 0 ? DT : d); ++k) x[k] = 0.0f;
  }

  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nk, lo + rows_per_split);
  float best = VO_BIG;
  int arg = 0;
  unsigned long long best_key = pack_key(VO_BIG, 0);

  for (int base = lo; base < hi; base += BM_TK) {
    const int rows = min(BM_TK, hi - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int r = threadIdx.x; r < rows; r += BM_TQ) {
      const float* src = db + static_cast<long long>(base + r) * d;
      float* dst = tile + r * rs;
      if (db_mask[base + r]) {
        float y[DT > 0 ? DT : VO_MAX_D];
#pragma unroll
        for (int k = 0; k < (DT > 0 ? DT : d); ++k) y[k] = src[k];
        dst[d] = ordered_sq_norm<DT>(y, d);
#pragma unroll
        for (int k = 0; k < (DT > 0 ? DT : d); ++k) dst[k] = FAST ? bf16_round(y[k]) : y[k];
      } else {
#pragma unroll
        for (int k = 0; k < (DT > 0 ? DT : d); ++k) dst[k] = 0.0f;
        dst[d] = VO_BIG;
      }
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float* y = tile + r * rs;
      float dot = __fmul_rn(x[0], y[0]);
#pragma unroll
      for (int k = 1; k < (DT > 0 ? DT : d); ++k) dot = __fadd_rn(dot, __fmul_rn(x[k], y[k]));
      float v = __fsub_rn(__fadd_rn(qn, y[d]), __fmul_rn(2.0f, dot));
      if (FAST) {
        v = v < 0.0f ? 0.0f : v;  // keeps a NaN, whose key is above every distance's
        const unsigned long long key = pack_key(v, base + r);
        if (key < best_key) best_key = key;
      } else if (v < best) {
        best = v;
        arg = base + r;
      }
    }
  }
  if (has_q) {
    part_key[static_cast<long long>(blockIdx.y) * nq + qi] = FAST ? best_key : pack_key(best, arg);
  }
}

// Fold the splits per query in ascending order and finish the distance.
template <bool FAST>
__global__ void best_match_fold_kernel(const float* __restrict__ queries,
                                       const uint8_t* __restrict__ q_mask,
                                       const float* __restrict__ db,
                                       const uint8_t* __restrict__ db_mask,
                                       const unsigned long long* __restrict__ part_key,
                                       float* __restrict__ dist, int* __restrict__ idx, int nq,
                                       int nk, int d, int splits) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float best = VO_BIG;
  int arg = 0;
  if (FAST) {
    unsigned long long best_key = pack_key(VO_BIG, 0);
    for (int s = 0; s < splits; ++s) {
      const unsigned long long key = part_key[static_cast<long long>(s) * nq + qi];
      if (key < best_key) best_key = key;
    }
    arg = static_cast<int>(best_key & 0xffffffffull);
    // Exact rescore of the winner on the unrounded rows.
    const int row = min(max(arg, 0), nk - 1);
    const float* q = queries + static_cast<long long>(qi) * d;
    const float* y = db + static_cast<long long>(row) * d;
    float diff = __fsub_rn(q[0], y[0]);
    float acc = __fmul_rn(diff, diff);
    for (int k = 1; k < d; ++k) {
      diff = __fsub_rn(q[k], y[k]);
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
    best = db_mask[row] ? acc : VO_BIG;
  } else {
    for (int s = 0; s < splits; ++s) {
      const unsigned long long key = part_key[static_cast<long long>(s) * nq + qi];
      const float v = __uint_as_float(static_cast<unsigned int>(key >> 32));
      if (v < best) {
        best = v;
        arg = static_cast<int>(key & 0xffffffffull);
      }
    }
  }
  const float clamped = best < 0.0f ? 0.0f : best;  // keeps a NaN, like torch.clamp_min
  dist[qi] = q_mask[qi] ? clamped : VO_BIG;
  idx[qi] = arg;
}

// part_key: scratch of splits * nq 64-bit words, allocated by the caller.
VO_EXPORT int vo_best_match(const float* queries, const uint8_t* q_mask, const float* db,
                            const uint8_t* db_mask, unsigned long long* part_key, float* dist,
                            int* idx, int nq, int nk, int d, int splits, int fast, void* stream) {
  if (nq <= 0) return 0;
  if (nk < 1 || d < 1 || d > VO_MAX_D || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rows_per_split = (nk + splits - 1) / splits;
  rows_per_split = ((rows_per_split + BM_TK - 1) / BM_TK) * BM_TK;
  const dim3 grid((nq + BM_TQ - 1) / BM_TQ, splits);
  const size_t smem = static_cast<size_t>(BM_TK) * (d + 1) * sizeof(float);
  if (fast) {
    if (d == 10) {
      best_match_scan_kernel<10, true><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                  nq, nk, d, rows_per_split);
    } else {
      best_match_scan_kernel<0, true><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                 nq, nk, d, rows_per_split);
    }
  } else {
    if (d == 10) {
      best_match_scan_kernel<10, false><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                   nq, nk, d, rows_per_split);
    } else {
      best_match_scan_kernel<0, false><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                  nq, nk, d, rows_per_split);
    }
  }
  int code = vo_launch_status();
  if (code != 0) return code;
  const int fold_threads = 128;
  const int fold_blocks = (nq + fold_threads - 1) / fold_threads;
  if (fast) {
    best_match_fold_kernel<true><<<fold_blocks, fold_threads, 0, st>>>(
        queries, q_mask, db, db_mask, part_key, dist, idx, nq, nk, d, splits);
  } else {
    best_match_fold_kernel<false><<<fold_blocks, fold_threads, 0, st>>>(
        queries, q_mask, db, db_mask, part_key, dist, idx, nq, nk, d, splits);
  }
  return vo_launch_status();
}
