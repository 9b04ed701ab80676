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
// stay f32); the distance is clamped to >= 0 (a NaN counts as inf), so its
// bit pattern is monotonic, and selection is one min over a 64-bit key
// (distance bits high, global column low: first index on ties). The winner's
// distance is then recomputed in f32 as sum((q - k)^2) over the unrounded
// rows; a masked winner gives 3.4e38. The returned distance is exact for the
// returned index, so radius decisions stay exact.
//
// Exact mode. Bound on this card: instruction issue, Q * K * (2 D + 3)
// separately rounded operations (33.5e12 a second, 0.737 ms at Q = 1024,
// K = 2^20, D = 10); TF32 or bf16 would change the function. Design: grid =
// (query tiles of 128) x (database splits). A CTA stages 256 database rows at
// a time in shared memory (descriptor + norm per row); each thread keeps one
// query in registers and scans the tile in ascending row order with a strict
// '<', products and sums through explicit round-to-nearest intrinsics in
// descriptor order, as in match_pairs.cu, so the kernel and its plain PyTorch
// version (ops/kernels/matcher_kernel.best_match_plain) agree bit for bit.
// Each split writes its partial (distance, index) per query; a second small
// kernel folds the splits in ascending order, again with a strict '<', and
// finishes the distance. That is deterministic and needs no atomics.
//
// Fast mode at D <= 16 (the pipeline's D = 10): the gram on the tensor cores,
// then the plain key on the rows that a proven margin cannot rule out.
// Bound, the least the function needs: the tensor cores' 989e12 bf16
// operations a second on D padded to 16 (0.035 ms at Q = 1024, K = 2^20)
// against one compare a pair at the 33.5e12 issue rate (0.032 ms; the norms
// could ride in the MMA's free k-slots), so 0.035 ms. The epilogue below
// issues 3 a pair (an add, an fma, a compare: 0.096 ms). The grid is
// (query tiles of 256) x (the exact mode's database splits), with its fold.
// A CTA's 8 warps hold 32 queries each as the A fragments of two m16n8k16
// tiles (bf16, zero-padded to k = 16) in registers for the whole scan. Each
// thread stages one row of a 256-row tile, bf16 padded to 32 bytes (the two
// 16-byte halves swapped on every other group of four rows, so that ldmatrix
// reads them without bank conflicts) with the row's f32 norm n_j and its
// bound term a_j beside it, and loads its row of the next tile into
// registers before the current tile's products. Per 16 rows a warp issues
// one ldmatrix.x4 and four mma.sync into fresh f32 accumulators (a lane holds
// 2 query rows x 2 columns of each 16 x 8 product).
//
// The error bound. Let R = qn + n_j (exact sum), x = s - 2 dot with s =
// RN(R), so the plain v = RN(x); acc is the tensor core's sum of the same
// bf16 x bf16 products (each exact in f32).
//   - the plain dot makes at most D - 1 <= 15 roundings: |dot - sum p| <=
//     15 u P, with u = 2^-24 and P = sum |p|;
//   - the tensor core's accumulation is not IEEE round-to-nearest (products
//     are aligned to the largest and truncated); allowed here: |acc - sum p|
//     <= 96 u P, about three times the truncation model's 17 units of 2^-23;
//   - P <= |qb||kb| <= (1 + 2^-8)^2 (|q|^2 + |k|^2) / 2 and |q|^2 <= qn (1 +
//     17 u), so 2 |acc - dot| <= 2 * 111 u * 0.5079 (1 + 17 u) R <= 112.8 u R.
// As a bound on v itself: with v' = RN(s - 2 acc), |v - v'| <= eps =
// c 2^-24 (qn + n_j) + 2^-23 |v'| with c = 113, the second term the roundings
// of the final subtraction. The kernel folds eps into one bound a pair,
//   z_lo = RN(RN(RN(alpha qn) - tau) + RN(alpha n_j)) - 2 acc   (one fma),
//   z_hi = RN(RN(RN(beta qn) + tau) + RN(beta n_j)) - 2 acc,
//   alpha = 1 - 2^-17 = 1 - 128 u, beta = 1 + 128 u, tau = 2^-96:
// x - z_lo >= (127 - 112.8 - 4.1) u R + tau - 2^-120 > 0 and z_hi - x
// likewise, where 4.1 u R covers the four roundings of z itself (|z| <=
// 2.03 R) and 2^-120 flushed subnormal products. So z_lo <= x <= z_hi, and as
// RN is monotonic, z_lo <= v <= z_hi for the floats v, z_lo, z_hi (z_lo =
// +inf implies s = inf or x past the largest float: v >= any float T then
// too). A masked row (a_j = +inf) is ruled out: its plain v is RN(qn +
// 3.4e38) - 0 >= the start key's 3.4e38, or NaN -> inf.
//
// The filter: skip row j iff max(L_j, 0) > max(U, 0) for a lower bound
// L_j <= v_j and an upper bound U >= max(v, 0) of some row; such a row can
// neither win nor tie. Comparing unclamped values would be wrong: two rows
// whose plain v are both negative clamp to 0 and tie, and the lower column
// wins. Two such U, neither needing any communication during the scan:
//   - seed: a first launch runs the same scan over every 32nd row with z_hi
//     and takes each query's minimum of max(z_hi, 0), atomicMin on its bits
//     (about the 32nd smallest distance of all rows, at 1/32 of the work);
//     skip iff z_lo > U;
//   - the lane's own exact running minimum T, the distance of the smallest
//     plain key among the rows it rescored (3.4e38 at the start key
//     (3.4e38, 0)). A lane meets its columns in ascending order, so a row
//     with max(v, 0) >= T has a key above that minimum: skip iff z_lo >= T
//     for T > 0, and every row once T = 0.
// One compare does both: skip iff z_lo >= min(T or -inf, next float above U).
// A NaN z_lo survives, and its exact key is inf's. A lane's U and T are never
// below the global ones, so the winner always survives. Every survivor is
// rescored as the plain version does it: the dot in descriptor order
// (__fmul_rn/__fadd_rn) from the staged bf16 rows and the query tile in
// shared memory, v, NaN -> inf, the clamp, the 64-bit key. At the end the 4
// lanes of a query row take the minimum of their keys (__shfl_xor_sync; a
// minimum does not depend on order) and write part_key. The rescored pairs
// are counted into `survivors` when the caller passes a counter. Fast mode at
// 16 < D <= 32 keeps the bf16-rounded gram on the FP32 pipes, one query a
// thread, as the exact mode's scan.
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

#define TC_ALPHA (1.0f - 0x1p-17f)   // 1 - 128 u: the lower bound's relative margin
#define TC_BETA (1.0f + 0x1p-17f)    // 1 + 128 u: the upper bound's
#define TC_TAU 0x1p-96f              // their absolute margin (flushed subnormals)
#define TC_SEED_STRIDE 32            // the seed pass reads every 32nd row
#define TC_TQ 256                    // queries (threads) a CTA of the tensor-core scan
static_assert(TC_TQ == BM_TK, "a thread stages one row of a tile");

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

// Element k of staged row r (halves swapped on every other group of 4 rows).
__device__ __forceinline__ float staged(const unsigned short (*rows)[16], int r, int k) {
  return bf16_value(rows[r][(((k >> 3) ^ (r >> 2)) & 1) * 8 + (k & 7)]);
}

// Row `row` of the database (zeros unless in range and live) -> y; returns live.
template <int DT>
__device__ __forceinline__ bool load_row(const float* __restrict__ db,
                                         const uint8_t* __restrict__ db_mask, long long row,
                                         bool in_range, int d, float (&y)[16]) {
  const bool live = in_range && db_mask[row];
#pragma unroll
  for (int k = 0; k < 16; ++k) y[k] = (live && k < (DT > 0 ? DT : d)) ? db[row * d + k] : 0.0f;
  return live;
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// The fast mode's tensor-core scan over one (query tile, database split),
// D <= 16; see the header. Warp w holds local queries w*32 + m*16 + {g, g+8}
// (m = 0, 1; g = lane / 4) as its lane's query slots q = 2m + h.
// SEED: the split runs over rows 0, stride, 2 stride, ...; each query's
// minimum of max(z_hi, 0) goes into seed[qi] (float bits, atomicMin; the
// caller fills seed with 0xff bytes). Otherwise: the filter against the
// lane's exact minimum T and the seed U, the exact rescore of the
// survivors, and each query's split key into part_key.
template <int DT, bool SEED>
__global__ void __launch_bounds__(TC_TQ)
    best_match_tc_kernel(const float* __restrict__ queries, const float* __restrict__ db,
                         const uint8_t* __restrict__ db_mask,
                         unsigned long long* __restrict__ part_key, unsigned int* __restrict__ seed,
                         unsigned long long* __restrict__ survivors, int nq, int nk, int d_rt,
                         int rows_per_split, int stride) {
  const int d = DT > 0 ? DT : d_rt;
  __shared__ __align__(16) unsigned short q_s[TC_TQ][16];   // bf16 queries, zero-padded
  __shared__ float qn_s[TC_TQ];                             // f32 norms of the unrounded queries
  __shared__ __align__(16) unsigned short k_s[BM_TK][16];   // bf16 rows, swizzled halves
  __shared__ __align__(16) float n_s[BM_TK];                // f32 norms, 3.4e38 masked
  __shared__ __align__(16) float a_s[BM_TK];                // RN(alpha or beta n_j), +inf masked

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  {
    const int qi = blockIdx.x * TC_TQ + tid;
    float x[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      x[k] = (qi < nq && k < d) ? queries[static_cast<long long>(qi) * d + k] : 0.0f;
    }
    qn_s[tid] = ordered_sq_norm<DT>(x, d);
    uint32_t* dst = reinterpret_cast<uint32_t*>(q_s[tid]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      dst[k] = bf16_bits(x[2 * k]) | (static_cast<uint32_t>(bf16_bits(x[2 * k + 1])) << 16);
    }
  }
  __syncthreads();

  // Per query slot: aq, the query's share of the bound; thr, the filter's
  // threshold min(T or -inf at T = 0, next float above U), or SEED's running
  // minimum of z_hi; us, the next float above the seed U; best, the exact key.
  uint32_t a[2][4];
  float aq[4], thr[4], us[4];
  unsigned long long best[4];
  bool has_q[4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(q_s[warp * 32 + m * 16 + g]);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(q_s[warp * 32 + m * 16 + g + 8]);
    a[m][0] = r0[t];
    a[m][1] = r1[t];
    a[m][2] = r0[4 + t];
    a[m][3] = r1[4 + t];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * m + h, ql = warp * 32 + m * 16 + g + 8 * h;
      const int qi = blockIdx.x * TC_TQ + ql;
      has_q[q] = qi < nq;
      best[q] = pack_key(VO_BIG, 0);
      if (SEED) {
        aq[q] = __fadd_rn(__fmul_rn(TC_BETA, qn_s[ql]), TC_TAU);
        thr[q] = us[q] = INFINITY;
      } else {
        aq[q] = __fsub_rn(__fmul_rn(TC_ALPHA, qn_s[ql]), TC_TAU);
        // A NaN (no seed row gave a bound) leaves T alone; an absent query
        // rules every row out.
        us[q] = has_q[q] ? nextafterf(__uint_as_float(seed[qi]), INFINITY) : -INFINITY;
        thr[q] = fminf(VO_BIG, us[q]);
      }
    }
  }

  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nk, lo + rows_per_split);
  unsigned int rescored = 0;
  // Thread tid stages row tid of each tile; the next tile's row is loaded
  // into registers before the current tile's products.
  float y[16];
  bool live = load_row<DT>(db, db_mask, static_cast<long long>(lo + tid) * stride, lo + tid < hi,
                           d, y);
  for (int base = lo; base < hi; base += BM_TK) {
    const int rows = min(BM_TK, hi - base);
    __syncthreads();  // the previous tile has been read by every thread
    {
      const float n = ordered_sq_norm<DT>(y, d);
      n_s[tid] = live ? n : VO_BIG;
      a_s[tid] = live ? __fmul_rn(SEED ? TC_BETA : TC_ALPHA, n) : INFINITY;
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        w[k] = bf16_bits(y[2 * k]) | (static_cast<uint32_t>(bf16_bits(y[2 * k + 1])) << 16);
      }
      uint4* dst = reinterpret_cast<uint4*>(k_s[tid]);
      const int sw = (tid >> 2) & 1;
      dst[sw] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[sw ^ 1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();
    const int next = base + BM_TK + tid;
    live = load_row<DT>(db, db_mask, static_cast<long long>(next) * stride, next < hi, d, y);
    for (int n0 = 0; n0 < rows; n0 += 16) {
      // Lane L addresses row n0 + (L / 16) * 8 + L % 8, half (L / 8) % 2.
      uint32_t b[4];
      {
        const int r = n0 + ((lane >> 4) << 3) + (lane & 7);
        const int half = ((lane >> 3) ^ (r >> 2)) & 1;
        const unsigned addr =
            static_cast<unsigned>(__cvta_generic_to_shared(&k_s[r][half * 8]));
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                     : "r"(addr));
      }
      float c[2][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_bf16_16816(c[nt][m], a[m], b[2 * nt], b[2 * nt + 1]);
      }
      float2 aj[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        aj[nt] = *reinterpret_cast<const float2*>(&a_s[n0 + nt * 8 + 2 * t]);
      }
      // c[nt][m][e]: query slot 2m + e/2, column n0 + 8 nt + 2t + e % 2.
      bool any = false;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 2 * m + (e >> 1);
            const float z = __fmaf_rn(-2.0f, c[nt][m][e],
                                      __fadd_rn(aq[q], (e & 1) ? aj[nt].y : aj[nt].x));
            if (SEED) {
              thr[q] = fminf(thr[q], z);   // a NaN or inf bound is no bound
            } else {
              any |= !(z >= thr[q]);
            }
          }
        }
      }
      if (SEED) continue;
      // Survivors, in ascending column order for each query slot; the warp
      // meets again before the next ldmatrix.
      if (__any_sync(0xffffffffu, any) && any) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int col = 0; col < 2; ++col) {
            const int r = n0 + nt * 8 + 2 * t + col;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = q >> 1, e = ((q & 1) << 1) | col;
              const float z = __fmaf_rn(-2.0f, c[nt][m][e],
                                        __fadd_rn(aq[q], col ? aj[nt].y : aj[nt].x));
              if (z >= thr[q] || r >= rows || !has_q[q]) continue;
              ++rescored;
              const int ql = warp * 32 + m * 16 + g + 8 * (q & 1);
              float dot = __fmul_rn(bf16_value(q_s[ql][0]), staged(k_s, r, 0));
              for (int k = 1; k < d; ++k) {
                dot = __fadd_rn(dot, __fmul_rn(bf16_value(q_s[ql][k]), staged(k_s, r, k)));
              }
              float v = __fsub_rn(__fadd_rn(qn_s[ql], n_s[r]), __fmul_rn(2.0f, dot));
              v = isnan(v) ? INFINITY : (v < 0.0f ? 0.0f : v);
              const unsigned long long key = pack_key(v, base + r);
              if (key < best[q]) {
                best[q] = key;
                // T = 0: every later row of this lane is ruled out.
                thr[q] = fminf(v > 0.0f ? v : -INFINITY, us[q]);
              }
            }
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int qi = blockIdx.x * TC_TQ + warp * 32 + (q >> 1) * 16 + g + 8 * (q & 1);
    if (SEED) {
      float u = fmaxf(thr[q], 0.0f);
      u = fminf(u, __shfl_xor_sync(0xffffffffu, u, 1));
      u = fminf(u, __shfl_xor_sync(0xffffffffu, u, 2));
      if (t == 0 && qi < nq && u < INFINITY) atomicMin(&seed[qi], __float_as_uint(u));
    } else {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, best[q], o);
        best[q] = other < best[q] ? other : best[q];
      }
      if (t == 0 && qi < nq) part_key[static_cast<long long>(blockIdx.y) * nq + qi] = best[q];
    }
  }
  if (!SEED && survivors != nullptr) {
    const unsigned int total = __reduce_add_sync(0xffffffffu, rescored);
    if (lane == 0 && total != 0) atomicAdd(survivors, static_cast<unsigned long long>(total));
  }
}

// The fast mode at D <= 16: the seed pass, then the filtered scan.
template <int DT>
static void launch_tc(const float* queries, const float* db, const uint8_t* db_mask,
                      unsigned long long* part_key, unsigned int* seed,
                      unsigned long long* survivors, int nq, int nk, int d, int splits,
                      int rows_per_split, cudaStream_t st) {
  const int q_tiles = (nq + TC_TQ - 1) / TC_TQ;
  const int seed_rows = (nk + TC_SEED_STRIDE - 1) / TC_SEED_STRIDE;
  const int seed_splits = min(splits, (seed_rows + BM_TK - 1) / BM_TK);
  int seed_per_split = (seed_rows + seed_splits - 1) / seed_splits;
  seed_per_split = ((seed_per_split + BM_TK - 1) / BM_TK) * BM_TK;
  cudaMemsetAsync(seed, 0xff, static_cast<size_t>(nq) * sizeof(unsigned int), st);
  best_match_tc_kernel<DT, true><<<dim3(q_tiles, seed_splits), TC_TQ, 0, st>>>(
      queries, db, db_mask, part_key, seed, nullptr, nq, seed_rows, d, seed_per_split,
      TC_SEED_STRIDE);
  best_match_tc_kernel<DT, false><<<dim3(q_tiles, splits), TC_TQ, 0, st>>>(
      queries, db, db_mask, part_key, seed, survivors, nq, nk, d, rows_per_split, 1);
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

// part_key: scratch of splits * nq 64-bit words and seed of nq 32-bit words
// (used by the fast mode at D <= 16), allocated by the caller; survivors: a
// device counter the fast mode at D <= 16 adds its rescored pairs to, or null.
VO_EXPORT int vo_best_match(const float* queries, const uint8_t* q_mask, const float* db,
                            const uint8_t* db_mask, unsigned long long* part_key,
                            unsigned int* seed, unsigned long long* survivors, float* dist,
                            int* idx, int nq, int nk, int d, int splits, int fast, void* stream) {
  if (nq <= 0) return 0;
  if (nk < 1 || d < 1 || d > VO_MAX_D || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rows_per_split = (nk + splits - 1) / splits;
  rows_per_split = ((rows_per_split + BM_TK - 1) / BM_TK) * BM_TK;
  const dim3 grid((nq + BM_TQ - 1) / BM_TQ, splits);
  const size_t smem = static_cast<size_t>(BM_TK) * (d + 1) * sizeof(float);
  if (fast && d == 10) {
    launch_tc<10>(queries, db, db_mask, part_key, seed, survivors, nq, nk, d, splits,
                  rows_per_split, st);
  } else if (fast && d <= 16) {
    launch_tc<0>(queries, db, db_mask, part_key, seed, survivors, nq, nk, d, splits,
                 rows_per_split, st);
  } else if (fast) {
    best_match_scan_kernel<0, true><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                               nq, nk, d, rows_per_split);
  } else if (d == 10) {
    best_match_scan_kernel<10, false><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                 nq, nk, d, rows_per_split);
  } else {
    best_match_scan_kernel<0, false><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                nq, nk, d, rows_per_split);
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
