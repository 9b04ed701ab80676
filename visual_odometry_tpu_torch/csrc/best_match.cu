// K7: streaming top-1 appearance match of a query set against a map-scale
// database, exact and fast.
//
// Replaces visual_odometry_tpu/ops/pallas/matcher_kernel.py:best_match_pallas
// (body _make_kernel). For query q_i (Q, D) and database row k_j (K, D):
//   v(i, j) = (|q_i|^2 + n_j) - 2 * dot(q_i, k_j),  NOT clamped in selection,
//   n_j     = |k_j|^2, or 3.4e38 with the row zeroed where the row is masked
//             (NaN or inf garbage in a masked row never reaches a sum);
//   idx[i]  = first argmin_j v(i, j) (a NaN counts as inf), starting from
//             (3.4e38, 0) with a strict '<', so a masked row never wins and
//             an all-masked database gives index 0;
//   dist[i] = max(v(i, idx[i]), 0), or 3.4e38 for a masked query.
// Every dot product and squared norm is summed in descriptor order from
// separately rounded products (__fmul_rn / __fadd_rn), as the plain PyTorch
// version does (ops/kernels/matcher_kernel.best_match_plain), so the kernel
// and its plain version agree bit for bit. The (Q, K) distances never reach
// device memory.
//
// Exact mode selects on v of the float32 operands. Fast mode selects on v
// with q and the rows rounded to bf16 inside the dot product (f32 norms),
// clamped to >= 0, then recomputes the winner's distance in f32 as
// sum((q - k)^2) over the unrounded rows (3.4e38 for a masked winner), so the
// returned distance is exact for the returned index.
//
// Bound on this card, both modes (utils/roofline.matcher_model): the gram on
// the tensor cores, 2 Q K D at 989e12 a second (0.0217 ms at Q = 1024,
// K = 2^20, D = 10), against one compare a pair at 33.45e12 a second
// (0.0324 ms): 0.0324 ms. Selecting on a rounded key, bf16 or TF32, would
// change the function; so a tensor-core gram may only rule rows out.
//
// Design, exact mode at D <= 32 (but see the FP32 scan below) and fast mode
// at D <= 16: a filter on the
// tensor cores that proves most rows cannot win, then the plain key on the
// rest. The grid is (query tiles of 256) x (database splits), then a fold of
// the splits. A CTA stages its 256 queries in shared memory (f32); its 8
// warps hold 32 queries each as the A fragments of two m16n8k16 tiles per
// k-chunk, in registers for the whole scan. Each
// thread stages one row of a 256-row tile as packed bf16 k-chunks (16 values,
// 32 bytes each; the two 16-byte halves swapped on every other group of four
// rows, so that ldmatrix reads them without bank conflicts) with the row's
// f32 norm n_j and its bound term a_j beside it, and loads its row of the
// next tile into registers before the current tile's products. Per 16 rows
// and k-chunk a warp issues one ldmatrix.x4 and four mma.sync, the chunks
// chained through the f32 accumulators (a lane holds 2 query rows x 2
// columns of each 16 x 8 product).
//
// The packed rows. Fast mode: one chunk, bf16(x) of each component, zero
// past D. Exact mode: each f32 x splits into hi = bf16(x) and mid =
// bf16(x - hi) (x - hi is exact in f32), and the gram takes three term pairs,
//   G = hi_q.hi_k + mid_q.hi_k + hi_q.mid_k,
// each product exact in f32. A packed row holds the pairs one after another,
// D elements each (the query side hi, mid, hi; the database side hi, hi,
// mid), zero past 3 D: KC = ceil(3 D / 16) chunks, two at D = 10 (30 of 32
// k-slots). Why three pairs and not six (with mid.mid, hi.lo and lo.hi, a
// float32-accurate gram): the filter's width, about 2^-13 R below, only has
// to be small against the gaps between a query's nearest rows, and which
// rows survive is set by the seed bound U, not by that width (chip_smoke.py
// counts them: survivors_per_query); three pairs take half the MMAs, half the
// A-fragment registers and half the staged bytes of six.
//
// The error bound. Let a = q, b = k_j, u = 2^-24, P = sum_i |a_i b_i|, R =
// qn + n_j (exact sum), s = RN(R), x = s - 2 dot, so the plain v = RN(x);
// acc is the tensor core's result for the gram of the packed rows.
//   - the plain dot makes D rounded products and D - 1 rounded sums:
//     |dot - a.b| <= 32.01 u P at D <= 32 (fast: 15 u P over the bf16
//     products, each exact, at D <= 16);
//   - the tensor core's accumulation is not IEEE round-to-nearest (products
//     are aligned to the largest and truncated); allowed here: one MMA's
//     result differs from the exact sum of its accumulator input and its
//     products by at most 96 u times their absolute sum, about three times
//     the truncation model's 17 units of 2^-23. Chained over KC <= 6 MMAs
//     whose inputs hold at most P_G, the absolute sum of the products:
//     |acc - G| <= 96 KC u P_G (1 + 576 u). The card is held to this
//     premise by tests/test_torch_cuda.py::
//     test_split_gram_accumulation_within_the_bound (tests/csrc/
//     split_gram_probe.cu: these MMAs on rows built to trip the alignment;
//     on an H100 the largest |acc - G| was 5.3, 7.9 and 12.5 u P_G at
//     KC = 2, 3 and 6);
//   - exact mode, the split: |x - hi| <= 2^-8 |x|, |mid| <= 2^-8 (1 + 2^-8)
//     |x|, and r = x - hi - mid, |r| <= 2^-16 |x| (bf16 keeps 8 significant
//     bits). The dropped terms a.b - G = hi_a r_b + mid_a mid_b + r_a hi_b +
//     mid_a r_b + r_a mid_b + r_a r_b come to at most (3.0157 x 2^-16 +
//     2.01 x 2^-24) P <= 775 u P, and P_G <= (1 + 2^-8)^2 (1 + 2^-7) P <=
//     1.0157 P, so |acc - G| <= 586 u P;
//   - P <= (|a|^2 + |b|^2) / 2 and |a|^2 <= qn (1 + 33 u), so
//     2 |dot - acc| <= (32.01 + 775 + 586) (1 + 33 u) u R <= 1394 u R
//     (fast mode: (15 + 96) x 0.5079 (1 + 17 u) 2 u R <= 112.8 u R, the
//     bf16 rounding of the operands being the fast function's own);
//   - subnormals: split terms below bf16's normal range (2^-134 each),
//     inputs and products the tensor core may flush and products below f32's
//     normal range add at most 2^-116 + 2^-124 R to 2 |dot - acc| over D <= 32
//     terms (|x| <= (1 + x^2) / 2), and 2^-120 in the fast mode.
// The kernel folds the bound into one pair of floats a pair,
//   z_lo = RN(S_lo - 2 acc)  (one fma),  S_lo = RN(RN(RN(alpha qn) - tau) + RN(alpha n_j)),
//   z_hi = RN(S_hi - 2 acc),             S_hi = RN(RN(RN(beta qn) + tau) + RN(beta n_j)),
//   alpha = 1 - M, beta = 1 + M, tau = 2^-96,
//   M = 2^-13 = 2048 u in the exact mode, 2^-17 = 128 u in the fast mode.
// S_lo <= alpha R (1 + u)^3 - tau (1 - u)^2 and s >= R (1 - u), so
//   x - (S_lo - 2 acc) >= (2044 - 1394) u R + tau (1 - u)^2 - 2^-116 - 2^-124 R > 0
// (fast: (124 - 112.8) u R + ... > 0), and (S_hi - 2 acc) - x > 0 likewise
// from S_hi >= beta R (1 - u)^3 + tau (1 - u)^2 and s <= R (1 + u). So
// z_lo <= x <= z_hi before the fma's rounding, and as RN is monotonic,
// z_lo <= v <= z_hi. The exact margin is 1.47 times the largest error it
// covers. Non-finite operands: a row or query whose norm is inf or NaN has
// a plain v of inf or NaN (never a winner) and a z_hi of inf or NaN (never a
// bound); z_lo = +inf implies s = inf or x past the largest float, so v =
// inf. A masked row (a_j = +inf, the row staged as zeros) has z = +inf, or
// NaN for a query holding inf or NaN, and its plain v >= 3.4e38 never beats
// the start key.
//
// The filter. Skip row j of a query iff z_lo_j > U, an upper bound on some
// row's v, or z_lo_j >= T, the v of the smallest plain key the lane has
// rescored (3.4e38 at the start key (3.4e38, 0)): a lane meets its columns
// in ascending order, so such a row can neither win nor tie earlier.
//   - exact mode: on v itself, negative values included. Two rows whose v
//     are both negative and differ: the more negative wins;
//   - fast mode: on max(v, 0), its key. Every row with v <= 0 ties at 0 and
//     the lower column wins, so T = 0 rules out every later row of the lane
//     and U counts as max(U, 0).
// U comes from a seed launch: the same scan over every 32nd row, each
// query's minimum of z_hi (fast: of max(z_hi, 0)), reduced across the grid
// with atomicMin on the float's bits in an order-preserving map (negative
// bits flipped, the sign bit of a non-negative set), 0xffffffff (a NaN, no
// bound) at the start. One compare does both tests: skip iff z_lo >= min(T,
// next float above U); a NaN z_lo survives. A lane's U and T are never below
// the global ones, so the winner always survives. Every survivor gets the
// plain key: the exact mode from the staged f32 query, the f32 row (read
// from global memory) and their f32 norms, the fast mode from its bf16
// operands; v, NaN -> inf, the fast mode's clamp, then a 64-bit key, the
// ordered bits of v high and the column low (v is never -0: RN(s - t) is +0
// where s = t, and s >= +0). The 4 lanes of a query row take the minimum of their keys
// (__shfl_xor_sync) and write part_key; the fold takes each query's minimum
// over the splits, which is the first minimum, and finishes the distance.
// The filter's survivors, every (query, row) pair rescored, are counted into
// `survivors` when the caller passes a counter.
//
// The FP32 scan (best_match_scan_kernel), one query a thread against a
// staged tile, takes two cases: the fast mode at 16 < D <= 32 (the
// bf16-rounded gram, beyond the filter's one k-chunk), and the exact mode at
// D = 10 on fewer than 2^24 (query, row) pairs (matcher_kernel.fp32_scan),
// where it is faster: path A's relocalization, 128 queries against a
// 1,024-row map, takes 0.013 ms on the card in a scan and a fold against the
// filter's 0.038 in a memset, a seed pass, a scan and a fold (PERF.md §6).
#include <cuda_bf16.h>

#include "common.cuh"

#define VO_BIG 3.4e38f
#define VO_MAX_D 32
#define BM_TQ 128   // queries (threads) a CTA of the FP32 scan
#define BM_TK 256   // database rows staged per tile

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// |x|^2 over x[0 .. d) in descriptor order; the loop runs over the array's
// size, so a run-time d leaves x in registers.
template <int DT, int N>
__device__ __forceinline__ float ordered_sq_norm(const float (&x)[N], int d) {
  float acc = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) {
    if (k >= (DT > 0 ? DT : d)) break;
    acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  }
  return acc;
}

// A float's bits in an order that unsigned comparison keeps: a negative's
// bits flipped, a non-negative's sign bit set. 0xffffffff decodes to a NaN.
__device__ __forceinline__ unsigned int ordered_bits(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long pack_key(float v, int col) {
  return (static_cast<unsigned long long>(ordered_bits(v)) << 32) |
         static_cast<unsigned int>(col);
}

// The FP32 scan of one (query tile, database split), one query a thread
// against the tile's rows staged in shared memory: each query's 64-bit key
// into part_key. Fast mode (at 16 < D <= 32): the bf16-rounded gram, clamped,
// NaN -> inf, the smallest key. Exact mode (at D = 10 on small problems):
// the first minimum of the unclamped v with a strict '<' from (3.4e38, 0),
// so a NaN or inf v never wins.
template <int DT, bool EXACT>
__global__ void __launch_bounds__(BM_TQ)
    best_match_scan_kernel(const float* __restrict__ queries, const float* __restrict__ db,
                           const uint8_t* __restrict__ db_mask,
                           unsigned long long* __restrict__ part_key, int nq, int nk, int d_rt,
                           int rows_per_split) {
  constexpr int N = DT > 0 ? DT : VO_MAX_D;
  const int d = DT > 0 ? DT : d_rt;
  const int rs = d + 1;  // staged row: descriptor, then its norm term
  extern __shared__ float tile[];

  const int qi = blockIdx.x * BM_TQ + threadIdx.x;
  const bool has_q = qi < nq;
  float x[N];
  float qn = 0.0f;
  if (has_q) {
#pragma unroll
    for (int k = 0; k < d; ++k) x[k] = queries[static_cast<long long>(qi) * d + k];
    qn = ordered_sq_norm<DT>(x, d);
    if (!EXACT) {
#pragma unroll
      for (int k = 0; k < d; ++k) x[k] = bf16_round(x[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < d; ++k) x[k] = 0.0f;
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
        float y[N];
#pragma unroll
        for (int k = 0; k < d; ++k) y[k] = src[k];
        dst[d] = ordered_sq_norm<DT>(y, d);
#pragma unroll
        for (int k = 0; k < d; ++k) dst[k] = EXACT ? y[k] : bf16_round(y[k]);
      } else {
#pragma unroll
        for (int k = 0; k < d; ++k) dst[k] = 0.0f;
        dst[d] = VO_BIG;
      }
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float* y = tile + r * rs;
      float dot = __fmul_rn(x[0], y[0]);
#pragma unroll
      for (int k = 1; k < d; ++k) dot = __fadd_rn(dot, __fmul_rn(x[k], y[k]));
      float v = __fsub_rn(__fadd_rn(qn, y[d]), __fmul_rn(2.0f, dot));
      if (EXACT) {
        if (v < best) {
          best = v;
          arg = base + r;
        }
      } else {
        v = isnan(v) ? INFINITY : (v < 0.0f ? 0.0f : v);
        const unsigned long long key = pack_key(v, base + r);
        if (key < best_key) best_key = key;
      }
    }
  }
  if (has_q) {
    part_key[static_cast<long long>(blockIdx.y) * nq + qi] = EXACT ? pack_key(best, arg) : best_key;
  }
}

#define TC_FAST_MARGIN 0x1p-17f    // M of the fast mode's bound: 128 u
#define TC_EXACT_MARGIN 0x1p-13f   // M of the exact mode's bound: 2048 u
#define TC_TAU 0x1p-96f            // the bounds' absolute margin (subnormals)
#define TC_SEED_STRIDE 32          // the seed pass reads every 32nd row
#define TC_TQ 256                  // queries (threads) a CTA of the tensor-core scan
#define TC_PAIRS 3                 // the exact mode's term pairs
static_assert(TC_TQ == BM_TK, "a thread stages one row of a tile");

// k-chunks a packed row may use: the fast mode one, the exact mode
// ceil(3 D / 16), at most 6 at D <= 32 where D is known only at run time.
template <int DT, bool EXACT>
struct TcShape {
  static constexpr int kMaxChunks = !EXACT ? 1 : (DT > 0 ? (TC_PAIRS * DT + 15) / 16 : 6);
  static constexpr int kRowValues = DT > 0 ? DT : (EXACT ? VO_MAX_D : 16);
};

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

// Term pair p's factor of x on the query or the database side: hi = bf16(x),
// or mid = bf16(x - hi) for pair 1 on the query side and pair 2 on the
// database side.
template <bool QUERY_SIDE>
__device__ __forceinline__ unsigned short split_term(float x, int p) {
  if (p != (QUERY_SIDE ? 1 : 2)) return bf16_bits(x);
  return bf16_bits(__fsub_rn(x, bf16_round(x)));
}

// Element e of a packed row of d values x (see the header): 0 past the terms.
template <bool EXACT, bool QUERY_SIDE>
__device__ __forceinline__ unsigned short packed_element(const float* x, int e, int d) {
  if (!EXACT) return e < d ? bf16_bits(x[e]) : 0;
  const int p = e / d, k = e - p * d;
  return p < TC_PAIRS ? split_term<QUERY_SIDE>(x[k], p) : 0;
}

// Element k of row r of a staged chunk (halves swapped on every other group
// of 4 rows).
__device__ __forceinline__ unsigned short& staged(unsigned short (*chunk)[16], int r, int k) {
  return chunk[r][(((k >> 3) ^ (r >> 2)) & 1) * 8 + (k & 7)];
}

// Row `row` of the database (zeros unless in range and live) -> y; returns live.
template <int DT, int YN>
__device__ __forceinline__ bool load_row(const float* __restrict__ db,
                                         const uint8_t* __restrict__ db_mask, long long row,
                                         bool in_range, int d, float (&y)[YN]) {
  const bool live = in_range && db_mask[row];
#pragma unroll
  for (int k = 0; k < YN; ++k) y[k] = (live && k < (DT > 0 ? DT : d)) ? db[row * d + k] : 0.0f;
  return live;
}

// Row r of the tile as packed chunks into ks[0 .. chunks). With D known at
// compile time (or the fast mode's fixed positions) each chunk is built in
// registers and stored as two 16-byte words; the exact mode at a run-time D
// stores element by element, the slots past 3 D having been zeroed once.
template <int DT, bool EXACT, int YN>
__device__ __forceinline__ void stage_row(unsigned short (*ks)[BM_TK][16], int r,
                                          const float (&y)[YN], int d) {
  if (EXACT && DT == 0) {
#pragma unroll
    for (int p = 0; p < TC_PAIRS; ++p) {
#pragma unroll
      for (int k = 0; k < YN; ++k) {
        if (k >= d) break;
        const int e = p * d + k;
        staged(ks[e >> 4], r, e & 15) = split_term<false>(y[k], p);
      }
    }
    return;
  }
  constexpr int KC = TcShape<DT, EXACT>::kMaxChunks;
  constexpr int DP = DT > 0 ? DT : YN;   // the fast mode's y is zero past d
  const int sw = (r >> 2) & 1;
#pragma unroll
  for (int ch = 0; ch < KC; ++ch) {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = packed_element<EXACT, false>(y, ch * 16 + 2 * i, DP) |
             (static_cast<uint32_t>(packed_element<EXACT, false>(y, ch * 16 + 2 * i + 1, DP))
              << 16);
    }
    uint4* dst = reinterpret_cast<uint4*>(ks[ch][r]);
    dst[sw] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[sw ^ 1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// c = A B (ACC: c += A B) for one m16n8k16 tile, bf16 in, f32 accumulators.
template <bool ACC>
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  if (ACC) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
  }
}

// The tensor-core scan over one (query tile, database split); see the
// header. Warp w holds local queries w*32 + m*16 + {g, g+8} (m = 0, 1;
// g = lane / 4) as its lane's query slots q = 2m + h.
// SEED: the split runs over rows 0, stride, 2 stride, ...; each query's
// minimum of z_hi (fast: of max(z_hi, 0)) goes into seed[qi] (ordered bits,
// atomicMin; the caller fills seed with 0xff bytes). Otherwise: the filter
// against the lane's T and the seed U, the plain key on the survivors, and
// each query's split key into part_key.
template <int DT, bool SEED, bool EXACT>
__global__ void __launch_bounds__(TC_TQ)
    best_match_tc_kernel(const float* __restrict__ queries, const float* __restrict__ db,
                         const uint8_t* __restrict__ db_mask,
                         unsigned long long* __restrict__ part_key, unsigned int* __restrict__ seed,
                         unsigned long long* __restrict__ survivors, int nq, int nk, int d_rt,
                         int rows_per_split, int stride) {
  using Shape = TcShape<DT, EXACT>;
  constexpr int KC = Shape::kMaxChunks;
  constexpr int YN = Shape::kRowValues;
  const int d = DT > 0 ? DT : d_rt;
  const int chunks = EXACT && DT == 0 ? (TC_PAIRS * d + 15) / 16 : KC;
  // k_s: the packed chunks of the tile's rows, `chunks` x BM_TK x 16 bf16;
  // q_s: the CTA's queries, TC_TQ x d f32 (the A fragments' and the
  // rescores' operands).
  extern __shared__ __align__(16) unsigned short tc_smem[];
  unsigned short(*k_s)[BM_TK][16] = reinterpret_cast<unsigned short(*)[BM_TK][16]>(tc_smem);
  float* q_s = reinterpret_cast<float*>(tc_smem + chunks * BM_TK * 16);
  __shared__ float qn_s[TC_TQ];               // f32 norms of the unrounded queries
  __shared__ __align__(16) float n_s[BM_TK];  // f32 norms, 3.4e38 masked
  __shared__ __align__(16) float a_s[BM_TK];  // RN(alpha or beta n_j), +inf masked

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  {
    const int qi = blockIdx.x * TC_TQ + tid;
    float x[YN];
#pragma unroll
    for (int k = 0; k < YN; ++k) {
      x[k] = (qi < nq && k < d) ? queries[static_cast<long long>(qi) * d + k] : 0.0f;
    }
    qn_s[tid] = ordered_sq_norm<DT>(x, d);
#pragma unroll
    for (int k = 0; k < YN; ++k) {
      if (k < d) q_s[tid * d + k] = x[k];
    }
    if (EXACT && DT == 0) {   // the slots past 3 D stay zero
#pragma unroll
      for (int ch = 0; ch < KC; ++ch) {
        if (ch < chunks) {
          uint4* dst = reinterpret_cast<uint4*>(k_s[ch][tid]);
          dst[0] = dst[1] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  }
  __syncthreads();

  const float margin = EXACT ? TC_EXACT_MARGIN : TC_FAST_MARGIN;
  const float scale = SEED ? 1.0f + margin : 1.0f - margin;
  // Per query slot: aq, the query's share of the bound; thr, the filter's
  // threshold min(T, next float above U) (fast: T or -inf at T = 0), or
  // SEED's running minimum of z_hi; us, the next float above the seed U;
  // best, the plain key. a: the A fragments, chunk by chunk.
  uint32_t a[2][KC][4];
  float aq[4], thr[4], us[4];
  unsigned long long best[4];
  bool has_q[4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * m + h, ql = warp * 32 + m * 16 + g + 8 * h;
      const int qi = blockIdx.x * TC_TQ + ql;
      has_q[q] = qi < nq;
      const float* qrow = q_s + ql * d;
#pragma unroll
      for (int ch = 0; ch < KC; ++ch) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t word = 0;
          if (has_q[q] && ch < chunks) {
            const int e = ch * 16 + half * 8 + 2 * t;
            word = packed_element<EXACT, true>(qrow, e, d) |
                   (static_cast<uint32_t>(packed_element<EXACT, true>(qrow, e + 1, d)) << 16);
          }
          a[m][ch][h + 2 * half] = word;
        }
      }
      best[q] = pack_key(VO_BIG, 0);
      aq[q] = SEED ? __fadd_rn(__fmul_rn(scale, qn_s[ql]), TC_TAU)
                   : __fsub_rn(__fmul_rn(scale, qn_s[ql]), TC_TAU);
      if (SEED) {
        thr[q] = us[q] = INFINITY;
      } else {
        // A NaN (no seed row gave a bound) leaves T alone; an absent query
        // rules every row out.
        us[q] = has_q[q] ? nextafterf(from_ordered(seed[qi]), INFINITY) : -INFINITY;
        thr[q] = fminf(VO_BIG, us[q]);
      }
    }
  }

  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(nk, lo + rows_per_split);
  unsigned int rescored = 0;
  // Thread tid stages row tid of each tile; the next tile's row is loaded
  // into registers before the current tile's products.
  float y[YN];
  bool live = load_row<DT>(db, db_mask, static_cast<long long>(lo + tid) * stride, lo + tid < hi,
                           d, y);
  for (int base = lo; base < hi; base += BM_TK) {
    const int rows = min(BM_TK, hi - base);
    __syncthreads();  // the previous tile has been read by every thread
    {
      const float n = ordered_sq_norm<DT>(y, d);
      n_s[tid] = live ? n : VO_BIG;
      a_s[tid] = live ? __fmul_rn(scale, n) : INFINITY;
      stage_row<DT, EXACT>(k_s, tid, y, d);
    }
    __syncthreads();
    const int next = base + BM_TK + tid;
    live = load_row<DT>(db, db_mask, static_cast<long long>(next) * stride, next < hi, d, y);
    for (int n0 = 0; n0 < rows; n0 += 16) {
      float c[2][2][4];
#pragma unroll
      for (int ch = 0; ch < KC; ++ch) {
        if (ch >= chunks) break;
        // Lane L addresses row n0 + (L / 16) * 8 + L % 8, half (L / 8) % 2.
        uint32_t b[4];
        {
          const int r = n0 + ((lane >> 4) << 3) + (lane & 7);
          const int half = ((lane >> 3) ^ (r >> 2)) & 1;
          const unsigned addr =
              static_cast<unsigned>(__cvta_generic_to_shared(&k_s[ch][r][half * 8]));
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                       : "r"(addr));
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (ch == 0) {
              mma_bf16_16816<false>(c[nt][m], a[m][ch], b[2 * nt], b[2 * nt + 1]);
            } else {
              mma_bf16_16816<true>(c[nt][m], a[m][ch], b[2 * nt], b[2 * nt + 1]);
            }
          }
        }
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
              const float* qrow = q_s + ql * d;
              float dot;
              if (EXACT) {
                // A masked row's plain v is >= 3.4e38: never below the start key.
                if (!db_mask[base + r]) continue;
                const float* krow = db + static_cast<long long>(base + r) * d;
                dot = __fmul_rn(qrow[0], krow[0]);
                for (int k = 1; k < d; ++k) dot = __fadd_rn(dot, __fmul_rn(qrow[k], krow[k]));
              } else {
                dot = __fmul_rn(bf16_round(qrow[0]), bf16_value(staged(k_s[0], r, 0)));
                for (int k = 1; k < d; ++k) {
                  dot = __fadd_rn(dot,
                                  __fmul_rn(bf16_round(qrow[k]), bf16_value(staged(k_s[0], r, k))));
                }
              }
              float v = __fsub_rn(__fadd_rn(qn_s[ql], n_s[r]), __fmul_rn(2.0f, dot));
              v = isnan(v) ? INFINITY : (EXACT || v >= 0.0f ? v : 0.0f);
              const unsigned long long key = pack_key(v, base + r);
              if (key < best[q]) {
                best[q] = key;
                // Fast: T = 0 rules out every later row of this lane.
                thr[q] = fminf(EXACT || v > 0.0f ? v : -INFINITY, us[q]);
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
      float u = EXACT ? thr[q] : fmaxf(thr[q], 0.0f);
      u = fminf(u, __shfl_xor_sync(0xffffffffu, u, 1));
      u = fminf(u, __shfl_xor_sync(0xffffffffu, u, 2));
      if (t == 0 && qi < nq && u < INFINITY) atomicMin(&seed[qi], ordered_bits(u));
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

// The seed pass, then the filtered scan.
template <int DT, bool EXACT>
static int launch_tc(const float* queries, const float* db, const uint8_t* db_mask,
                     unsigned long long* part_key, unsigned int* seed,
                     unsigned long long* survivors, int nq, int nk, int d, int splits,
                     int rows_per_split, cudaStream_t st) {
  const int chunks =
      EXACT && DT == 0 ? (TC_PAIRS * d + 15) / 16 : TcShape<DT, EXACT>::kMaxChunks;
  const size_t smem = static_cast<size_t>(chunks) * BM_TK * 16 * sizeof(unsigned short) +
                      static_cast<size_t>(TC_TQ) * d * sizeof(float);
  if (smem > 32768) {   // near 48 KB with the static arrays: opt in
    cudaError_t err = cudaFuncSetAttribute(best_match_tc_kernel<DT, true, EXACT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(best_match_tc_kernel<DT, false, EXACT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int q_tiles = (nq + TC_TQ - 1) / TC_TQ;
  const int seed_rows = (nk + TC_SEED_STRIDE - 1) / TC_SEED_STRIDE;
  const int seed_splits = min(splits, (seed_rows + BM_TK - 1) / BM_TK);
  int seed_per_split = (seed_rows + seed_splits - 1) / seed_splits;
  seed_per_split = ((seed_per_split + BM_TK - 1) / BM_TK) * BM_TK;
  cudaMemsetAsync(seed, 0xff, static_cast<size_t>(nq) * sizeof(unsigned int), st);
  best_match_tc_kernel<DT, true, EXACT><<<dim3(q_tiles, seed_splits), TC_TQ, smem, st>>>(
      queries, db, db_mask, part_key, seed, nullptr, nq, seed_rows, d, seed_per_split,
      TC_SEED_STRIDE);
  best_match_tc_kernel<DT, false, EXACT><<<dim3(q_tiles, splits), TC_TQ, smem, st>>>(
      queries, db, db_mask, part_key, seed, survivors, nq, nk, d, rows_per_split, 1);
  return vo_launch_status();
}

// Fold the splits per query (the minimum key, so the first minimum) and
// finish the distance.
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
  unsigned long long best_key = pack_key(VO_BIG, 0);
  for (int s = 0; s < splits; ++s) {
    const unsigned long long key = part_key[static_cast<long long>(s) * nq + qi];
    if (key < best_key) best_key = key;
  }
  const int arg = static_cast<int>(best_key & 0xffffffffull);
  float best;
  if (FAST) {
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
    best = from_ordered(static_cast<unsigned int>(best_key >> 32));
  }
  const float clamped = best < 0.0f ? 0.0f : best;  // keeps a NaN, like torch.clamp_min
  dist[qi] = q_mask[qi] ? clamped : VO_BIG;
  idx[qi] = arg;
}

// part_key: scratch of splits * nq 64-bit words, allocated by the caller;
// seed: nq 32-bit words for the tensor-core scan (the fast mode at D <= 16,
// the exact mode at any D), or null for the FP32 scan (the fast mode at any
// D, the exact mode at D = 10); the caller picks the route
// (matcher_kernel.fp32_scan); survivors: a device counter the tensor-core
// scan adds its rescored pairs to, or null.
VO_EXPORT int vo_best_match(const float* queries, const uint8_t* q_mask, const float* db,
                            const uint8_t* db_mask, unsigned long long* part_key,
                            unsigned int* seed, unsigned long long* survivors, float* dist,
                            int* idx, int nq, int nk, int d, int splits, int fast, void* stream) {
  if (nq <= 0) return 0;
  if (nk < 1 || d < 1 || d > VO_MAX_D || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rows_per_split = (nk + splits - 1) / splits;
  rows_per_split = ((rows_per_split + BM_TK - 1) / BM_TK) * BM_TK;
  int code;
  if (seed == nullptr) {   // the FP32 scan: the fast mode at any D, the exact mode at D = 10
    if (!fast && d != 10) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((nq + BM_TQ - 1) / BM_TQ, splits);
    const size_t smem = static_cast<size_t>(BM_TK) * (d + 1) * sizeof(float);
    if (fast) {
      best_match_scan_kernel<0, false><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                  nq, nk, d, rows_per_split);
    } else {
      best_match_scan_kernel<10, true><<<grid, BM_TQ, smem, st>>>(queries, db, db_mask, part_key,
                                                                  nq, nk, d, rows_per_split);
    }
    code = vo_launch_status();
  } else if (fast && d > 16) {   // one k-chunk holds 16 components
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (fast) {
    code = d == 10 ? launch_tc<10, false>(queries, db, db_mask, part_key, seed, survivors, nq, nk,
                                          d, splits, rows_per_split, st)
                   : launch_tc<0, false>(queries, db, db_mask, part_key, seed, survivors, nq, nk,
                                         d, splits, rows_per_split, st);
  } else {
    code = d == 10 ? launch_tc<10, true>(queries, db, db_mask, part_key, seed, survivors, nq, nk,
                                         d, splits, rows_per_split, st)
                   : launch_tc<0, true>(queries, db, db_mask, part_key, seed, survivors, nq, nk,
                                        d, splits, rows_per_split, st);
  }
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
