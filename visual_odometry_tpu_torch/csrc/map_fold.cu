// P2: the landmark-map fold of a whole call, landmark_map.merge_stream over B
// time-ordered streams of T rows (ops/kernels/map_kernel.py). Its plain
// version, models/landmark_map._merge_streams, gives the same four outputs
// bit for bit.
//
// Replaces no TPU kernel: the JAX package folds with two XLA sorts
// (visual_odometry_tpu/models/landmark_map.py:merge_stream, vmapped by its
// batched programs). The plain version is ~50 small PyTorch operations that
// wait for the card 9 times (nonzero, unique, bincount and four masks' counts
// read back, the host's True copied over), each wait draining the queue.
// Here the fold is four launches with no wait and no size read back: every
// shape comes from B, T, D and the capacity. A sequence's stream may come in
// two segments, H head rows (the bootstrap's seed, or a carried map) and
// T - H body rows (the tracked frames' triangulations), read in place where
// they lie, so the caller concatenates nothing.
//
// Semantics: a row's key is the bits of its appearance + 0.0f, the plain
// version's add (-0.0 becomes +0.0; a NaN takes the bits the card's add
// gives it). Live rows of one sequence with equal key bits are a group.
// Groups enter their sequence's map in first-row order, truncated at the
// capacity, each with its last row's raw point and its canonical key; the
// count is min(groups, capacity); empty slots hold 0 / +inf / false.
//
// Bound on this card: bytes. Each stream row is read once (12 B point, 4 D B
// key, 1 B mask: 53 B at D = 10) and each slot written once: 0.8 MB at
// 1 x 15,360 rows, 52 MB at 64 x 15,360, 28 MB at 1 x 523,264 (0.24 / 15.6 /
// 8.3 us at 3.35 TB/s). A sort moves every row several times; a hash on
// exact keys reads a row's key twice (hash, then a compare) from L1/L2 and
// touches its table entry with a few atomics.
//
// Design: per sequence an open-addressing table of P entries, P the smallest
// power of two >= 2 T (it never fills, and at most half full its linear
// probes stay short), two int32 words an entry: the group's first row
// (claimed from EMPTY by atomicCAS, then lowered by atomicMin) and its last
// row (atomicMax). The first word only ever holds rows of its entry's key, so
// a row compares its key with whichever row the word holds. Where a key lands
// depends on the order the rows arrive in; its first and last rows do not.
//   1. fill: the tables to (EMPTY, -1), the outputs to 0 / +inf / false, the
//      counts to 0;
//   2. insert: one live row a thread hashes its key, probes, and records its
//      entry;
//   3. count: tiles of 1,024 rows of a sequence, a row a thread; a row heads
//      its group when its entry's first row is itself; a tile's heads are
//      counted (__syncthreads_count);
//   4. write: each tile adds its sequence's earlier tiles' counts (integers:
//      any order is exact), ranks its heads by a block scan in row order, and
//      a head of rank < capacity writes its slot: the last row's point, its
//      own canonical key, true. The sequence's last tile writes the count.
// Scratch (the wrapper's torch.empty): 8 P + 4 T + 4 ceil(T / 1,024) bytes a
// sequence, 16.8 MB of table at 64 x 15,360 rows and 8.4 MB at 1 x 523,264,
// both inside the 50 MB L2.
#include "common.cuh"

namespace {

constexpr int kEmpty = 0x7fffffff;  // a free entry's first word: no row is this large
constexpr int kTile = 1024;         // rows a tile: threads a CTA of the count and write passes
constexpr int kThreads = 256;       // threads a CTA of the fill and insert passes
constexpr int kFillBlocks = 2048;   // the fill's grid-stride CTAs at most
constexpr unsigned kFull = 0xffffffffu;

struct Fold {
  const float* head_points;        // (B, H, 3)
  const float* head_apps;          // (B, H, D)
  const unsigned char* head_mask;  // (B, H)
  const float* points;             // (B, T - H, 3)
  const float* apps;               // (B, T - H, D)
  const unsigned char* mask;       // (B, T - H)
  float* out_points;          // (B, C, 3)
  float* out_apps;            // (B, C, D)
  unsigned char* out_valid;   // (B, C)
  int* count;                 // (B,)
  int* table;                 // (B, P, 2): first row, last row
  int* entry;                 // (B, T): a live row's entry in its sequence's table
  int* tile_heads;            // (B, tiles)
  int b, t, h, d, capacity, p, tiles;
};

// Row `row` (0 <= row < T) of sequence s: its index in its segment, and
// whether that segment is the head.
__device__ __forceinline__ long long segment_row(const Fold& f, int s, int row, bool& in_head) {
  in_head = row < f.h;
  return in_head ? static_cast<long long>(s) * f.h + row
                 : static_cast<long long>(s) * (f.t - f.h) + (row - f.h);
}

__device__ __forceinline__ const float* key_of(const Fold& f, int s, int row) {
  bool in_head;
  const long long i = segment_row(f, s, row, in_head);
  return (in_head ? f.head_apps : f.apps) + i * f.d;
}

__device__ __forceinline__ const unsigned* point_of(const Fold& f, int s, int row) {
  bool in_head;
  const long long i = segment_row(f, s, row, in_head);
  return reinterpret_cast<const unsigned*>(in_head ? f.head_points : f.points) + i * 3;
}

__device__ __forceinline__ bool live(const Fold& f, int s, int row) {
  bool in_head;
  const long long i = segment_row(f, s, row, in_head);
  return (in_head ? f.head_mask : f.mask)[i] != 0;
}

// A canonical key word: the plain version's appearances + 0.0.
__device__ __forceinline__ unsigned key_word(const float* row, int k) {
  return __float_as_uint(__fadd_rn(__ldg(row + k), 0.0f));
}

__device__ __forceinline__ unsigned rotl(unsigned x, int r) { return (x << r) | (x >> (32 - r)); }

// MurmurHash3's 32-bit body and finalizer over the key's D words.
__device__ unsigned hash_key(const float* row, int d) {
  unsigned h = 0x9747b28cu;
  for (int k = 0; k < d; ++k) {
    const unsigned w = rotl(key_word(row, k) * 0xcc9e2d51u, 15) * 0x1b873593u;
    h = rotl(h ^ w, 13) * 5u + 0xe6546b64u;
  }
  h ^= static_cast<unsigned>(d) * 4u;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

__device__ bool same_key(const float* a, const float* b, int d) {
  for (int k = 0; k < d; ++k) {
    if (key_word(a, k) != key_word(b, k)) return false;
  }
  return true;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Whether row `row` of sequence s is live and heads its group.
__device__ __forceinline__ bool is_head(const Fold& f, int s, int row) {
  if (row >= f.t) return false;
  if (!live(f, s, row)) return false;
  const long long r = static_cast<long long>(s) * f.t + row;
  return f.table[2 * (static_cast<long long>(s) * f.p + f.entry[r])] == row;
}

__global__ void __launch_bounds__(kThreads) fill_kernel(Fold f) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int2* table = reinterpret_cast<int2*>(f.table);
  const long long entries = static_cast<long long>(f.b) * f.p;
  for (long long i = i0; i < entries; i += stride) table[i] = make_int2(kEmpty, -1);
  const long long slots = static_cast<long long>(f.b) * f.capacity;
  for (long long i = i0; i < 3 * slots; i += stride) f.out_points[i] = 0.0f;
  for (long long i = i0; i < slots * f.d; i += stride) f.out_apps[i] = __int_as_float(0x7f800000);
  for (long long i = i0; i < slots; i += stride) f.out_valid[i] = 0;
  for (long long i = i0; i < f.b; i += stride) f.count[i] = 0;
}

__global__ void __launch_bounds__(kThreads) insert_kernel(Fold f) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= static_cast<long long>(f.b) * f.t) return;
  const int s = static_cast<int>(r / f.t);
  const int row = static_cast<int>(r - static_cast<long long>(s) * f.t);
  if (!live(f, s, row)) return;
  const float* key = key_of(f, s, row);
  int* table = f.table + 2LL * s * f.p;
  const unsigned wrap = static_cast<unsigned>(f.p) - 1u;
  unsigned h = hash_key(key, f.d) & wrap;
  for (;;) {
    int* first = table + 2 * h;
    int held = __ldcg(first);  // L2, where the atomics land: never older than a claim
    if (held == kEmpty) {
      held = atomicCAS(first, kEmpty, row);
      if (held == kEmpty) break;  // claimed: this row is its group's first so far
    }
    if (same_key(key_of(f, s, held), key, f.d)) {
      // A claimed first word only falls, so a held row at or below this
      // one leaves nothing to lower.
      if (row < held) atomicMin(first, row);
      break;
    }
    h = (h + 1u) & wrap;
  }
  int* last = table + 2 * h + 1;
  if (__ldcg(last) < row) atomicMax(last, row);  // the last word only rises
  f.entry[r] = static_cast<int>(h);
}

__global__ void __launch_bounds__(kTile) count_kernel(Fold f) {
  const int s = blockIdx.x / f.tiles;
  const int tile = blockIdx.x - s * f.tiles;
  const int heads = __syncthreads_count(is_head(f, s, tile * kTile + threadIdx.x));
  if (threadIdx.x == 0) f.tile_heads[blockIdx.x] = heads;
}

__global__ void __launch_bounds__(kTile) write_kernel(Fold f) {
  __shared__ int before_w[kTile / 32], total_w[kTile / 32], rank_w[kTile / 32];
  __shared__ int total_s;
  const int s = blockIdx.x / f.tiles;
  const int tile = blockIdx.x - s * f.tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* heads_of = f.tile_heads + static_cast<long long>(s) * f.tiles;
  int before = 0, total = 0;
  for (int j = threadIdx.x; j < f.tiles; j += kTile) {
    const int n = heads_of[j];
    total += n;
    if (j < tile) before += n;
  }
  before = warp_sum(before);
  total = warp_sum(total);
  const int row = tile * kTile + threadIdx.x;
  const bool head = is_head(f, s, row);
  const unsigned ballot = __ballot_sync(kFull, head);
  if (lane == 0) {
    before_w[warp] = before;
    total_w[warp] = total;
    rank_w[warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {
    const int heads = rank_w[lane];
    int incl = heads;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int base = warp_sum(before_w[lane]);
    const int all = warp_sum(total_w[lane]);
    rank_w[lane] = base + incl - heads;  // the rank of the warp's first head
    if (lane == 0) total_s = all;
  }
  __syncthreads();
  if (head) {
    const int rank = rank_w[warp] + __popc(ballot & ((1u << lane) - 1u));
    if (rank < f.capacity) {
      const long long r = static_cast<long long>(s) * f.t + row;
      const int last = f.table[2 * (static_cast<long long>(s) * f.p + f.entry[r]) + 1];
      const unsigned* pts = point_of(f, s, last);
      const float* key = key_of(f, s, row);
      const long long slot = static_cast<long long>(s) * f.capacity + rank;
      unsigned* out_pts = reinterpret_cast<unsigned*>(f.out_points);
      unsigned* out_apps = reinterpret_cast<unsigned*>(f.out_apps);
      for (int k = 0; k < 3; ++k) out_pts[slot * 3 + k] = pts[k];
      for (int k = 0; k < f.d; ++k) out_apps[slot * f.d + k] = key_word(key, k);
      f.out_valid[slot] = 1;
    }
  }
  if (tile == f.tiles - 1 && threadIdx.x == 0) f.count[s] = min(total_s, f.capacity);
}

}  // namespace

// The stream: H head rows then T - H body rows a sequence. scratch: 2 B P +
// B T + B ceil(T / 1,024) int32 words (table, entries, tile counts); p a
// power of two >= 2 T.
VO_EXPORT int vo_map_fold(const float* head_points, const float* head_apps,
                          const unsigned char* head_mask, const float* points, const float* apps,
                          const unsigned char* mask, float* out_points, float* out_apps,
                          unsigned char* out_valid, int* count, int* scratch, int b, int t, int h,
                          int d, int capacity, int p, void* stream) {
  if (b <= 0) return 0;
  if (t < 0 || h < 0 || h > t || d <= 0 || capacity < 0 || p <= 0 || (p & (p - 1)) != 0 ||
      static_cast<long long>(p) < 2LL * t || static_cast<long long>(b) * p > (1LL << 30) ||
      static_cast<long long>(b) * t > (1LL << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (t + kTile - 1) / kTile;
  Fold f{head_points, head_apps, head_mask, points, apps, mask, out_points, out_apps, out_valid,
         count, scratch, scratch + 2LL * b * p,
         scratch + 2LL * b * p + static_cast<long long>(b) * t, b, t, h, d, capacity, p, tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long entries = static_cast<long long>(b) * p;
  const long long words = static_cast<long long>(b) * capacity * d;
  const long long fill_blocks = ((entries > words ? entries : words) + kThreads - 1) / kThreads;
  fill_kernel<<<static_cast<unsigned>(fill_blocks < kFillBlocks ? fill_blocks : kFillBlocks),
                kThreads, 0, st>>>(f);
  if (t == 0) return vo_launch_status();
  const long long rows = static_cast<long long>(b) * t;
  insert_kernel<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads, 0, st>>>(f);
  const long long tile_blocks = static_cast<long long>(b) * tiles;
  if (tile_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  count_kernel<<<static_cast<unsigned>(tile_blocks), kTile, 0, st>>>(f);
  write_kernel<<<static_cast<unsigned>(tile_blocks), kTile, 0, st>>>(f);
  return vo_launch_status();
}
