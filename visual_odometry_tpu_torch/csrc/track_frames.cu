// K4 and K5: the whole tracked-frame loop of one sequence in one launch, for
// the SE(3) estimation group (K4) and the planar one (K5, est_SE2). K8: the
// same loop over N independent sequences in one launch, both groups.
//
// Replaces visual_odometry_tpu/ops/pallas/frame_kernel.py:track_frames_fused
// (_run_batched, body _kernel) with picp_kernel.py:gn_loop inside, and the same
// call site with planar=True and gn_loop_se2 inside. Per frame:
//   1. world join: each lane takes the first candidate of its precomputed
//      chain (K2) whose carried triangulation is valid, moved into the
//      previous camera by the carried pose (vo_complete.cpp:52-66, 159);
//   2. Gauss-Newton projective ICP from identity (or the carried pose with
//      warm_start) with the tolerance early exit (gn_loop.cuh): SE(3) sums 30
//      lane terms a round and solves 6x6 on the Euler chart
//      (picp_solver.cpp:25-112, utils.h:73-78); planar sums 12 and applies the
//      3-DoF increment conjugated through the camera mount;
//   3. mid-point triangulation in previous-frame coordinates with the
//      determinant and finiteness guards (utils.cpp:36-76);
//   4. the pose, the stats row [chi_in, chi_out, n_in, sum(weight)], the
//      number of GN rounds the frame ran (one int32 store) and the
//      triangulation rows.
//
// Bound on this card: latency, not bytes or FLOPs. The frames and the GN
// rounds inside them are a chain of dependent steps, each a block-wide
// reduction followed by a small solve on one thread (gn_loop.cuh says what a
// round costs and how it is kept short). Design: one CTA (or one cluster,
// below) per sequence, one thread per correspondence lane (S <= 1024), the
// loop over frames inside the kernel. Pose and triangulation stay resident in shared memory for the
// whole sequence; the TPU kernel's VMEM frame blocking has no counterpart.
// The carried triangulation lives in two ping-pong buffers: frame k's join
// reads frame k-1's rows while frame k's triangulation writes the other
// buffer, so one barrier per frame orders them. A frame's lane inputs (its
// two pixel rows, validity and the first two levels of its join chain) do
// not depend on the frames before it, so each thread loads frame k+1's into
// registers when frame k starts, and their global-memory latency passes
// under frame k's GN loop. PLANAR is a template parameter, so each group
// compiles to its own kernel and K4 pays nothing for K5.
//
// A wide sequence runs on a thread block cluster (launch_track_frames picks
// 4 CTAs of 256 threads at S = 1,024, 2 at S = 256): CTA r takes lanes
// r * 256 .. r * 256 + 255, which are the same warps as one CTA's, and keeps
// the whole carried triangulation; each lane writes its new row into every
// CTA's buffer through distributed shared memory, and the cluster barrier at
// the frame's end orders them before the next join. Inside a round the warp
// partials cross the cluster the same way (gn_loop.cuh gn_solve), and every
// CTA folds them in warp order and solves, so all hold the same pose bits.
// On an H100 80GB HBM3 (700 W), path B's round fell from ~7,500 cycles on one
// CTA to ~5,100 (chip_ab.py phases): the lane terms and warp sums of 1,024
// lanes run on four SMs for a cluster barrier's ~1,300 cycles. A CTA of at
// most 256 threads is compiled for 255 registers a thread, where a round's
// 32 live terms do not spill; a CTA of up to 1,024 (S not split) gets 64.
//
// The expressions keep the TPU kernel's operation order term by term and the
// library is built with --fmad=false; the plain PyTorch version
// (ops/kernels/frame_kernel.track_frames_plain) also adds the lane sums in
// the kernel's order, takes a correctly rounded sqrt and takes sin/cos from
// the card's libm, so the two agree bit for bit on the card.
//
// K8 replaces frame_kernel.py:track_frames_fused_serving (body _kernel_serving)
// with picp_kernel.py:gn_loop_batched / gn_loop_se2_batched inside. The TPU
// kernel lock-steps a group of sequences on the sublane axis of every tile and
// freezes the converged ones, because a TPU core runs grid rows one after
// another. Here blockIdx.x is the sequence: the N CTAs run side by side on the
// card's SMs, each leaves its GN loop when its own sequence has converged, and
// nothing is shared between them but the camera and the knobs. Every
// per-sequence array carries a leading sequence axis, contiguous, and the
// start poses come as an (N, 12) array beside the shared parameter row. K4 and
// K5 are the same __global__ at N = 1 with the start pose read from the row,
// so a sequence's result in a batch equals its single launch bit for bit. The
// bound is K4's chain of dependent rounds, per sequence; the batch fills the
// card while N <= the CTAs that fit at once (a cluster of four per sequence
// at S = 1024, several sequences an SM at S = 128).
#include "gn_loop.cuh"

#define DET_EPS 1e-12f
#define NPAR_SE3 40
#define NPAR_SE2 64
#define PREFETCH_DEPTH 2  // join-chain levels loaded a frame ahead
#ifndef VO_TRACK_CLUSTER_MAX
#define VO_TRACK_CLUSTER_MAX GN_MAX_CLUSTER  // diagnostic builds may pass 1
#endif
#if defined(VO_GN_TREE_SUMS) && VO_TRACK_CLUSTER_MAX > 1
#error "the diagnostic tree sums run on one CTA: pass -DVO_TRACK_CLUSTER_MAX=1"
#endif

// One thread's lane inputs of one frame.
struct LaneInputs {
  float u1, v1, u2, v2;
  int idx[PREFETCH_DEPTH];
  bool valid, ok[PREFETCH_DEPTH];
};

__device__ __forceinline__ LaneInputs load_lane(const int* __restrict__ cand_idx,
                                                const uint8_t* __restrict__ cand_ok,
                                                const float* __restrict__ prev_al,
                                                const float* __restrict__ cur_al,
                                                const uint8_t* __restrict__ corr_valid, int f,
                                                int s, int depth, int j) {
  LaneInputs in;
  const long long fs = static_cast<long long>(f) * s;
  const float2 a = __ldg(reinterpret_cast<const float2*>(prev_al) + fs + j);
  const float2 c = __ldg(reinterpret_cast<const float2*>(cur_al) + fs + j);
  in.u1 = a.x;
  in.v1 = a.y;
  in.u2 = c.x;
  in.v2 = c.y;
  in.valid = __ldg(corr_valid + fs + j) != 0;
#pragma unroll
  for (int d = 0; d < PREFETCH_DEPTH; ++d) {
    const long long o = (static_cast<long long>(f) * depth + d) * s + j;
    in.idx[d] = d < depth ? __ldg(cand_idx + o) : 0;
    in.ok[d] = d < depth ? __ldg(cand_ok + o) != 0 : false;
  }
  return in;
}

// params: [z_near, z_far, cols, rows, kt, keep_outliers, damping, tol,
//          warm_start, min_num_inliers, K (9), K^-1 (9), initial pose 3x4 (12)]
// and, when PLANAR, the camera mount [R|t] (12) and its inverse (12).
// pose0: (sequences, 12) start poses; the single-sequence entries pass the
// row's own slot, params + 28. rounds: (sequences, frames) int32, the GN
// rounds each frame ran (GNControl::it after its loop). cluster: the CTAs of
// one sequence (a thread block cluster of that size when above 1), each
// taking blockDim.x lanes.
template <bool PLANAR, int MAXT>
__global__ void __launch_bounds__(MAXT)
    track_frames_kernel(const float* __restrict__ params, const float* __restrict__ pose0,
                        const float* __restrict__ init_tri,
                        const uint8_t* __restrict__ init_ok, const int* __restrict__ cand_idx,
                        const uint8_t* __restrict__ cand_ok, const float* __restrict__ prev_al,
                        const float* __restrict__ cur_al, const uint8_t* __restrict__ corr_valid,
                        float* __restrict__ poses, float* __restrict__ tri_out,
                        uint8_t* __restrict__ tri_ok_out, float* __restrict__ stats,
                        int* __restrict__ rounds, int frames, int s, int depth,
                        int num_iterations, int min_iterations, int cluster) {
  constexpr int NPAR = PLANAR ? NPAR_SE2 : NPAR_SE3;
  extern __shared__ float tri_buf[];  // 2 x (s, 4): x, y, z, ok — ping-pong
  __shared__ float s_par[NPAR];
  __shared__ float s_cpose[12];       // carried pose, read by the join
  __shared__ GNShared s_gn;           // GN working pose, partial sums, control
  __shared__ int s_counts[2][GN_MAX_CLUSTER];  // each CTA's live lanes, by frame parity

  const int rank = cluster > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int jl = threadIdx.x;                       // this CTA's lane
  const int j = rank * static_cast<int>(blockDim.x) + jl;   // the sequence's lane
  const bool in_range = j < s;

  // This CTA's sequence: every per-sequence array is (sequences, ...) contiguous.
  {
    const long long seq = blockIdx.x / cluster;
    const long long fs_all = static_cast<long long>(frames) * s;
    pose0 += seq * 12;
    init_tri += seq * 3 * s;
    init_ok += seq * s;
    cand_idx += seq * fs_all * depth;
    cand_ok += seq * fs_all * depth;
    prev_al += seq * fs_all * 2;
    cur_al += seq * fs_all * 2;
    corr_valid += seq * fs_all;
    poses += seq * frames * 16;
    tri_out += seq * fs_all * 3;
    tri_ok_out += seq * fs_all;
    stats += seq * frames * 4;
    rounds += seq * frames;
  }

  if (jl < NPAR) s_par[jl] = params[jl];
  if (jl < 12) s_cpose[jl] = pose0[jl];
  // Every CTA holds the whole carried triangulation: a join reads any lane.
  for (int e = jl; e < s; e += blockDim.x) {
    const bool ok0 = init_ok[e] != 0;
    tri_buf[4 * e + 0] = init_tri[3 * e + 0];
    tri_buf[4 * e + 1] = init_tri[3 * e + 1];
    tri_buf[4 * e + 2] = init_tri[3 * e + 2];
    tri_buf[4 * e + 3] = ok0 ? 1.0f : 0.0f;
  }
  // In a cluster this also makes sure every CTA runs before any writes into
  // another's shared memory.
  if (cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  GNParams g;
  g.z_near = s_par[0];
  g.z_far = s_par[1];
  g.cols = s_par[2];
  g.rows = s_par[3];
  g.kt = s_par[4];
  g.keep_out = s_par[5];
  g.damping = s_par[6];
  g.tol = s_par[7];
  g.min_inl = s_par[9];
  g.k = s_par + 10;
  g.mount = PLANAR ? s_par + 40 : nullptr;
  g.mount_inv = PLANAR ? s_par + 52 : nullptr;
  const float warm = s_par[8];
  const float* ik = s_par + 19;

  LaneInputs next{};
  if (in_range && frames > 0)
    next = load_lane(cand_idx, cand_ok, prev_al, cur_al, corr_valid, 0, s, depth, j);

  for (int f = 0; f < frames; ++f) {
    GN_STAMPS(f0, f1, f2, f3);
    GN_STAMP(f0);
    const float* src_buf = tri_buf + 4 * s * (f & 1);
    float* dst_buf = tri_buf + 4 * s * ((f + 1) & 1);
    const long long fs = static_cast<long long>(f) * s;
    const LaneInputs cur = next;
    if (in_range && f + 1 < frames)
      next = load_lane(cand_idx, cand_ok, prev_al, cur_al, corr_valid, f + 1, s, depth, j);
    const float u1 = cur.u1, v1 = cur.v1, u2 = cur.u2, v2 = cur.v2;
    const bool cvalid = cur.valid;

    // ---- world join (first valid candidate of the chain) ----
    bool have = false;
    float wx = 0.0f, wy = 0.0f, wz = 0.0f;
    if (in_range) {
      const float* p = s_cpose;
      for (int d = 0; d < depth; ++d) {
        const long long o = (static_cast<long long>(f) * depth + d) * s + j;
        int src;
        bool cok;
        if (d < PREFETCH_DEPTH) {
          src = cur.idx[d];
          cok = cur.ok[d];
        } else {
          src = cand_idx[o];
          cok = cand_ok[o] != 0;
        }
        const float tx = src_buf[4 * src], ty = src_buf[4 * src + 1], tz = src_buf[4 * src + 2];
        const float px = p[0] * tx + p[1] * ty + p[2] * tz + p[3];
        const float py = p[4] * tx + p[5] * ty + p[6] * tz + p[7];
        const float pz = p[8] * tx + p[9] * ty + p[10] * tz + p[11];
        const bool ok_d = cok && src_buf[4 * src + 3] > 0.5f;
        if (d == 0 || (ok_d && !have)) {
          wx = px;
          wy = py;
          wz = pz;
        }
        have = have || ok_d;
      }
    }
    const float weight = have ? 1.0f : 0.0f;
    // Dead slots sanitized as in the TPU kernel: 0 * NaN never reaches H.
    const float gwx = have ? wx : 1.0f, gwy = have ? wy : 1.0f, gwz = have ? wz : 1.0f;
    const float gmx = have ? u2 : 0.0f, gmy = have ? v2 : 0.0f;

    if (jl == 0) {
      float start[12];
      for (int q = 0; q < 12; ++q) {
        const float eye = (q == 0 || q == 5 || q == 10) ? 1.0f : 0.0f;
        start[q] = warm > 0.5f ? s_cpose[q] : eye;
      }
      gn_init(&s_gn, start);
    }
    // The barrier also publishes the initial GN state written above. Each
    // CTA's count goes to rank 0, which reads them after the frame's end.
    const int n_weight = __syncthreads_count(have);
    if (jl == 0) {
      if (cluster > 1) {
        *cg::this_cluster().map_shared_rank(&s_counts[f & 1][rank], 0) = n_weight;
      } else {
        s_counts[f & 1][0] = n_weight;
      }
    }
    GN_STAMP(f1);

    // ---- Gauss-Newton with early exit ----
    gn_solve<PLANAR>(
        &s_gn, g, num_iterations, min_iterations,
        [&](const float* P, float* part) {
          if (in_range) {
            gn_point_terms<PLANAR>(P, g, gwx, gwy, gwz, gmx, gmy, weight, part);
          } else {
            for (int q = 0; q < (PLANAR ? GN_NRED_SE2 : GN_NRED_SE3); ++q) part[q] = 0.0f;
          }
        },
        cluster);

    // ---- mid-point triangulation in previous-frame coordinates ----
    GN_STAMP(f2);
    const float* P = s_gn.pose;
    if (in_range) {
      const float r[9] = {P[0], P[1], P[2], P[4], P[5], P[6], P[8], P[9], P[10]};
      const float t_vec[3] = {P[3], P[7], P[11]};
      float rt[9], rtt[3], ir_ik[9];
      transpose3(r, rt);
      mat3vec(rt, t_vec, rtt);
      const float it0 = -rtt[0], it1 = -rtt[1], it2 = -rtt[2];
      mat3mul(rt, ik, ir_ik);
      const float d1x = ik[0] * u1 + ik[1] * v1 + ik[2];
      const float d1y = ik[3] * u1 + ik[4] * v1 + ik[5];
      const float d1z = ik[6] * u1 + ik[7] * v1 + ik[8];
      const float d2x = ir_ik[0] * u2 + ir_ik[1] * v2 + ir_ik[2];
      const float d2y = ir_ik[3] * u2 + ir_ik[4] * v2 + ir_ik[5];
      const float d2z = ir_ik[6] * u2 + ir_ik[7] * v2 + ir_ik[8];
      const float a00 = d1x * d1x + d1y * d1y + d1z * d1z;
      const float a01 = -(d1x * d2x + d1y * d2y + d1z * d2z);
      const float a11 = d2x * d2x + d2y * d2y + d2z * d2z;
      const float b0 = d1x * it0 + d1y * it1 + d1z * it2;
      const float b1 = -(d2x * it0 + d2y * it1 + d2z * it2);
      const float det = a00 * a11 - a01 * a01;
      const float safe_det = fabsf(det) < DET_EPS ? 1.0f : det;
      const float s0 = (a11 * b0 - a01 * b1) / safe_det;
      const float s1 = (a00 * b1 - a01 * b0) / safe_det;
      bool ok = cvalid && (s0 >= 0.0f) && (s1 >= 0.0f) && (fabsf(det) >= DET_EPS);
      const float vx = 0.5f * (s0 * d1x + it0 + s1 * d2x);
      const float vy = 0.5f * (s0 * d1y + it1 + s1 * d2y);
      const float vz = 0.5f * (s0 * d1z + it2 + s1 * d2z);
      ok = ok && (fabsf(vx) < 1e18f) && (fabsf(vy) < 1e18f) && (fabsf(vz) < 1e18f);
      const float ntx = ok ? vx : 0.0f, nty = ok ? vy : 0.0f, ntz = ok ? vz : 0.0f;
      const float4 row = make_float4(ntx, nty, ntz, ok ? 1.0f : 0.0f);
      float4* dst4 = reinterpret_cast<float4*>(dst_buf) + j;
      if (cluster > 1) {
        for (int r = 0; r < cluster; ++r) *cg::this_cluster().map_shared_rank(dst4, r) = row;
      } else {
        *dst4 = row;
      }
      tri_out[3 * (fs + j) + 0] = ntx;
      tri_out[3 * (fs + j) + 1] = nty;
      tri_out[3 * (fs + j) + 2] = ntz;
      tri_ok_out[fs + j] = ok ? 1 : 0;
    }
    float chi_in = 0.0f, chi_out = 0.0f, n_in = 0.0f;
    int gn_rounds = 0;
    if (jl == 0) {
      float* out = poses + 16 * static_cast<long long>(f);
      for (int q = 0; q < 12; ++q) {
        if (rank == 0) out[q] = P[q];
        s_cpose[q] = P[q];
      }
      if (rank == 0) {
        out[12] = 0.0f;
        out[13] = 0.0f;
        out[14] = 0.0f;
        out[15] = 1.0f;
      }
      chi_in = s_gn.ctl.chi_in;
      chi_out = s_gn.ctl.chi_out;
      n_in = s_gn.ctl.n_in;
      gn_rounds = s_gn.ctl.it;
    }
    // Frame k+1 reads dst_buf and s_cpose (every CTA's rows, in a cluster),
    // and re-initializes the GN state.
    if (cluster > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    if (jl == 0 && rank == 0) {
      int live = 0;
      for (int r = 0; r < cluster; ++r) live += s_counts[f & 1][r];
      float* st = stats + 4 * static_cast<long long>(f);
      st[0] = chi_in;
      st[1] = chi_out;
      st[2] = n_in;
      st[3] = static_cast<float>(live);
      rounds[f] = gn_rounds;
    }
    GN_STAMP(f3);
    GN_PHASE(8, f0, f1);
    GN_PHASE(9, f2, f3);
    GN_PHASE(7, 0, 1);
  }
}

template <bool PLANAR>
static int launch_track_frames(int sequences, const float* params, const float* pose0,
                               const float* init_tri, const uint8_t* init_ok,
                               const int* cand_idx, const uint8_t* cand_ok, const float* prev_al,
                               const float* cur_al, const uint8_t* corr_valid, float* poses,
                               float* tri_out, uint8_t* tri_ok_out, float* stats, int* rounds,
                               int frames, int s, int depth, int num_iterations,
                               int min_iterations, void* stream) {
  if (frames <= 0 || sequences <= 0) return 0;
  if (s < 1 || s > 1024 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  // The pixel rows are read as float2.
  if (reinterpret_cast<uintptr_t>(prev_al) % 8 != 0 || reinterpret_cast<uintptr_t>(cur_al) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // A sequence of 512 or more lanes (a multiple of 128) is split over a
  // cluster of 4 CTAs, one of 256 (a multiple of 64) over 2: the same warps
  // in the same order as one CTA, each CTA of at least 128 threads.
  int cluster = 1;
  if (s >= 512 && s % 128 == 0) {
    cluster = 4;
  } else if (s >= 256 && s % 64 == 0) {
    cluster = 2;
  }
  if (cluster > VO_TRACK_CLUSTER_MAX) cluster = 1;
  int threads = ((s + 31) / 32) * 32 / cluster;
  if (threads < 64) threads = 64;  // threads 0..63 stage the parameters
  // Up to 256 threads a CTA (a cluster's, or a short sequence's) the kernel
  // may hold 255 registers a thread, and a round's 32 live terms never spill.
  const auto kernel = threads <= 256 ? track_frames_kernel<PLANAR, 256>
                                     : track_frames_kernel<PLANAR, 1024>;
  const size_t smem = 8 * static_cast<size_t>(s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(sequences * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, params, pose0, init_tri, init_ok,
                           cand_idx, cand_ok, prev_al, cur_al, corr_valid, poses, tri_out,
                           tri_ok_out, stats, rounds, frames, s, depth, num_iterations,
                           min_iterations, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return vo_launch_status();
}

#ifdef VO_GN_PHASES
// The diagnostic build's phase counters (gn_loop.cuh): copied out, then zeroed.
VO_EXPORT int vo_gn_phases_take(unsigned long long* host16) {
  cudaError_t err = cudaMemcpyFromSymbol(host16, vo_gn_phase_cycles, 16 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(vo_gn_phase_cycles, zero, sizeof(zero)));
}
#endif

// K4: params holds 40 floats.
VO_EXPORT int vo_track_frames(const float* params, const float* init_tri, const uint8_t* init_ok,
                              const int* cand_idx, const uint8_t* cand_ok, const float* prev_al,
                              const float* cur_al, const uint8_t* corr_valid, float* poses,
                              float* tri_out, uint8_t* tri_ok_out, float* stats, int* rounds,
                              int frames, int s, int depth, int num_iterations,
                              int min_iterations, void* stream) {
  return launch_track_frames<false>(1, params, params + 28, init_tri, init_ok, cand_idx, cand_ok, prev_al, cur_al,
                                    corr_valid, poses, tri_out, tri_ok_out, stats, rounds, frames, s,
                                    depth, num_iterations, min_iterations, stream);
}

// K5: params holds 64 floats (the 40 of K4, then the mount and its inverse).
VO_EXPORT int vo_track_frames_planar(const float* params, const float* init_tri,
                                     const uint8_t* init_ok, const int* cand_idx,
                                     const uint8_t* cand_ok, const float* prev_al,
                                     const float* cur_al, const uint8_t* corr_valid, float* poses,
                                     float* tri_out, uint8_t* tri_ok_out, float* stats,
                                     int* rounds, int frames, int s, int depth, int num_iterations,
                                     int min_iterations, void* stream) {
  return launch_track_frames<true>(1, params, params + 28, init_tri, init_ok, cand_idx, cand_ok, prev_al, cur_al,
                                   corr_valid, poses, tri_out, tri_ok_out, stats, rounds, frames, s,
                                   depth, num_iterations, min_iterations, stream);
}

// K8: N sequences, one CTA each. params is K4's row (its pose slot is not
// read); pose0 (N, 12); the other arrays as K4's with a leading sequence axis.
VO_EXPORT int vo_track_frames_batched(const float* params, const float* pose0,
                                      const float* init_tri, const uint8_t* init_ok,
                                      const int* cand_idx, const uint8_t* cand_ok,
                                      const float* prev_al, const float* cur_al,
                                      const uint8_t* corr_valid, float* poses, float* tri_out,
                                      uint8_t* tri_ok_out, float* stats, int* rounds,
                                      int sequences, int frames, int s, int depth,
                                      int num_iterations, int min_iterations, void* stream) {
  return launch_track_frames<false>(sequences, params, pose0, init_tri, init_ok, cand_idx, cand_ok,
                                    prev_al, cur_al, corr_valid, poses, tri_out, tri_ok_out, stats,
                                    rounds, frames, s, depth, num_iterations, min_iterations, stream);
}

// K8 planar: params is K5's row of 64 floats.
VO_EXPORT int vo_track_frames_batched_planar(const float* params, const float* pose0,
                                             const float* init_tri, const uint8_t* init_ok,
                                             const int* cand_idx, const uint8_t* cand_ok,
                                             const float* prev_al, const float* cur_al,
                                             const uint8_t* corr_valid, float* poses,
                                             float* tri_out, uint8_t* tri_ok_out, float* stats,
                                             int* rounds, int sequences, int frames, int s,
                                             int depth, int num_iterations, int min_iterations,
                                             void* stream) {
  return launch_track_frames<true>(sequences, params, pose0, init_tri, init_ok, cand_idx, cand_ok,
                                   prev_al, cur_al, corr_valid, poses, tri_out, tri_ok_out, stats,
                                   rounds, frames, s, depth, num_iterations, min_iterations, stream);
}
