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
//   4. the pose, the stats row [chi_in, chi_out, n_in, sum(weight)] and the
//      triangulation rows.
//
// Bound on this card: latency, not bytes or FLOPs. The frames and the GN
// rounds inside them are a chain of dependent steps, each a block-wide
// reduction followed by a small solve on one thread. Design: one CTA per
// sequence, one thread per correspondence lane (S <= 1024), the loop over
// frames inside the kernel. Pose and triangulation stay resident in shared
// memory for the whole sequence; the TPU kernel's VMEM frame blocking has no
// counterpart. The carried triangulation lives in two ping-pong buffers:
// frame k's join reads frame k-1's rows while frame k's triangulation writes
// the other buffer, so one barrier per frame orders them. PLANAR is a
// template parameter, so each group compiles to its own kernel and K4 pays
// nothing for K5.
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
// card while N <= the CTAs that fit at once (one per SM at S = 1024, several
// at S = 128).
#include "gn_loop.cuh"

#define DET_EPS 1e-12f
#define NPAR_SE3 40
#define NPAR_SE2 64

// params: [z_near, z_far, cols, rows, kt, keep_outliers, damping, tol,
//          warm_start, min_num_inliers, K (9), K^-1 (9), initial pose 3x4 (12)]
// and, when PLANAR, the camera mount [R|t] (12) and its inverse (12).
// pose0: (gridDim.x, 12) start poses; the single-sequence entries pass the
// row's own slot, params + 28.
template <bool PLANAR>
__global__ void __launch_bounds__(1024)
    track_frames_kernel(const float* __restrict__ params, const float* __restrict__ pose0,
                        const float* __restrict__ init_tri,
                        const uint8_t* __restrict__ init_ok, const int* __restrict__ cand_idx,
                        const uint8_t* __restrict__ cand_ok, const float* __restrict__ prev_al,
                        const float* __restrict__ cur_al, const uint8_t* __restrict__ corr_valid,
                        float* __restrict__ poses, float* __restrict__ tri_out,
                        uint8_t* __restrict__ tri_ok_out, float* __restrict__ stats, int frames,
                        int s, int depth, int num_iterations, int min_iterations) {
  constexpr int NPAR = PLANAR ? NPAR_SE2 : NPAR_SE3;
  extern __shared__ float tri_buf[];  // 2 x (s, 4): x, y, z, ok — ping-pong
  __shared__ float s_par[NPAR];
  __shared__ float s_cpose[12];       // carried pose, read by the join
  __shared__ GNShared s_gn;           // GN working pose, partial sums, control

  const int j = threadIdx.x;
  const bool in_range = j < s;

  // This CTA's sequence: every per-sequence array is (sequences, ...) contiguous.
  {
    const long long seq = blockIdx.x;
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
  }

  if (j < NPAR) s_par[j] = params[j];
  if (j < 12) s_cpose[j] = pose0[j];
  __syncthreads();
  if (in_range) {
    const bool ok0 = init_ok[j] != 0;
    tri_buf[4 * j + 0] = init_tri[3 * j + 0];
    tri_buf[4 * j + 1] = init_tri[3 * j + 1];
    tri_buf[4 * j + 2] = init_tri[3 * j + 2];
    tri_buf[4 * j + 3] = ok0 ? 1.0f : 0.0f;
  }
  __syncthreads();

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

  for (int f = 0; f < frames; ++f) {
    const float* src_buf = tri_buf + 4 * s * (f & 1);
    float* dst_buf = tri_buf + 4 * s * ((f + 1) & 1);
    const long long fs = static_cast<long long>(f) * s;

    // ---- world join (first valid candidate of the chain) ----
    bool have = false;
    float wx = 0.0f, wy = 0.0f, wz = 0.0f;
    float u1 = 0.0f, v1 = 0.0f, u2 = 0.0f, v2 = 0.0f;
    bool cvalid = false;
    if (in_range) {
      u1 = prev_al[2 * (fs + j)];
      v1 = prev_al[2 * (fs + j) + 1];
      u2 = cur_al[2 * (fs + j)];
      v2 = cur_al[2 * (fs + j) + 1];
      cvalid = corr_valid[fs + j] != 0;
      const float* p = s_cpose;
      for (int d = 0; d < depth; ++d) {
        const long long o = (static_cast<long long>(f) * depth + d) * s + j;
        const int src = cand_idx[o];
        const float tx = src_buf[4 * src], ty = src_buf[4 * src + 1], tz = src_buf[4 * src + 2];
        const float px = p[0] * tx + p[1] * ty + p[2] * tz + p[3];
        const float py = p[4] * tx + p[5] * ty + p[6] * tz + p[7];
        const float pz = p[8] * tx + p[9] * ty + p[10] * tz + p[11];
        const bool ok_d = cand_ok[o] != 0 && src_buf[4 * src + 3] > 0.5f;
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

    if (j == 0) {
      float start[12];
      for (int q = 0; q < 12; ++q) {
        const float eye = (q == 0 || q == 5 || q == 10) ? 1.0f : 0.0f;
        start[q] = warm > 0.5f ? s_cpose[q] : eye;
      }
      gn_init(&s_gn, start);
    }
    // The barrier also publishes the initial GN state written above.
    const int n_weight = __syncthreads_count(have);

    // ---- Gauss-Newton with early exit ----
    gn_solve<PLANAR>(&s_gn, g, num_iterations, min_iterations, [&](const float* P, float* part) {
      if (in_range) {
        gn_point_terms<PLANAR>(P, g, gwx, gwy, gwz, gmx, gmy, weight, part);
      } else {
        for (int q = 0; q < (PLANAR ? GN_NRED_SE2 : GN_NRED_SE3); ++q) part[q] = 0.0f;
      }
    });

    // ---- mid-point triangulation in previous-frame coordinates ----
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
      dst_buf[4 * j + 0] = ntx;
      dst_buf[4 * j + 1] = nty;
      dst_buf[4 * j + 2] = ntz;
      dst_buf[4 * j + 3] = ok ? 1.0f : 0.0f;
      tri_out[3 * (fs + j) + 0] = ntx;
      tri_out[3 * (fs + j) + 1] = nty;
      tri_out[3 * (fs + j) + 2] = ntz;
      tri_ok_out[fs + j] = ok ? 1 : 0;
    }
    if (j == 0) {
      float* out = poses + 16 * static_cast<long long>(f);
      for (int q = 0; q < 12; ++q) {
        out[q] = P[q];
        s_cpose[q] = P[q];
      }
      out[12] = 0.0f;
      out[13] = 0.0f;
      out[14] = 0.0f;
      out[15] = 1.0f;
      float* st = stats + 4 * static_cast<long long>(f);
      st[0] = s_gn.ctl.chi_in;
      st[1] = s_gn.ctl.chi_out;
      st[2] = s_gn.ctl.n_in;
      st[3] = static_cast<float>(n_weight);
    }
    // Frame k+1 reads dst_buf and s_cpose, and re-initializes the GN state.
    __syncthreads();
  }
}

template <bool PLANAR>
static int launch_track_frames(int sequences, const float* params, const float* pose0,
                               const float* init_tri, const uint8_t* init_ok,
                               const int* cand_idx, const uint8_t* cand_ok, const float* prev_al,
                               const float* cur_al, const uint8_t* corr_valid, float* poses,
                               float* tri_out, uint8_t* tri_ok_out, float* stats, int frames, int s,
                               int depth, int num_iterations, int min_iterations, void* stream) {
  if (frames <= 0 || sequences <= 0) return 0;
  if (s < 1 || s > 1024 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((s + 31) / 32) * 32;
  if (threads < 64) threads = 64;  // threads 0..63 stage the parameters
  size_t smem = 2 * 4 * static_cast<size_t>(s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(track_frames_kernel<PLANAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  track_frames_kernel<PLANAR><<<sequences, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, pose0, init_tri, init_ok, cand_idx, cand_ok, prev_al, cur_al, corr_valid, poses, tri_out,
      tri_ok_out, stats, frames, s, depth, num_iterations, min_iterations);
  return vo_launch_status();
}

// K4: params holds 40 floats.
VO_EXPORT int vo_track_frames(const float* params, const float* init_tri, const uint8_t* init_ok,
                              const int* cand_idx, const uint8_t* cand_ok, const float* prev_al,
                              const float* cur_al, const uint8_t* corr_valid, float* poses,
                              float* tri_out, uint8_t* tri_ok_out, float* stats, int frames, int s,
                              int depth, int num_iterations, int min_iterations, void* stream) {
  return launch_track_frames<false>(1, params, params + 28, init_tri, init_ok, cand_idx, cand_ok, prev_al, cur_al,
                                    corr_valid, poses, tri_out, tri_ok_out, stats, frames, s, depth,
                                    num_iterations, min_iterations, stream);
}

// K5: params holds 64 floats (the 40 of K4, then the mount and its inverse).
VO_EXPORT int vo_track_frames_planar(const float* params, const float* init_tri,
                                     const uint8_t* init_ok, const int* cand_idx,
                                     const uint8_t* cand_ok, const float* prev_al,
                                     const float* cur_al, const uint8_t* corr_valid, float* poses,
                                     float* tri_out, uint8_t* tri_ok_out, float* stats, int frames,
                                     int s, int depth, int num_iterations, int min_iterations,
                                     void* stream) {
  return launch_track_frames<true>(1, params, params + 28, init_tri, init_ok, cand_idx, cand_ok, prev_al, cur_al,
                                   corr_valid, poses, tri_out, tri_ok_out, stats, frames, s, depth,
                                   num_iterations, min_iterations, stream);
}

// K8: N sequences, one CTA each. params is K4's row (its pose slot is not
// read); pose0 (N, 12); the other arrays as K4's with a leading sequence axis.
VO_EXPORT int vo_track_frames_batched(const float* params, const float* pose0,
                                      const float* init_tri, const uint8_t* init_ok,
                                      const int* cand_idx, const uint8_t* cand_ok,
                                      const float* prev_al, const float* cur_al,
                                      const uint8_t* corr_valid, float* poses, float* tri_out,
                                      uint8_t* tri_ok_out, float* stats, int sequences, int frames,
                                      int s, int depth, int num_iterations, int min_iterations,
                                      void* stream) {
  return launch_track_frames<false>(sequences, params, pose0, init_tri, init_ok, cand_idx, cand_ok,
                                    prev_al, cur_al, corr_valid, poses, tri_out, tri_ok_out, stats,
                                    frames, s, depth, num_iterations, min_iterations, stream);
}

// K8 planar: params is K5's row of 64 floats.
VO_EXPORT int vo_track_frames_batched_planar(const float* params, const float* pose0,
                                             const float* init_tri, const uint8_t* init_ok,
                                             const int* cand_idx, const uint8_t* cand_ok,
                                             const float* prev_al, const float* cur_al,
                                             const uint8_t* corr_valid, float* poses,
                                             float* tri_out, uint8_t* tri_ok_out, float* stats,
                                             int sequences, int frames, int s, int depth,
                                             int num_iterations, int min_iterations,
                                             void* stream) {
  return launch_track_frames<true>(sequences, params, pose0, init_tri, init_ok, cand_idx, cand_ok,
                                   prev_al, cur_al, corr_valid, poses, tri_out, tri_ok_out, stats,
                                   frames, s, depth, num_iterations, min_iterations, stream);
}
