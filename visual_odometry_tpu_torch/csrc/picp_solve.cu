// K6: one standalone projective-ICP Gauss-Newton solve in one launch, SE(3)
// and planar.
//
// Replaces visual_odometry_tpu/ops/pallas/picp_kernel.py:solve_fused and
// solve_se2_fused (bodies _solve_kernel, _solve_se2_kernel). Inputs: the
// parameter row of the frame kernels (track_frames.cu; the initial pose is
// the solve's start pose, warm_start and K^-1 are not read), world points
// (N, 3), measurements (N, 2) and weights (N,). Outputs: the pose (4, 4) and
// [chi_in, chi_out, n_in] of the last round, not the TPU kernel's padded
// (8, 128) tile.
//
// Bound on this card: latency. A solve is a chain of dependent rounds, each
// a block-wide reduction and a small solve on one thread; N x 6 floats of
// input are read once per round and stay in L1/L2. Design: one CTA of up to
// 1024 threads around the device GN loop of gn_loop.cuh. Thread j owns
// points j, j + T, j + 2T, ... (T = blockDim.x) and adds their terms in
// that ascending order before the block sum; the plain version
// (ops/kernels/picp_kernel.solve_fused_plain) adds in the same order, so
// the two agree bit for bit on the card at any N.
#include "gn_loop.cuh"

template <bool PLANAR>
__global__ void __launch_bounds__(1024)
    picp_solve_kernel(const float* __restrict__ params, const float* __restrict__ world,
                      const float* __restrict__ meas, const float* __restrict__ weights,
                      float* __restrict__ pose_out, float* __restrict__ stats_out, int n,
                      int num_iterations, int min_iterations) {
  constexpr int NPAR = PLANAR ? 64 : 40;
  constexpr int NRED = PLANAR ? GN_NRED_SE2 : GN_NRED_SE3;
  __shared__ float s_par[NPAR];
  __shared__ GNShared s_gn;

  const int j = threadIdx.x;
  if (j < NPAR) s_par[j] = params[j];
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

  if (j == 0) gn_init(&s_gn, s_par + 28);
  __syncthreads();

  const int stride = blockDim.x;
  gn_solve<PLANAR>(&s_gn, g, num_iterations, min_iterations, [&](const float* P, float* part) {
    if (j < n) {
      gn_point_terms<PLANAR>(P, g, world[3 * j], world[3 * j + 1], world[3 * j + 2], meas[2 * j],
                             meas[2 * j + 1], weights[j], part);
      for (int i = j + stride; i < n; i += stride) {
        float term[NRED];
        gn_point_terms<PLANAR>(P, g, world[3 * i], world[3 * i + 1], world[3 * i + 2],
                               meas[2 * i], meas[2 * i + 1], weights[i], term);
#pragma unroll
        for (int q = 0; q < NRED; ++q) part[q] = part[q] + term[q];
      }
    } else {
      for (int q = 0; q < NRED; ++q) part[q] = 0.0f;
    }
  });

  if (j == 0) {
    for (int q = 0; q < 12; ++q) pose_out[q] = s_gn.pose[q];
    pose_out[12] = 0.0f;
    pose_out[13] = 0.0f;
    pose_out[14] = 0.0f;
    pose_out[15] = 1.0f;
    stats_out[0] = s_gn.ctl.chi_in;
    stats_out[1] = s_gn.ctl.chi_out;
    stats_out[2] = s_gn.ctl.n_in;
  }
}

template <bool PLANAR>
static int launch_picp_solve(const float* params, const float* world, const float* meas,
                             const float* weights, float* pose_out, float* stats_out, int n,
                             int num_iterations, int min_iterations, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((n + 31) / 32) * 32;
  if (threads < 64) threads = 64;  // threads 0..63 stage the parameters
  if (threads > 1024) threads = 1024;
  picp_solve_kernel<PLANAR><<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, world, meas, weights, pose_out, stats_out, n, num_iterations, min_iterations);
  return vo_launch_status();
}

VO_EXPORT int vo_picp_solve(const float* params, const float* world, const float* meas,
                            const float* weights, float* pose_out, float* stats_out, int n,
                            int num_iterations, int min_iterations, void* stream) {
  return launch_picp_solve<false>(params, world, meas, weights, pose_out, stats_out, n,
                                  num_iterations, min_iterations, stream);
}

VO_EXPORT int vo_picp_solve_se2(const float* params, const float* world, const float* meas,
                                const float* weights, float* pose_out, float* stats_out, int n,
                                int num_iterations, int min_iterations, void* stream) {
  return launch_picp_solve<true>(params, world, meas, weights, pose_out, stats_out, n,
                                 num_iterations, min_iterations, stream);
}
