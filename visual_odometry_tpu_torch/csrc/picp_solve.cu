// K6: one standalone projective-ICP Gauss-Newton solve in one launch, SE(3)
// and planar.
//
// Replaces visual_odometry_tpu/ops/pallas/picp_kernel.py:solve_fused and
// solve_se2_fused (bodies _solve_kernel, _solve_se2_kernel). Inputs: the
// intrinsics K (3, 3), the start pose (4, 4; its first 12 floats are [R|t]),
// z_near, z_far, cols and rows (one float each), planar: the camera mount
// [R|t] and its rigid inverse (24 floats), world points (N, 3), measurements
// (N, 2) and weights (N,); the knobs by value. Output: 20 floats, the pose
// (4, 4) row-major, chi_in and chi_out of the last round, then its inlier
// count and the number of GN rounds run, each as an int32; not the TPU
// kernel's padded (8, 128) tile. No parameter row is packed on the host:
// every input is read where the caller keeps it.
//
// A dead slot (weight <= 0) is sanitized here, as ops/picp.solve did before
// the launch: its lane takes the world point (1, 1, 1) and the measurement
// (0, 0), so NaN or inf garbage there never reaches the sums (0 * NaN).
//
// Bound on this card: latency. A solve is a chain of dependent rounds, each
// the lane terms, a sum over all lanes and a small solve on one warp. One
// CTA looping over the points spent most of a round adding N / 1,024 points
// a thread in turn on one SM. Design: one point a lane up to 2,048 points,
// the lanes spread over a thread block cluster. The wrapper picks the
// geometry (ops/kernels/picp_kernel.solve_geometry) and passes it in:
//   N <= 256:  one CTA of max(64, N rounded up to a warp) threads;
//   256 < N:   min(8, ceil(N / 256)) CTAs of 256 threads (N = 1,024: K4's
//              4 x 256); above 2,048 points lane l also takes points
//              l + 2,048, l + 4,096, ... in ascending order.
// Before round 1 each CTA copies its lanes' first K6_STAGE points (up to
// 1,024 a CTA, so every point up to N = 8,192) into shared memory, 24 bytes
// a point, coalesced, so no round reads global memory with a stride of 3
// floats; points past those are read from global memory. Clusters of up to 8
// CTAs are portable; a cluster the card cannot schedule, or a geometry out of
// these limits, makes the launch fail, and the wrapper raises. A round's sum
// is gn_loop.cuh's gn_solve_ranked: the transposed warp sum, each CTA's warps
// folded in warp order, the CTAs' partials in rank order through distributed
// shared memory. The plain version (ops/kernels/picp_kernel.solve_fused_plain,
// frame_kernel._block_sum at the same geometry) adds in the same order, the
// padding zeros of a lane short of the last point included, so the two agree
// bit for bit on the card at any N. A CTA is compiled for 255 registers a
// thread.
#include "gn_loop.cuh"

#define K6_MAX_THREADS 256
#define K6_STAGE 4  // points a lane staged in shared memory

template <bool PLANAR>
__global__ void __launch_bounds__(K6_MAX_THREADS)
    picp_solve_kernel(const float* __restrict__ k, const float* __restrict__ pose0,
                      const float* __restrict__ z_near, const float* __restrict__ z_far,
                      const float* __restrict__ cols, const float* __restrict__ rows,
                      const float* __restrict__ mount, const float* __restrict__ world,
                      const float* __restrict__ meas, const float* __restrict__ weights,
                      float* __restrict__ out, int n, int num_iterations, int min_iterations,
                      float kt, float keep_out, float damping, float tol, float min_inl,
                      int cluster) {
  constexpr int NRED = PLANAR ? GN_NRED_SE2 : GN_NRED_SE3;
  constexpr int NCAM = PLANAR ? 37 : 13;  // K, z_near, z_far, cols, rows, the mount rows
  constexpr int STAGED = K6_STAGE * K6_MAX_THREADS;
  __shared__ float s_cam[NCAM];
  __shared__ float s_world[3 * STAGED];
  __shared__ float2 s_meas[STAGED];
  __shared__ float s_wgt[STAGED];
  __shared__ GNShared s_gn;
  __shared__ float s_rank[2 * GN_MAX_RANKS * NRED];

  const int t = threadIdx.x, threads = blockDim.x;
  const int rank = cluster > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long lanes = static_cast<long long>(threads) * cluster;
  const long long lane0 = static_cast<long long>(rank) * threads;  // this CTA's first lane
  // Points a lane: the same count for every lane, as the plain version pads.
  const int per_lane = n > lanes ? static_cast<int>((n + lanes - 1) / lanes) : 1;
  for (int i = t; i < NCAM; i += threads) {
    s_cam[i] = i < 9     ? k[i]
               : i == 9  ? *z_near
               : i == 10 ? *z_far
               : i == 11 ? *cols
               : i == 12 ? *rows
                         : mount[i - 13];
  }
  float* s_meas_f = reinterpret_cast<float*>(s_meas);
  for (int s = 0; s < per_lane && s < K6_STAGE; ++s) {
    // Slot s holds the points lane0 + s * lanes + [0, threads).
    const long long b = lane0 + s * lanes;
    const int count = n - b < threads ? (n - b > 0 ? static_cast<int>(n - b) : 0) : threads;
    for (int i = t; i < 3 * count; i += threads) s_world[3 * threads * s + i] = world[3 * b + i];
    for (int i = t; i < 2 * count; i += threads) s_meas_f[2 * threads * s + i] = meas[2 * b + i];
    if (t < count) s_wgt[threads * s + t] = weights[b + t];
  }
  if (t == 0) gn_init(&s_gn, pose0);
  // In a cluster this also makes sure every CTA runs before any writes into
  // another's shared memory.
  if (cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  GNParams g;
  g.k = s_cam;
  g.z_near = s_cam[9];
  g.z_far = s_cam[10];
  g.cols = s_cam[11];
  g.rows = s_cam[12];
  g.kt = kt;
  g.keep_out = keep_out;
  g.damping = damping;
  g.tol = tol;
  g.min_inl = min_inl;
  g.mount = PLANAR ? s_cam + 13 : nullptr;
  g.mount_inv = PLANAR ? s_cam + 25 : nullptr;

  // The terms of the lane's point in slot s (its point lane0 + t + s * lanes)
  // into part: a dead point sanitized, a missing one (past N) the plain
  // version's padding zeros.
  const auto point_terms = [&](const float* P, int s, float* part) {
    const long long i = lane0 + t + s * lanes;
    if (i >= n) {
#pragma unroll
      for (int q = 0; q < NRED; ++q) part[q] = 0.0f;
      return;
    }
    float wx, wy, wz, mx, my, wgt;
    if (s < K6_STAGE) {
      const int j = threads * s + t;
      wx = s_world[3 * j];
      wy = s_world[3 * j + 1];
      wz = s_world[3 * j + 2];
      const float2 m = s_meas[j];
      mx = m.x;
      my = m.y;
      wgt = s_wgt[j];
    } else {
      wx = world[3 * i];
      wy = world[3 * i + 1];
      wz = world[3 * i + 2];
      mx = meas[2 * i];
      my = meas[2 * i + 1];
      wgt = weights[i];
    }
    const bool live = wgt > 0.0f;
    gn_point_terms<PLANAR>(P, g, live ? wx : 1.0f, live ? wy : 1.0f, live ? wz : 1.0f,
                           live ? mx : 0.0f, live ? my : 0.0f, wgt, part);
  };

  gn_solve_ranked<PLANAR>(&s_gn, s_rank, g, num_iterations, min_iterations,
                          [&](const float* P, float* part) {
    point_terms(P, 0, part);
    for (int s = 1; s < per_lane; ++s) {
      float term[NRED];
      point_terms(P, s, term);
#pragma unroll
      for (int q = 0; q < NRED; ++q) part[q] = part[q] + term[q];
    }
  }, cluster);

  if (rank == 0 && t == 0) {
    for (int q = 0; q < 12; ++q) out[q] = s_gn.pose[q];
    out[12] = 0.0f;
    out[13] = 0.0f;
    out[14] = 0.0f;
    out[15] = 1.0f;
    out[16] = s_gn.ctl.chi_in;
    out[17] = s_gn.ctl.chi_out;
    reinterpret_cast<int*>(out)[18] = static_cast<int>(s_gn.ctl.n_in);
    reinterpret_cast<int*>(out)[19] = s_gn.ctl.it;
  }
}

template <bool PLANAR>
static int launch_picp_solve(const float* k, const float* pose0, const float* z_near,
                             const float* z_far, const float* cols, const float* rows,
                             const float* mount, const float* world, const float* meas,
                             const float* weights, float* out, int n, int ctas, int threads,
                             int num_iterations, int min_iterations, float kt, float keep_out,
                             float damping, float tol, float min_inl, void* stream) {
  if (n < 0 || ctas < 1 || ctas > GN_MAX_RANKS || threads < 64 || threads > K6_MAX_THREADS ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(ctas));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = ctas > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, picp_solve_kernel<PLANAR>, k, pose0, z_near, z_far, cols, rows,
                         mount, world, meas, weights, out, n, num_iterations, min_iterations, kt,
                         keep_out, damping, tol, min_inl, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  return vo_launch_status();
}

VO_EXPORT int vo_picp_solve(const float* k, const float* pose0, const float* z_near,
                            const float* z_far, const float* cols, const float* rows,
                            const float* world, const float* meas, const float* weights,
                            float* out, int n, int ctas, int threads, int num_iterations,
                            int min_iterations, float kt, float keep_out, float damping, float tol,
                            float min_inl, void* stream) {
  return launch_picp_solve<false>(k, pose0, z_near, z_far, cols, rows, nullptr, world, meas,
                                  weights, out, n, ctas, threads, num_iterations, min_iterations,
                                  kt, keep_out, damping, tol, min_inl, stream);
}

VO_EXPORT int vo_picp_solve_se2(const float* k, const float* pose0, const float* z_near,
                                const float* z_far, const float* cols, const float* rows,
                                const float* mount, const float* world, const float* meas,
                                const float* weights, float* out, int n, int ctas, int threads,
                                int num_iterations, int min_iterations, float kt, float keep_out,
                                float damping, float tol, float min_inl, void* stream) {
  return launch_picp_solve<true>(k, pose0, z_near, z_far, cols, rows, mount, world, meas,
                                 weights, out, n, ctas, threads, num_iterations, min_iterations,
                                 kt, keep_out, damping, tol, min_inl, stream);
}
