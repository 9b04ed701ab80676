// K11: one Gauss-Newton linearization of projective ICP in one launch: the
// normal system H (6, 6), b (6,) and [chi_in, chi_out, n_in] of N
// correspondences under a given pose, without the solve and the update.
//
// Replaces visual_odometry_tpu/ops/pallas/picp_kernel.py:linearize_pallas
// (body _kernel), which streams point tiles through VMEM and contracts the
// sqrt-weighted Jacobian rows on the MXU. Inputs: the parameter row of the
// frame kernels (track_frames.cu; the pose slot holds the pose to linearize
// at; damping, tolerance, warm_start, min_inliers and K^-1 are not read),
// world points (N, 3), measurements (N, 2) and weights (N,). Output: 45
// floats, H row-major (mirrored from its upper triangle), then b, then the
// three stats.
//
// The TPU kernel lacks the near-depth guard `hz > 1e-6` that the plain
// linearization (ops/picp.linearize) and every GN loop apply; it is restored
// here, because this kernel uses the lane terms of gn_loop.cuh, which have it.
// A point essentially at the pinhole therefore adds nothing, where the TPU
// kernel lets its 1/z^2 terms into H.
//
// Bound on this card: bytes, N x 24 of input read once; at the sizes it is
// called with (N <= 8192) the launch and one block-wide sum dominate. Design:
// K6's without the loop. One CTA of up to 1024 threads; thread j adds the 30
// terms of points j, j + T, j + 2T, ... in ascending order, then the block
// sum of gn_loop.cuh (shuffle tree per warp, warps added in order). The plain
// version (ops/kernels/picp_kernel.linearize_plain) adds in the same order,
// so the two agree bit for bit on the card.
#include "gn_loop.cuh"

__global__ void __launch_bounds__(1024)
    picp_linearize_kernel(const float* __restrict__ params, const float* __restrict__ world,
                          const float* __restrict__ meas, const float* __restrict__ weights,
                          float* __restrict__ out, int n) {
  constexpr int NRED = GN_NRED_SE3;
  __shared__ float s_par[40];
  __shared__ float s_red[GN_MAX_WARPS * NRED];
  __shared__ float s_sums[NRED];

  const int j = threadIdx.x;
  if (j < 40) s_par[j] = params[j];
  __syncthreads();

  GNParams g;
  g.z_near = s_par[0];
  g.z_far = s_par[1];
  g.cols = s_par[2];
  g.rows = s_par[3];
  g.kt = s_par[4];
  g.keep_out = s_par[5];
  g.damping = 0.0f;
  g.tol = 0.0f;
  g.min_inl = 0.0f;
  g.k = s_par + 10;
  g.mount = nullptr;
  g.mount_inv = nullptr;
  const float* P = s_par + 28;

  float part[NRED];
  if (j < n) {
    gn_point_terms<false>(P, g, world[3 * j], world[3 * j + 1], world[3 * j + 2], meas[2 * j],
                          meas[2 * j + 1], weights[j], part);
    for (int i = j + blockDim.x; i < n; i += blockDim.x) {
      float term[NRED];
      gn_point_terms<false>(P, g, world[3 * i], world[3 * i + 1], world[3 * i + 2], meas[2 * i],
                            meas[2 * i + 1], weights[i], term);
#pragma unroll
      for (int q = 0; q < NRED; ++q) part[q] = part[q] + term[q];
    }
  } else {
    for (int q = 0; q < NRED; ++q) part[q] = 0.0f;
  }

  const int lane = j & 31, warp = j >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < NRED; ++q) {
    const float v = warp_sum(part[q]);
    if (lane == 0) s_red[warp * NRED + q] = v;
  }
  __syncthreads();
  if (j < NRED) {
    float acc = s_red[j];
    for (int w = 1; w < nwarps; ++w) acc += s_red[w * NRED + j];
    s_sums[j] = acc;
  }
  __syncthreads();
  if (j < 36) {
    const int r = j / 6, c = j % 6;
    const int lo = r < c ? r : c, hi = r < c ? c : r;
    // Index of (lo, hi) in the row-major upper triangle of a 6 x 6 matrix.
    out[j] = s_sums[lo * 6 - (lo * (lo - 1)) / 2 + (hi - lo)];
  } else if (j < 45) {
    out[j] = s_sums[21 + (j - 36)];
  }
}

VO_EXPORT int vo_picp_linearize(const float* params, const float* world, const float* meas,
                                const float* weights, float* out, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((n + 31) / 32) * 32;
  if (threads < 64) threads = 64;  // threads 0..44 stage the parameters and write the result
  if (threads > 1024) threads = 1024;
  picp_linearize_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, world, meas, weights, out, n);
  return vo_launch_status();
}
