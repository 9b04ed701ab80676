// K11: one Gauss-Newton linearization of projective ICP in one launch: the
// normal system H (6, 6), b (6,) and [chi_in, chi_out, n_in] of N
// correspondences under a given pose, without the solve and the update.
//
// Replaces visual_odometry_tpu/ops/pallas/picp_kernel.py:linearize_pallas
// (body _kernel), which streams point tiles through VMEM and contracts the
// sqrt-weighted Jacobian rows on the MXU. Inputs: the intrinsics K (3, 3),
// the pose to linearize at (4, 4; its first 12 floats are [R|t]), z_near,
// z_far, cols and rows (one float each), world points (N, 3), measurements
// (N, 2) and weights (N,); the robust kernel's threshold and keep_outliers
// by value. Output: 45 floats, H row-major (mirrored from its upper
// triangle), then b, chi_in, chi_out, and the inlier count as an int32.
// Scratch: a ticket counter, zero before the launch and left zero after it,
// and 30 floats a CTA of partials; the wrapper keeps one per device and
// stream, so two launches never share it unless one stream orders them.
//
// The TPU kernel lacks the near-depth guard `hz > 1e-6` that the plain
// linearization (ops/picp.linearize) and every GN loop apply; it is restored
// here, because this kernel uses the lane terms of gn_loop.cuh, which have it.
// A point essentially at the pinhole therefore adds nothing, where the TPU
// kernel lets its 1/z^2 terms into H.
//
// Bound on this card: bytes, N x 24 of input read once, and at the sizes it
// is called with (N <= 8192) the launch. One CTA looping over the points
// added N / 1,024 points a thread in turn on one SM. Design: one point a
// lane over ceil(N / T) CTAs of T = min(256, max(64, N rounded up to a
// warp)) threads (N = 8,192: 32 CTAs), no atomics on values; the wrapper
// picks that geometry (ops/kernels/picp_kernel.linearize_geometry) and
// passes it in, and one that leaves a point without a lane fails the launch. Each CTA sums
// its lanes' 30 terms with the transposed warp sum of gn_loop.cuh
// (warp_sum_terms, the shuffle-down tree's pairs) and folds its warps in
// warp order; the CTA partials are then folded in CTA order by the last CTA
// to finish (a ticket counter after a __threadfence), which writes the
// result and resets the counter. So the output has the same bits in every
// launch, and the plain version (ops/kernels/picp_kernel.linearize_plain,
// frame_kernel._block_sum at that geometry) adds in the same order: the two
// agree bit for bit on the card. One CTA (N <= 256) is the former kernel's geometry and order.
#include "gn_loop.cuh"

#define K11_MAX_THREADS 256

__global__ void __launch_bounds__(K11_MAX_THREADS)
    picp_linearize_kernel(const float* __restrict__ k, const float* __restrict__ pose,
                          const float* __restrict__ z_near, const float* __restrict__ z_far,
                          const float* __restrict__ cols, const float* __restrict__ rows,
                          const float* __restrict__ world, const float* __restrict__ meas,
                          const float* __restrict__ weights, float* __restrict__ out,
                          float* __restrict__ partials, unsigned int* __restrict__ ticket, int n,
                          float kt, float keep_out) {
  constexpr int NRED = GN_NRED_SE3;
  __shared__ float s_par[25];  // K, the pose [R|t], z_near, z_far, cols, rows
  __shared__ float s_red[(K11_MAX_THREADS / 32) * NRED];
  __shared__ float s_sums[NRED];
  __shared__ bool s_last;

  const int t = threadIdx.x;
  if (t < 25) {
    s_par[t] = t < 9     ? k[t]
               : t < 21  ? pose[t - 9]
               : t == 21 ? *z_near
               : t == 22 ? *z_far
               : t == 23 ? *cols
                         : *rows;
  }
  __syncthreads();

  GNParams g;
  g.k = s_par;
  g.z_near = s_par[21];
  g.z_far = s_par[22];
  g.cols = s_par[23];
  g.rows = s_par[24];
  g.kt = kt;
  g.keep_out = keep_out;
  g.damping = 0.0f;
  g.tol = 0.0f;
  g.min_inl = 0.0f;
  g.mount = nullptr;
  g.mount_inv = nullptr;

  float part[32];
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + t;
  if (j < n) {
    gn_point_terms<false>(s_par + 9, g, world[3 * j], world[3 * j + 1], world[3 * j + 2],
                          meas[2 * j], meas[2 * j + 1], weights[j], part);
  } else {
#pragma unroll
    for (int q = 0; q < NRED; ++q) part[q] = 0.0f;
  }
#pragma unroll
  for (int q = NRED; q < 32; ++q) part[q] = 0.0f;

  const int lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const float v = warp_sum_terms<32>(part);
  if (lane < NRED) s_red[warp * NRED + lane] = v;
  __syncthreads();
  const int ctas = gridDim.x;
  if (warp == 0 && lane < NRED) {
    float acc = s_red[lane];
    for (int w = 1; w < nwarps; ++w) acc = acc + s_red[w * NRED + lane];
    if (ctas == 1) {
      s_sums[lane] = acc;
    } else {
      partials[blockIdx.x * NRED + lane] = acc;
      __threadfence();
    }
  }
  if (ctas > 1) {
    __syncthreads();
    if (t == 0) s_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(ctas - 1);
    __syncthreads();
    if (!s_last) return;
    // The last CTA: every other CTA's partial is visible (each was fenced
    // before its ticket). Loads bypass L1, which may hold an earlier
    // launch's partials; eight are issued ahead of their adds.
    __threadfence();
    if (warp == 0 && lane < NRED) {
      float acc = __ldcg(partials + lane);
      int c = 1;
      for (; c + 8 <= ctas; c += 8) {
        float r[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) r[i] = __ldcg(partials + (c + i) * NRED + lane);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = acc + r[i];
      }
      for (; c < ctas; ++c) acc = acc + __ldcg(partials + c * NRED + lane);
      s_sums[lane] = acc;
    }
    if (t == 0) *ticket = 0u;
  }
  __syncthreads();
  if (t < 36) {
    const int r = t / 6, c = t % 6;
    const int lo = r < c ? r : c, hi = r < c ? c : r;
    // Index of (lo, hi) in the row-major upper triangle of a 6 x 6 matrix.
    out[t] = s_sums[lo * 6 - (lo * (lo - 1)) / 2 + (hi - lo)];
  } else if (t < 44) {
    out[t] = s_sums[21 + (t - 36)];
  } else if (t == 44) {
    reinterpret_cast<int*>(out)[44] = static_cast<int>(s_sums[29]);
  }
}

VO_EXPORT int vo_picp_linearize(const float* k, const float* pose, const float* z_near,
                                const float* z_far, const float* cols, const float* rows,
                                const float* world, const float* meas, const float* weights,
                                float* out, float* partials, unsigned int* ticket, int n, int ctas,
                                int threads, float kt, float keep_out, void* stream) {
  // Threads 0..44 stage the inputs and write the result: at least 64.
  if (n < 0 || ctas < 1 || threads < 64 || threads > K11_MAX_THREADS || threads % 32 != 0 ||
      static_cast<long long>(ctas) * threads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  picp_linearize_kernel<<<ctas, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      k, pose, z_near, z_far, cols, rows, world, meas, weights, out, partials, ticket, n, kt,
      keep_out);
  return vo_launch_status();
}
