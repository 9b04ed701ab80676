// K4: the whole tracked-frame loop of one sequence in one launch (SE(3)).
//
// Replaces visual_odometry_tpu/ops/pallas/frame_kernel.py:track_frames_fused
// (_run_batched, body _kernel) with picp_kernel.py:gn_loop inside. Per frame:
//   1. world join: each lane takes the first candidate of its precomputed
//      chain (K2) whose carried triangulation is valid, moved into the
//      previous camera by the carried pose (vo_complete.cpp:52-66, 159);
//   2. Gauss-Newton projective ICP from identity (or the carried pose with
//      warm_start) with the tolerance early exit: per round 30 lane sums
//      (21 of H, 6 of b, 3 stats), the Jacobi-scaled 3x3-block Schur solve
//      with adjugate inverses, and the Euler-chart left update
//      (picp_solver.cpp:25-112, utils.h:73-78);
//   3. mid-point triangulation in previous-frame coordinates with the
//      determinant and finiteness guards (utils.cpp:36-76);
//   4. the pose, the stats row [chi_in, chi_out, n_in, sum(weight)] and the
//      triangulation rows.
//
// Bound on this card: latency, not bytes or FLOPs. The frames and the GN
// rounds inside them are a chain of dependent steps, each a block-wide
// reduction followed by a 6x6 solve on one thread. Design: one CTA per
// sequence, one thread per correspondence lane (S <= 1024), the loop over
// frames inside the kernel. Pose and triangulation stay resident in shared
// memory for the whole sequence; the TPU kernel's VMEM frame blocking has no
// counterpart. The carried triangulation lives in two ping-pong buffers:
// frame k's join reads frame k-1's rows while frame k's triangulation writes
// the other buffer, so one barrier per frame orders them. A GN round costs
// two barriers: warp-shuffle sums land in shared memory, warp 0 adds the
// per-warp partials, thread 0 solves and publishes the pose and the
// block-uniform exit flag.
//
// The expressions keep the TPU kernel's operation order term by term and the
// library is built with --fmad=false; the plain PyTorch version
// (ops/kernels/frame_kernel.track_frames_plain) also adds the lane sums in
// this kernel's order, takes a correctly rounded sqrt and takes sin/cos from
// the card's libm, so the two agree bit for bit on the card.
#include "common.cuh"

#define NRED 30
#define DET_EPS 1e-12f

struct GNControl {
  int it;
  float active, chi_in, chi_out, n_in;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ void inv3(const float* m, float* out) {
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5], g = m[6], h = m[7],
              i = m[8];
  const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
  const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
  const float G = d * h - e * g, H = b * g - a * h, I = a * e - b * d;
  const float det = a * A + b * D + c * G;
  const float inv_det = 1.0f / det;
  out[0] = A * inv_det; out[1] = B * inv_det; out[2] = C * inv_det;
  out[3] = D * inv_det; out[4] = E * inv_det; out[5] = F * inv_det;
  out[6] = G * inv_det; out[7] = H * inv_det; out[8] = I * inv_det;
}

__device__ void mat3mul(const float* m, const float* n, float* out) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      out[3 * r + c] = m[3 * r] * n[c] + m[3 * r + 1] * n[3 + c] + m[3 * r + 2] * n[6 + c];
}

__device__ void mat3vec(const float* m, const float* v, float* out) {
  for (int r = 0; r < 3; ++r) out[r] = m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2];
}

__device__ void transpose3(const float* m, float* out) {
  out[0] = m[0]; out[1] = m[3]; out[2] = m[6];
  out[3] = m[1]; out[4] = m[4]; out[5] = m[7];
  out[6] = m[2]; out[7] = m[5]; out[8] = m[8];
}

// One damped GN solve + Euler-chart update (picp_kernel.py:362-424), on the
// 30 sums in the TPU kernel's order: H upper triangle row-major, b, then
// chi_in, chi_out, n_in. Updates pose (3x4 row-major) and ctl in place.
__device__ void gn_update(const float* sums, float damping, float tol, float min_inl, float* pose,
                          GNControl* ctl) {
  float hm[6][6];
  int q = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) hm[i][j] = sums[q++];
  const float* bv = sums + 21;
  const float new_chi_in = sums[27], new_chi_out = sums[28], new_n_in = sums[29];

  float sc[6];
  for (int i = 0; i < 6; ++i) {
    const float m = hm[i][i] + damping;
    sc[i] = 1.0f / sqrtf(fmaxf(m, 1e-30f));
  }
  auto se = [&](int i, int j) {
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    return hm[lo][hi] * sc[i] * sc[j];
  };
  const float A[9] = {1.0f, se(0, 1), se(0, 2), se(0, 1), 1.0f, se(1, 2), se(0, 2), se(1, 2), 1.0f};
  const float B[9] = {se(0, 3), se(0, 4), se(0, 5), se(1, 3), se(1, 4),
                      se(1, 5), se(2, 3), se(2, 4), se(2, 5)};
  const float Dm[9] = {1.0f, se(3, 4), se(3, 5), se(3, 4), 1.0f, se(4, 5), se(3, 5), se(4, 5), 1.0f};
  const float r1[3] = {-bv[0] * sc[0], -bv[1] * sc[1], -bv[2] * sc[2]};
  const float r2[3] = {-bv[3] * sc[3], -bv[4] * sc[4], -bv[5] * sc[5]};
  float Ai[9], Bt[9], AiB[9], BtAiB[9], S[9], Si[9];
  inv3(A, Ai);
  transpose3(B, Bt);
  mat3mul(Ai, B, AiB);
  mat3mul(Bt, AiB, BtAiB);
  for (int k = 0; k < 9; ++k) S[k] = Dm[k] - BtAiB[k];
  inv3(S, Si);
  float Air1[3], BtAir1[3], t_r2[3], x2[3], Bx2[3], t_r1[3], x1[3];
  mat3vec(Ai, r1, Air1);
  mat3vec(Bt, Air1, BtAir1);
  for (int k = 0; k < 3; ++k) t_r2[k] = r2[k] - BtAir1[k];
  mat3vec(Si, t_r2, x2);
  mat3vec(B, x2, Bx2);
  for (int k = 0; k < 3; ++k) t_r1[k] = r1[k] - Bx2[k];
  mat3vec(Ai, t_r1, x1);
  const float y[6] = {x1[0], x1[1], x1[2], x2[0], x2[1], x2[2]};
  const bool enough = new_n_in >= min_inl;
  float dx[6];
  for (int i = 0; i < 6; ++i) dx[i] = enough ? y[i] * sc[i] : 0.0f;
  float dx2 = dx[0] * dx[0];
  for (int i = 1; i < 6; ++i) dx2 = dx2 + dx[i] * dx[i];

  const float sa = sinf(dx[3]), ca = cosf(dx[3]);
  const float sb = sinf(dx[4]), cb = cosf(dx[4]);
  const float ss = sinf(dx[5]), cc = cosf(dx[5]);
  const float rd[9] = {cb * cc,
                       -cb * ss,
                       sb,
                       ca * ss + sa * sb * cc,
                       ca * cc - sa * sb * ss,
                       -sa * cb,
                       sa * ss - ca * sb * cc,
                       sa * cc + ca * sb * ss,
                       ca * cb};
  const float r_old[9] = {pose[0], pose[1], pose[2], pose[4], pose[5],
                          pose[6], pose[8], pose[9], pose[10]};
  const float t_old[3] = {pose[3], pose[7], pose[11]};
  float r_new[9], t_rot[3];
  mat3mul(rd, r_old, r_new);
  mat3vec(rd, t_old, t_rot);
  for (int r = 0; r < 3; ++r) {
    pose[4 * r + 0] = r_new[3 * r + 0];
    pose[4 * r + 1] = r_new[3 * r + 1];
    pose[4 * r + 2] = r_new[3 * r + 2];
    pose[4 * r + 3] = t_rot[r] + dx[r];
  }
  ctl->it += 1;
  ctl->active = (enough && dx2 > tol) ? 1.0f : 0.0f;
  ctl->chi_in = new_chi_in;
  ctl->chi_out = new_chi_out;
  ctl->n_in = new_n_in;
}

// params: [z_near, z_far, cols, rows, kt, keep_outliers, damping, tol,
//          warm_start, min_num_inliers, K (9), K^-1 (9), initial pose 3x4 (12)]
__global__ void __launch_bounds__(1024)
    track_frames_kernel(const float* __restrict__ params, const float* __restrict__ init_tri,
                        const uint8_t* __restrict__ init_ok, const int* __restrict__ cand_idx,
                        const uint8_t* __restrict__ cand_ok, const float* __restrict__ prev_al,
                        const float* __restrict__ cur_al, const uint8_t* __restrict__ corr_valid,
                        float* __restrict__ poses, float* __restrict__ tri_out,
                        uint8_t* __restrict__ tri_ok_out, float* __restrict__ stats, int frames,
                        int s, int depth, int num_iterations, int min_iterations) {
  extern __shared__ float tri_buf[];  // 2 x (s, 4): x, y, z, ok — ping-pong
  __shared__ float s_par[40];
  __shared__ float s_cpose[12];       // carried pose, read by the join
  __shared__ float s_pose[12];        // GN working pose
  __shared__ float s_red[32 * NRED];  // per-warp partial sums
  __shared__ float s_sums[NRED];
  __shared__ GNControl s_ctl;

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool in_range = j < s;

  if (j < 40) s_par[j] = params[j];
  __syncthreads();
  if (j < 12) s_cpose[j] = s_par[28 + j];
  if (in_range) {
    const bool ok0 = init_ok[j] != 0;
    tri_buf[4 * j + 0] = init_tri[3 * j + 0];
    tri_buf[4 * j + 1] = init_tri[3 * j + 1];
    tri_buf[4 * j + 2] = init_tri[3 * j + 2];
    tri_buf[4 * j + 3] = ok0 ? 1.0f : 0.0f;
  }
  __syncthreads();

  const float z_near = s_par[0], z_far = s_par[1], cols = s_par[2], rows = s_par[3];
  const float kt = s_par[4], keep_out = s_par[5], damping = s_par[6], tol = s_par[7];
  const float warm = s_par[8], min_inl = s_par[9];
  const float* k = s_par + 10;
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
      for (int q = 0; q < 12; ++q) {
        const float eye = (q == 0 || q == 5 || q == 10) ? 1.0f : 0.0f;
        s_pose[q] = warm > 0.5f ? s_cpose[q] : eye;
      }
      s_ctl.it = 0;
      s_ctl.active = 1.0f;
      s_ctl.chi_in = 0.0f;
      s_ctl.chi_out = 0.0f;
      s_ctl.n_in = 0.0f;
    }
    // The barrier also publishes the initial GN state written above.
    const int n_weight = __syncthreads_count(have);

    // ---- Gauss-Newton with early exit ----
    while (true) {
      const int it = s_ctl.it;
      if (!(it < num_iterations && (s_ctl.active > 0.5f || it < min_iterations))) break;
      const float* P = s_pose;
      float part[NRED];
      if (in_range) {
        const float px = P[0] * gwx + P[1] * gwy + P[2] * gwz + P[3];
        const float py = P[4] * gwx + P[5] * gwy + P[6] * gwz + P[7];
        const float pz = P[8] * gwx + P[9] * gwy + P[10] * gwz + P[11];
        const float hx = k[0] * px + k[1] * py + k[2] * pz;
        const float hy = k[3] * px + k[4] * py + k[5] * pz;
        const float hz = k[6] * px + k[7] * py + k[8] * pz;
        const float iz = 1.0f / (hz == 0.0f ? 1.0f : hz);
        const float u = hx * iz, v = hy * iz;
        const bool valid = (pz <= z_far) && (pz >= z_near) && (hz > 1e-6f) && (u >= 0.0f) &&
                           (u <= cols - 1.0f) && (v >= 0.0f) && (v <= rows - 1.0f);
        const float ex = u - gmx, ey = v - gmy;
        const float chi = ex * ex + ey * ey;
        const bool is_out = chi > kt;
        const float lam = is_out ? sqrtf(kt / fmaxf(chi, 1e-30f)) : 1.0f;
        const float live = weight * (valid ? 1.0f : 0.0f);
        const float w = live * (is_out ? keep_out : 1.0f) * lam;
        const float iz2 = iz * iz;
        const float a00 = k[0] * iz - k[6] * hx * iz2;
        const float a01 = k[1] * iz - k[7] * hx * iz2;
        const float a02 = k[2] * iz - k[8] * hx * iz2;
        const float a10 = k[3] * iz - k[6] * hy * iz2;
        const float a11 = k[4] * iz - k[7] * hy * iz2;
        const float a12 = k[5] * iz - k[8] * hy * iz2;
        const float jx[6] = {a00, a01, a02, a01 * (-pz) + a02 * py, a00 * pz + a02 * (-px),
                             a00 * (-py) + a01 * px};
        const float jy[6] = {a10, a11, a12, a11 * (-pz) + a12 * py, a10 * pz + a12 * (-px),
                             a10 * (-py) + a11 * px};
        const float is_out_f = is_out ? 1.0f : 0.0f;
        const float inl = live * (1.0f - is_out_f);
        int q = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = a; b < 6; ++b) part[q++] = w * (jx[a] * jx[b] + jy[a] * jy[b]);
        for (int a = 0; a < 6; ++a) part[q++] = w * (jx[a] * ex + jy[a] * ey);
        part[27] = chi * inl;
        part[28] = chi * live * is_out_f;
        part[29] = inl;
      } else {
        for (int q = 0; q < NRED; ++q) part[q] = 0.0f;
      }
      for (int q = 0; q < NRED; ++q) {
        const float v = warp_sum(part[q]);
        if (lane == 0) s_red[warp * NRED + q] = v;
      }
      __syncthreads();
      if (warp == 0) {
        if (lane < NRED) {
          float acc = s_red[lane];
          for (int w = 1; w < nwarps; ++w) acc += s_red[w * NRED + lane];
          s_sums[lane] = acc;
        }
        __syncwarp();
        if (lane == 0) {
          GNControl ctl = s_ctl;
          gn_update(s_sums, damping, tol, min_inl, s_pose, &ctl);
          s_ctl = ctl;
        }
      }
      __syncthreads();
    }

    // ---- mid-point triangulation in previous-frame coordinates ----
    const float* P = s_pose;
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
      st[0] = s_ctl.chi_in;
      st[1] = s_ctl.chi_out;
      st[2] = s_ctl.n_in;
      st[3] = static_cast<float>(n_weight);
    }
    // Frame k+1 reads dst_buf and s_cpose, and re-initializes s_pose.
    __syncthreads();
  }
}

VO_EXPORT int vo_track_frames(const float* params, const float* init_tri, const uint8_t* init_ok,
                              const int* cand_idx, const uint8_t* cand_ok, const float* prev_al,
                              const float* cur_al, const uint8_t* corr_valid, float* poses,
                              float* tri_out, uint8_t* tri_ok_out, float* stats, int frames, int s,
                              int depth, int num_iterations, int min_iterations, void* stream) {
  if (frames <= 0) return 0;
  if (s < 1 || s > 1024 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((s + 31) / 32) * 32;
  if (threads < 64) threads = 64;  // thread 0..39 stage the parameters
  size_t smem = 2 * 4 * static_cast<size_t>(s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(track_frames_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  track_frames_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, init_tri, init_ok, cand_idx, cand_ok, prev_al, cur_al, corr_valid, poses, tri_out,
      tri_ok_out, stats, frames, s, depth, num_iterations, min_iterations);
  return vo_launch_status();
}
