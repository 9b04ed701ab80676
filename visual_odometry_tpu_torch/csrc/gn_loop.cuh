// The Gauss-Newton projective-ICP loop as device functions, shared by the
// fused frame kernels (track_frames.cu: K4 SE(3), K5 planar) and the
// standalone solves (picp_solve.cu: K6).
//
// Replaces visual_odometry_tpu/ops/pallas/picp_kernel.py:gn_loop (SE(3)) and
// gn_loop_se2 (the planar twin: increments d = (dx, dy, dtheta) act on the
// world-in-camera pose conjugated through the camera mount c,
// X <- c^-1 T(d) c X, so the relative robot motion stays in SE(2)).
//
// One round = every thread's lane terms (30 for SE(3): 21 of H's upper
// triangle, 6 of b, 3 stats; 12 for planar: 6 + 3 + 3), a block-wide sum,
// and one damped, Jacobi-scaled solve plus pose update on warp 0. The
// block sum has one fixed order, which the plain PyTorch versions repeat
// (ops/kernels/frame_kernel._block_sum): a shuffle-down tree inside each
// warp (lane l takes lane l + o at o = 16, 8, 4, 2, 1), then the warps'
// partials added in warp order. A thread that owns several points (K6 with
// N > blockDim.x) adds them first, in ascending point order.
//
// What bounds a round on the card is one SM's issue rate and the chain
// through the solve. On an H100 80GB HBM3 (700 W), K4's round at 1,024 lanes
// on one CTA spent ~5,500 of its ~11,000 cycles in 30 shuffle-down trees a
// warp (150 shuffles, one warp-shuffle a clock an SM), ~2,300 in the lane
// terms and ~2,400 in the solve on one thread (clock64() stamps,
// chip_ab.py phases). So:
//  - the warp sum is transposed (warp_sum_terms): the terms are padded to 32
//    (16 planar) and halved across the warp, each lane keeping half of its
//    terms and adding its xor partner's copy of that half, 31 shuffles a
//    warp; the pairs that meet are the tree's pairs, and float addition
//    commutes bitwise, so lane q ends with the tree's sum of term q, bit for
//    bit. Lane q stores term q, and warp 0's lane q folds the warps' partials
//    of term q in warp order, the loads issued ahead of the adds;
//  - warp 0 solves, its lanes sharing the independent pieces (gn_update).
//    Every warp solving for itself would save one barrier but spend 32
//    warps' issue slots on the solve's few hundred instructions;
//  - a wide solve may split its lanes over a thread block cluster (gn_solve),
//    so that the lane terms and warp sums of 1,024 lanes run on four SMs;
//  - the standalone solve (K6) spreads up to 2,048 lanes over a cluster of
//    up to 8 CTAs of up to 256 threads, more warps than red holds, and
//    sums in two levels (gn_solve_ranked): each CTA folds its own warps in
//    warp order, then every CTA folds the CTAs' partials in rank order.
//
// The expressions keep the TPU kernel's operation order term by term and the
// library is built with --fmad=false, so kernel and plain version round
// alike. The callers' lane functors supply the per-thread terms; everything
// that touches shared memory is here.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define GN_NRED_SE3 30
#define GN_NRED_SE2 12
#define GN_MAX_WARPS 32  // of a solve, over all the CTAs of a cluster
#define GN_MAX_CLUSTER 4
#define GN_MAX_RANKS 8  // CTAs of a ranked solve's cluster (gn_solve_ranked, K6)

struct GNControl {
  int it;
  float active, chi_in, chi_out, n_in;
};

// Knobs and camera of one solve; k points at the 9 row-major intrinsics.
// mount / mount_inv ([R|t], 12 floats each) are read by the planar loop only.
struct GNParams {
  float z_near, z_far, cols, rows, kt, keep_out, damping, tol, min_inl;
  const float* k;
  const float* mount;
  const float* mount_inv;
};

// The loop's shared-memory state. pose is the working [R|t] (3x4 row-major),
// published by warp 0 after every round. red holds every warp's partials, by
// round parity: in a cluster, a CTA may write round r + 1's while another
// still folds round r's.
struct GNShared {
  float pose[12];
  float red[2 * GN_MAX_WARPS * GN_NRED_SE3];
  float sums[GN_NRED_SE3];
  GNControl ctl;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One halving step at xor offset O and the steps below it: a lane keeps the
// half of its 2 O terms that its bit O selects and adds its partner's copy of
// that half. O is a template constant, so every index is too and the terms
// stay in registers.
template <int O, int NPAD>
__device__ __forceinline__ void halve_terms(float (&t)[NPAD], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? t[i] : t[O + i];
    const float keep = upper ? t[O + i] : t[i];
    t[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) halve_terms<O / 2, NPAD>(t, lane);
}

// The warp sum of NPAD terms a lane (32, or 16 for the planar group),
// transposed: on return lane q holds warp_sum of term q (q < NPAD; lanes
// 16..31 repeat lanes 0..15 when NPAD = 16), bit for bit. t is clobbered.
template <int NPAD>
__device__ __forceinline__ float warp_sum_terms(float (&t)[NPAD]) {
  const int lane = threadIdx.x & 31;
  if constexpr (NPAD == 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = t[i] + __shfl_xor_sync(0xffffffffu, t[i], 16);
  }
  halve_terms<NPAD / 2, NPAD>(t, lane);
  return t[0];
}

// Cycle stamps of a round's phases, compiled only into the diagnostic builds
// of chip_ab.py (-DVO_GN_PHASES; -DVO_GN_TREE_SUMS swaps in the 30 shuffle
// trees the warp sum had before); thread 0 adds each phase's clock64() cycles
// to vo_gn_phase_cycles. Slots: 0 lane terms, 1 warp sum and stores, 2 wait
// for the other warps, 3 cross-warp fold, 4 solve, 5 second barrier, 6
// rounds, 7 frames (track_frames.cu: 8 join, 9 triangulation and stores).
#ifdef VO_GN_PHASES
__device__ unsigned long long vo_gn_phase_cycles[16];
#define GN_STAMPS(...) long long __VA_ARGS__
#define GN_STAMP(var) var = clock64()
#define GN_PHASE(slot, a, b) \
  if (threadIdx.x == 0) atomicAdd(&vo_gn_phase_cycles[slot], static_cast<unsigned long long>((b) - (a)))
#else
#define GN_STAMPS(...)
#define GN_STAMP(var)
#define GN_PHASE(slot, a, b)
#endif

__device__ inline void inv3(const float* m, float* out) {
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

__device__ inline void mat3mul(const float* m, const float* n, float* out) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      out[3 * r + c] = m[3 * r] * n[c] + m[3 * r + 1] * n[3 + c] + m[3 * r + 2] * n[6 + c];
}

__device__ inline void mat3vec(const float* m, const float* v, float* out) {
  for (int r = 0; r < 3; ++r) out[r] = m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2];
}

__device__ inline void transpose3(const float* m, float* out) {
  out[0] = m[0]; out[1] = m[3]; out[2] = m[6];
  out[3] = m[1]; out[4] = m[4]; out[5] = m[7];
  out[6] = m[2]; out[7] = m[5]; out[8] = m[8];
}

// The projection, frustum test, robust kernel and A = Jp K rows of one
// point under pose P (picp_kernel.py:293-324): shared by both groups.
struct GNPoint {
  float px, py, pz, ex, ey, chi, live, w, is_out_f;
  float a00, a01, a02, a10, a11, a12;
};

__device__ __forceinline__ GNPoint gn_project(const float* P, const GNParams& g, float wx, float wy,
                                              float wz, float mx, float my, float wgt) {
  const float* k = g.k;
  GNPoint o;
  o.px = P[0] * wx + P[1] * wy + P[2] * wz + P[3];
  o.py = P[4] * wx + P[5] * wy + P[6] * wz + P[7];
  o.pz = P[8] * wx + P[9] * wy + P[10] * wz + P[11];
  const float hx = k[0] * o.px + k[1] * o.py + k[2] * o.pz;
  const float hy = k[3] * o.px + k[4] * o.py + k[5] * o.pz;
  const float hz = k[6] * o.px + k[7] * o.py + k[8] * o.pz;
  const float iz = 1.0f / (hz == 0.0f ? 1.0f : hz);
  const float u = hx * iz, v = hy * iz;
  const bool valid = (o.pz <= g.z_far) && (o.pz >= g.z_near) && (hz > 1e-6f) && (u >= 0.0f) &&
                     (u <= g.cols - 1.0f) && (v >= 0.0f) && (v <= g.rows - 1.0f);
  o.ex = u - mx;
  o.ey = v - my;
  o.chi = o.ex * o.ex + o.ey * o.ey;
  const bool is_out = o.chi > g.kt;
  const float lam = is_out ? sqrtf(g.kt / fmaxf(o.chi, 1e-30f)) : 1.0f;
  o.live = wgt * (valid ? 1.0f : 0.0f);
  o.w = o.live * (is_out ? g.keep_out : 1.0f) * lam;
  o.is_out_f = is_out ? 1.0f : 0.0f;
  const float iz2 = iz * iz;
  o.a00 = k[0] * iz - k[6] * hx * iz2;
  o.a01 = k[1] * iz - k[7] * hx * iz2;
  o.a02 = k[2] * iz - k[8] * hx * iz2;
  o.a10 = k[3] * iz - k[6] * hy * iz2;
  o.a11 = k[4] * iz - k[7] * hy * iz2;
  o.a12 = k[5] * iz - k[8] * hy * iz2;
  return o;
}

// One point's terms of the round's sums. SE(3): 30 terms in the order H
// upper triangle row-major, b, chi_in, chi_out, n_in. Planar: 12 terms, the
// Jacobian columns being row0(c_R), row1(c_R) and qx*row1 - qy*row0 against
// the shared A rows (picp_kernel.py:680-706).
template <bool PLANAR>
__device__ __forceinline__ void gn_point_terms(const float* P, const GNParams& g, float wx, float wy,
                                               float wz, float mx, float my, float wgt,
                                               float* part) {
  const GNPoint o = gn_project(P, g, wx, wy, wz, mx, my, wgt);
  const float inl = o.live * (1.0f - o.is_out_f);
  constexpr int DOF = PLANAR ? 3 : 6;
  float jx[DOF], jy[DOF];
  if (PLANAR) {
    const float* c = g.mount;
    const float qx = c[0] * o.px + c[1] * o.py + c[2] * o.pz + c[3];
    const float qy = c[4] * o.px + c[5] * o.py + c[6] * o.pz + c[7];
    const float ctx0 = qx * c[4] - qy * c[0];
    const float ctx1 = qx * c[5] - qy * c[1];
    const float ctx2 = qx * c[6] - qy * c[2];
    jx[0] = o.a00 * c[0] + o.a01 * c[1] + o.a02 * c[2];
    jx[1] = o.a00 * c[4] + o.a01 * c[5] + o.a02 * c[6];
    jx[2] = o.a00 * ctx0 + o.a01 * ctx1 + o.a02 * ctx2;
    jy[0] = o.a10 * c[0] + o.a11 * c[1] + o.a12 * c[2];
    jy[1] = o.a10 * c[4] + o.a11 * c[5] + o.a12 * c[6];
    jy[2] = o.a10 * ctx0 + o.a11 * ctx1 + o.a12 * ctx2;
  } else {
    jx[0] = o.a00;
    jx[1] = o.a01;
    jx[2] = o.a02;
    jx[3] = o.a01 * (-o.pz) + o.a02 * o.py;
    jx[4] = o.a00 * o.pz + o.a02 * (-o.px);
    jx[5] = o.a00 * (-o.py) + o.a01 * o.px;
    jy[0] = o.a10;
    jy[1] = o.a11;
    jy[2] = o.a12;
    jy[3] = o.a11 * (-o.pz) + o.a12 * o.py;
    jy[4] = o.a10 * o.pz + o.a12 * (-o.px);
    jy[5] = o.a10 * (-o.py) + o.a11 * o.px;
  }
  int q = 0;
#pragma unroll
  for (int a = 0; a < DOF; ++a)
#pragma unroll
    for (int b = a; b < DOF; ++b) part[q++] = o.w * (jx[a] * jx[b] + jy[a] * jy[b]);
#pragma unroll
  for (int a = 0; a < DOF; ++a) part[q++] = o.w * (jx[a] * o.ex + jy[a] * o.ey);
  part[q++] = o.chi * inl;
  part[q++] = o.chi * o.live * o.is_out_f;
  part[q++] = inl;
}

// The solves below run on all 32 lanes of warp 0 alike. The pieces that do
// not depend on each other are spread over lanes (a Jacobi scale a lane, a
// sine or cosine a lane) and gathered by shuffles; each keeps its expression,
// so the result is the one lane 0 alone would compute. Lane 0 writes the
// pose after the warp has read the old one.
__device__ __forceinline__ void gn_write_pose(float* pose, const float* r_new, const float* t_new,
                                              int lane) {
  __syncwarp();
  if (lane == 0) {
    for (int r = 0; r < 3; ++r) {
      pose[4 * r + 0] = r_new[3 * r + 0];
      pose[4 * r + 1] = r_new[3 * r + 1];
      pose[4 * r + 2] = r_new[3 * r + 2];
      pose[4 * r + 3] = t_new[r];
    }
  }
}

// One damped GN solve + Euler-chart update (picp_kernel.py:362-424), on the
// 30 sums. Updates pose (3x4 row-major) and ctl in place.
__device__ inline void gn_update(const float* sums, const GNParams& g, float* pose,
                                 GNControl* ctl, int lane) {
  float hm[6][6];
  int q = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) hm[i][j] = sums[q++];
  const float* bv = sums + 21;
  const float new_chi_in = sums[27], new_chi_out = sums[28], new_n_in = sums[29];

  // Lane i < 6 takes H[i][i], the 0th, 6th, 11th, 15th, 18th and 20th sum.
  const int i6 = lane % 6;
  const float m = sums[i6 * (13 - i6) / 2] + g.damping;
  const float my_sc = 1.0f / sqrtf(fmaxf(m, 1e-30f));
  float sc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) sc[i] = __shfl_sync(0xffffffffu, my_sc, i);
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
  const bool enough = new_n_in >= g.min_inl;
  float dx[6];
  for (int i = 0; i < 6; ++i) dx[i] = enough ? y[i] * sc[i] : 0.0f;
  float dx2 = dx[0] * dx[0];
  for (int i = 1; i < 6; ++i) dx2 = dx2 + dx[i] * dx[i];

  // Lanes 0-2: sin of dx[3..5]; the others: cos of dx[3 + lane % 3].
  const int k3 = lane % 3;
  const float angle = k3 == 0 ? dx[3] : (k3 == 1 ? dx[4] : dx[5]);
  float trig;
  if (lane < 3) {
    trig = sinf(angle);
  } else {
    trig = cosf(angle);
  }
  const float sa = __shfl_sync(0xffffffffu, trig, 0), ca = __shfl_sync(0xffffffffu, trig, 3);
  const float sb = __shfl_sync(0xffffffffu, trig, 1), cb = __shfl_sync(0xffffffffu, trig, 4);
  const float ss = __shfl_sync(0xffffffffu, trig, 2), cc = __shfl_sync(0xffffffffu, trig, 5);
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
  const float t_new[3] = {t_rot[0] + dx[0], t_rot[1] + dx[1], t_rot[2] + dx[2]};
  gn_write_pose(pose, r_new, t_new, lane);
  ctl->it += 1;
  ctl->active = (enough && dx2 > g.tol) ? 1.0f : 0.0f;
  ctl->chi_in = new_chi_in;
  ctl->chi_out = new_chi_out;
  ctl->n_in = new_n_in;
}

// The planar twin (picp_kernel.py:719-766) on the 12 sums: a Jacobi-scaled
// 3x3 solve through the adjugate inverse, then X <- c^-1 T(d) c X with
// incr_R = c_inv_R (T(dtheta) c_R) and incr_t = c_inv_R (T c_t + d) + c_inv_t.
__device__ inline void gn_update_se2(const float* sums, const GNParams& g, float* pose,
                                     GNControl* ctl, int lane) {
  const float h00 = sums[0], h01 = sums[1], h02 = sums[2], h11 = sums[3], h12 = sums[4],
              h22 = sums[5];
  const float* bv = sums + 6;
  const float new_chi_in = sums[9], new_chi_out = sums[10], new_n_in = sums[11];
  const int k3 = lane % 3;
  const float hd = k3 == 0 ? h00 : (k3 == 1 ? h11 : h22);
  const float my_sc = 1.0f / sqrtf(fmaxf(hd + g.damping, 1e-30f));
  const float sc0 = __shfl_sync(0xffffffffu, my_sc, 0);
  const float sc1 = __shfl_sync(0xffffffffu, my_sc, 1);
  const float sc2 = __shfl_sync(0xffffffffu, my_sc, 2);
  const float s01 = h01 * sc0 * sc1, s02 = h02 * sc0 * sc2, s12 = h12 * sc1 * sc2;
  const float A[9] = {1.0f, s01, s02, s01, 1.0f, s12, s02, s12, 1.0f};
  float Ai[9], y[3];
  inv3(A, Ai);
  const float r1[3] = {-bv[0] * sc0, -bv[1] * sc1, -bv[2] * sc2};
  mat3vec(Ai, r1, y);
  const bool enough = new_n_in >= g.min_inl;
  const float dx[3] = {enough ? y[0] * sc0 : 0.0f, enough ? y[1] * sc1 : 0.0f,
                       enough ? y[2] * sc2 : 0.0f};
  float dx2 = dx[0] * dx[0];
  dx2 = dx2 + dx[1] * dx[1];
  dx2 = dx2 + dx[2] * dx[2];

  float trig;
  if (lane == 0) {
    trig = sinf(dx[2]);
  } else {
    trig = cosf(dx[2]);
  }
  const float sth = __shfl_sync(0xffffffffu, trig, 0), cth = __shfl_sync(0xffffffffu, trig, 1);
  const float tr[9] = {cth, -sth, 0.0f * cth, sth, cth, 0.0f * cth,
                       0.0f * cth, 0.0f * cth, 1.0f + 0.0f * cth};
  const float* c = g.mount;
  const float* ci = g.mount_inv;
  const float c_r[9] = {c[0], c[1], c[2], c[4], c[5], c[6], c[8], c[9], c[10]};
  const float ci_r[9] = {ci[0], ci[1], ci[2], ci[4], ci[5], ci[6], ci[8], ci[9], ci[10]};
  const float c_t[3] = {c[3], c[7], c[11]};
  float trcr[9], incr_r[9], trc[3], incr_t[3];
  mat3mul(tr, c_r, trcr);
  mat3mul(ci_r, trcr, incr_r);
  mat3vec(tr, c_t, trc);
  trc[0] = trc[0] + dx[0];
  trc[1] = trc[1] + dx[1];
  mat3vec(ci_r, trc, incr_t);
  incr_t[0] = incr_t[0] + ci[3];
  incr_t[1] = incr_t[1] + ci[7];
  incr_t[2] = incr_t[2] + ci[11];

  const float r_old[9] = {pose[0], pose[1], pose[2], pose[4], pose[5],
                          pose[6], pose[8], pose[9], pose[10]};
  const float t_old[3] = {pose[3], pose[7], pose[11]};
  float r_new[9], t_rot[3];
  mat3mul(incr_r, r_old, r_new);
  mat3vec(incr_r, t_old, t_rot);
  const float t_new[3] = {t_rot[0] + incr_t[0], t_rot[1] + incr_t[1], t_rot[2] + incr_t[2]};
  gn_write_pose(pose, r_new, t_new, lane);
  ctl->it += 1;
  ctl->active = (enough && dx2 > g.tol) ? 1.0f : 0.0f;
  ctl->chi_in = new_chi_in;
  ctl->chi_out = new_chi_out;
  ctl->n_in = new_n_in;
}

// Thread 0 sets the loop's start state; the caller's next barrier publishes it.
__device__ __forceinline__ void gn_init(GNShared* sh, const float* pose0) {
  for (int q = 0; q < 12; ++q) sh->pose[q] = pose0[q];
  sh->ctl.it = 0;
  sh->ctl.active = 1.0f;
  sh->ctl.chi_in = 0.0f;
  sh->ctl.chi_out = 0.0f;
  sh->ctl.n_in = 0.0f;
}

// The GN loop with the tolerance early exit. Every thread of the block calls
// it after a barrier that follows gn_init. lane_terms(P, part) fills this
// thread's NRED terms under pose P (zeros for a thread without a point). On
// return sh->pose and sh->ctl hold the result, visible to every thread. A
// round costs two barriers: one before the fold, one after the solve.
//
// cluster > 1: the solve's lanes are split over the CTAs of a thread block
// cluster (rank r holds warps r * W .. r * W + W - 1, W = blockDim.x / 32).
// Each warp's partials go to every CTA's red (distributed shared memory),
// the first barrier is the cluster's, and every CTA folds all the warps in
// warp order and solves, so each ends the round with the same pose bits.
template <bool PLANAR, typename LaneTerms>
__device__ __forceinline__ void gn_solve(GNShared* sh, const GNParams& g, int num_iterations,
                                         int min_iterations, LaneTerms lane_terms,
                                         int cluster = 1) {
  constexpr int NRED = PLANAR ? GN_NRED_SE2 : GN_NRED_SE3;
  constexpr int NPAD = PLANAR ? 16 : 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpc = blockDim.x >> 5;
  const int nwarps = wpc * cluster;
  const int gwarp = (cluster > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0) * wpc + warp;
  while (true) {
    const int it = sh->ctl.it;
    if (!(it < num_iterations && (sh->ctl.active > 0.5f || it < min_iterations))) break;
    GN_STAMPS(t0, t1, t2, t3, t4, t5, t6);
    GN_STAMP(t0);
    float part[NPAD];
    lane_terms(sh->pose, part);
#pragma unroll
    for (int q = NRED; q < NPAD; ++q) part[q] = 0.0f;
    GN_STAMP(t1);
    float* red = sh->red + (it & 1) * (GN_MAX_WARPS * NRED);
#ifdef VO_GN_TREE_SUMS  // diagnostic builds only: one shuffle-down tree a term, as before
#pragma unroll
    for (int q = 0; q < NRED; ++q) {
      const float v = warp_sum(part[q]);
      if (lane == 0) red[gwarp * NRED + q] = v;  // one CTA only
    }
#else
    const float v = warp_sum_terms<NPAD>(part);
    if (lane < NRED) {
      if (cluster > 1) {
        for (int r = 0; r < cluster; ++r)
          cg::this_cluster().map_shared_rank(red, r)[gwarp * NRED + lane] = v;
      } else {
        red[gwarp * NRED + lane] = v;
      }
    }
#endif
    GN_STAMP(t2);
    if (cluster > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    GN_STAMP(t3);
    if (warp == 0) {
      if (lane < NRED) {
        float r[GN_MAX_WARPS];
#pragma unroll
        for (int w = 0; w < GN_MAX_WARPS; ++w) r[w] = w < nwarps ? red[w * NRED + lane] : 0.0f;
        float acc = r[0];
#pragma unroll
        for (int w = 1; w < GN_MAX_WARPS; ++w)
          if (w < nwarps) acc = acc + r[w];
        sh->sums[lane] = acc;
      }
      __syncwarp();
      GN_STAMP(t4);
      GNControl ctl = sh->ctl;
      if (PLANAR) {
        gn_update_se2(sh->sums, g, sh->pose, &ctl, lane);
      } else {
        gn_update(sh->sums, g, sh->pose, &ctl, lane);
      }
      if (lane == 0) sh->ctl = ctl;
      GN_STAMP(t5);
    }
    __syncthreads();
    GN_STAMP(t6);
    GN_PHASE(0, t0, t1);
    GN_PHASE(1, t1, t2);
    GN_PHASE(2, t2, t3);
    GN_PHASE(3, t3, t4);
    GN_PHASE(4, t4, t5);
    GN_PHASE(5, t5, t6);
    GN_PHASE(6, 0, 1);
  }
}

// The GN loop of the standalone solve (picp_solve.cu, K6), whose lanes may
// span a cluster of up to GN_MAX_RANKS CTAs (K6: of up to 256 threads each,
// up to 64 warps, more than red holds). Its sum has two levels, each in one
// fixed order: warp 0 of every CTA folds its own CTA's warp partials in warp
// order (lane q: term q) and stores that CTA partial into every rank's
// rank_red (distributed shared memory); after the cluster barrier every CTA
// folds the CTAs' partials in rank order and solves, so each ends the round
// with the same pose bits. On one CTA (cluster == 1) the CTA partial is the
// sum, the order of gn_solve on one CTA. A round costs three barriers on a
// cluster: the CTA's before its fold, the cluster's, and the CTA's after the
// solve. rank_red holds 2 x GN_MAX_RANKS x NRED floats, by round parity: a
// CTA may store round r + 1's partial while another still folds round r's,
// never round r + 2's before that one has passed round r + 1's barrier. The
// caller calls it after a barrier (the cluster's, on a cluster) that follows
// gn_init; lane_terms is gn_solve's.
template <bool PLANAR, typename LaneTerms>
__device__ __forceinline__ void gn_solve_ranked(GNShared* sh, float* rank_red, const GNParams& g,
                                                int num_iterations, int min_iterations,
                                                LaneTerms lane_terms, int cluster) {
  constexpr int NRED = PLANAR ? GN_NRED_SE2 : GN_NRED_SE3;
  constexpr int NPAD = PLANAR ? 16 : 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpc = blockDim.x >> 5;
  const int rank = cluster > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  while (true) {
    const int it = sh->ctl.it;
    if (!(it < num_iterations && (sh->ctl.active > 0.5f || it < min_iterations))) break;
    float part[NPAD];
    lane_terms(sh->pose, part);
#pragma unroll
    for (int q = NRED; q < NPAD; ++q) part[q] = 0.0f;
    const float v = warp_sum_terms<NPAD>(part);
    if (lane < NRED) sh->red[warp * NRED + lane] = v;
    __syncthreads();
    float* rr = rank_red + (it & 1) * (GN_MAX_RANKS * NRED);
    if (warp == 0 && lane < NRED) {
      float r[GN_MAX_WARPS];
#pragma unroll
      for (int w = 0; w < GN_MAX_WARPS; ++w) r[w] = w < wpc ? sh->red[w * NRED + lane] : 0.0f;
      float acc = r[0];
#pragma unroll
      for (int w = 1; w < GN_MAX_WARPS; ++w)
        if (w < wpc) acc = acc + r[w];
      if (cluster > 1) {
        for (int q = 0; q < cluster; ++q)
          cg::this_cluster().map_shared_rank(rr, q)[rank * NRED + lane] = acc;
      } else {
        sh->sums[lane] = acc;
      }
    }
    if (cluster > 1) {
      cg::this_cluster().sync();
      if (warp == 0 && lane < NRED) {
        float r[GN_MAX_RANKS];
#pragma unroll
        for (int q = 0; q < GN_MAX_RANKS; ++q) r[q] = q < cluster ? rr[q * NRED + lane] : 0.0f;
        float acc = r[0];
#pragma unroll
        for (int q = 1; q < GN_MAX_RANKS; ++q)
          if (q < cluster) acc = acc + r[q];
        sh->sums[lane] = acc;
      }
    }
    if (warp == 0) {
      __syncwarp();
      GNControl ctl = sh->ctl;
      if (PLANAR) {
        gn_update_se2(sh->sums, g, sh->pose, &ctl, lane);
      } else {
        gn_update(sh->sums, g, sh->pose, &ctl, lane);
      }
      if (lane == 0) sh->ctl = ctl;
    }
    __syncthreads();
  }
}
