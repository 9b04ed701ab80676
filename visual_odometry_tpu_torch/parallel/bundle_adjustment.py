"""Dense bundle adjustment via the landmark Schur complement
(port of visual_odometry_tpu.parallel.bundle_adjustment).

Problem: minimize the robust reprojection error
    sum_{f,l} rho( || pi(K, X_f, p_l) - z_{f,l} ||^2 )
over camera poses X_f (world->camera) and landmark positions p_l, with a dense
masked observation grid z (F, L, 2).

One Levenberg-Marquardt-damped Gauss-Newton step:
  * per-observation Jacobians: J_pose (2, 6) as in the PICP solver
    (picp_solver.cpp:37-52: Jp K [I | -skew(p_cam)]) and J_lm = Jp K R_f;
  * landmark blocks H_ll (L, 3, 3), coupling blocks W (F, L, 6, 3) and the
    pose blocks are accumulated over the grid;
  * the reduced pose system
        S  = H_pp + lambda I - sum_l W_l Hll_l^-1 W_l^T     (6F, 6F)
        b~ = b_p - sum_l W_l Hll_l^-1 b_l
    is solved by one dense Cholesky factorization (F is small; the landmark
    count is the axis that scales);
  * landmarks back-substitute: dx_l = -Hll_l^-1 (b_l + W_l^T dx_p).

Gauge: pose 0 is held fixed (its 6x6 block in S replaced by the identity, its
residual zeroed); the monocular scale gauge is left to the LM damping of the
landmark blocks. Pose updates use the tracking Euler chart
``X <- v2tEuler(dx) X`` (utils.h:73-78).

No kernel of the JAX package runs here: the contractions and the (6F, 6F)
solve are plain matrix products and ``torch.linalg`` calls, as the JAX
package leaves them to XLA. Memory is O(F * L): use ``parallel/sparse_ba``
past a few thousand landmarks. Not ported here: ``make_sharded_ba_step`` (the
landmark-sharded multi-device step).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import se3


class BAProblem(NamedTuple):
    """A bundle-adjustment instance (one sequence)."""

    poses: torch.Tensor          # (F, 4, 4) world->camera
    landmarks: torch.Tensor      # (L, 3) world coords
    observations: torch.Tensor   # (F, L, 2) pixel measurements
    obs_mask: torch.Tensor       # (F, L) bool


class BAStats(NamedTuple):
    chi: torch.Tensor            # () total robust chi^2
    num_obs: torch.Tensor        # () int32 live observations


def _residuals_and_jacobians(camera_matrix, poses, landmarks, observations, obs_mask,
                             kernel_threshold):
    """All per-observation quantities over the full (F, L) grid, as explicit
    broadcast arithmetic (the component expansion of the PICP kernels).
    Returns ex, ey, j_pose x/y (F, L, 6), j_lm x/y (F, L, 3), weights, chi."""
    r = poses[:, :3, :3]                       # (F, 3, 3)
    t = poses[:, :3, 3]                        # (F, 3)
    k = camera_matrix
    wx, wy, wz = landmarks[:, 0], landmarks[:, 1], landmarks[:, 2]  # (L,)

    def rr(i, j):  # (F, 1) pose scalars broadcast against (L,)
        return r[:, i, j][:, None]

    px = rr(0, 0) * wx + rr(0, 1) * wy + rr(0, 2) * wz + t[:, 0][:, None]   # (F, L)
    py = rr(1, 0) * wx + rr(1, 1) * wy + rr(1, 2) * wz + t[:, 1][:, None]
    pz = rr(2, 0) * wx + rr(2, 1) * wy + rr(2, 2) * wz + t[:, 2][:, None]

    hx = k[0, 0] * px + k[0, 1] * py + k[0, 2] * pz
    hy = k[1, 0] * px + k[1, 1] * py + k[1, 2] * pz
    hz = k[2, 0] * px + k[2, 1] * py + k[2, 2] * pz

    iz = 1.0 / torch.where(hz == 0.0, 1.0, hz)
    u = hx * iz
    v = hy * iz
    in_front = pz > 1e-3
    ex = u - observations[..., 0]
    ey = v - observations[..., 1]

    # A = Jp K (2, 3) per observation, expanded by component.
    iz2 = iz * iz
    a00 = k[0, 0] * iz - k[2, 0] * hx * iz2
    a01 = k[0, 1] * iz - k[2, 1] * hx * iz2
    a02 = k[0, 2] * iz - k[2, 2] * hx * iz2
    a10 = k[1, 0] * iz - k[2, 0] * hy * iz2
    a11 = k[1, 1] * iz - k[2, 1] * hy * iz2
    a12 = k[1, 2] * iz - k[2, 2] * hy * iz2

    # J_pose = [A | A skew(-p_cam)]; skew(-p) = [[0, pz, -py], [-pz, 0, px], [py, -px, 0]].
    jx3 = a01 * (-pz) + a02 * py
    jx4 = a00 * pz + a02 * (-px)
    jx5 = a00 * (-py) + a01 * px
    jy3 = a11 * (-pz) + a12 * py
    jy4 = a10 * pz + a12 * (-px)
    jy5 = a10 * (-py) + a11 * px
    j_pose_x = torch.stack([a00, a01, a02, jx3, jx4, jx5], -1)   # (F, L, 6)
    j_pose_y = torch.stack([a10, a11, a12, jy3, jy4, jy5], -1)

    # J_lm = A R_f (2, 3).
    j_lm_x = torch.stack(
        [a00 * rr(0, c) + a01 * rr(1, c) + a02 * rr(2, c) for c in range(3)], -1)   # (F, L, 3)
    j_lm_y = torch.stack(
        [a10 * rr(0, c) + a11 * rr(1, c) + a12 * rr(2, c) for c in range(3)], -1)

    chi = ex * ex + ey * ey                      # (F, L)
    lam = torch.where(chi > kernel_threshold,
                      torch.sqrt(kernel_threshold / torch.clamp_min(chi, 1e-30)), 1.0)
    w = obs_mask.to(ex.dtype) * in_front.to(ex.dtype) * lam
    return ex, ey, j_pose_x, j_pose_y, j_lm_x, j_lm_y, w, chi


def _assemble(camera_matrix, poses, landmarks, observations, obs_mask, kernel_threshold):
    ex, ey, jpx, jpy, jlx, jly, w, chi = _residuals_and_jacobians(
        camera_matrix, poses, landmarks, observations, obs_mask, kernel_threshold)
    ww = w[..., None]
    # H_pp[f] = sum_l w (jx^T jx + jy^T jy): batched (6, L) x (L, 6) products.
    h_pp = (torch.einsum("flj,fli->fij", jpx, jpx * ww)
            + torch.einsum("flj,fli->fij", jpy, jpy * ww))               # (F, 6, 6)
    b_p = torch.einsum("fli,fl->fi", jpx, ex * w) + torch.einsum("fli,fl->fi", jpy, ey * w)
    # H_ll[l] = sum_f w (kx^T kx + ky^T ky): batched (3, F) x (F, 3) over L.
    h_ll = (torch.einsum("flj,fli->lij", jlx, jlx * ww)
            + torch.einsum("flj,fli->lij", jly, jly * ww))               # (L, 3, 3)
    b_l = torch.einsum("fli,fl->li", jlx, ex * w) + torch.einsum("fli,fl->li", jly, ey * w)
    # W[f, l] = w (jx^T (x) kx + jy^T (x) ky): broadcast outer products.
    w_pl = ((jpx * ww)[..., :, None] * jlx[..., None, :]
            + (jpy * ww)[..., :, None] * jly[..., None, :])              # (F, L, 6, 3)
    stats = BAStats(chi=(chi * w).sum(), num_obs=(w > 0).sum().to(torch.int32))
    return h_pp, b_p, h_ll, b_l, w_pl, stats


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1.0, det)
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], -1),
            torch.stack([co10, co11, co12], -1),
            torch.stack([co20, co21, co22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def _schur_contributions(h_ll, b_l, w_pl, damping):
    """The landmark side of the reduced pose system: the inverse landmark
    blocks, the reduced coupling as one (6F, 6F) matrix (a single matrix
    product over the 3L contraction axis) and the reduced right-hand side."""
    f = w_pl.shape[0]
    l = h_ll.shape[0]
    h_ll_d = h_ll + damping * torch.eye(3, dtype=h_ll.dtype, device=h_ll.device)
    h_ll_inv = _inv3x3(h_ll_d)                               # (L, 3, 3)
    # Y[f, l] = W[f, l] Hll_l^-1 (F, L, 6, 3).
    y = (w_pl[..., :, :, None] * h_ll_inv[None, :, None, :, :]).sum(dim=-2)
    ym = y.permute(0, 2, 1, 3).reshape(6 * f, 3 * l)
    wm = w_pl.permute(0, 2, 1, 3).reshape(6 * f, 3 * l)
    s_red = ym @ wm.T
    b_red = torch.einsum("flik,lk->fi", y, b_l)              # (F, 6)
    return h_ll_inv, s_red, b_red


def _solve_pose_system(h_pp, b_p, s_red, b_red, damping, fix_first: bool = True):
    f = h_pp.shape[0]
    dev = h_pp.device
    big4 = (-s_red).reshape(f, 6, f, 6).clone()
    idx = torch.arange(f, device=dev)
    big4[idx, :, idx, :] += h_pp + damping * torch.eye(6, dtype=h_pp.dtype, device=dev)
    big = big4.reshape(6 * f, 6 * f)
    rhs = (b_p - b_red).reshape(6 * f)
    if fix_first:
        # Gauge: clamp pose 0 (dx_0 = 0).
        mask = torch.arange(6 * f, device=dev) >= 6
        big = torch.where(mask[:, None] & mask[None, :], big, 0.0)
        big = big + torch.diag((~mask).to(big.dtype))
        rhs = torch.where(mask, rhs, 0.0)
    # A factorization that fails (the system lost positive-definiteness)
    # gives NaN, as the JAX package's cho_solve does, instead of raising.
    chol, info = torch.linalg.cholesky_ex(big)
    dx = torch.cholesky_solve(-rhs[:, None], chol)[:, 0]
    dx = torch.where(info == 0, dx, float("nan"))
    return dx.reshape(f, 6)


def ba_step(
    camera_matrix: torch.Tensor,
    problem: BAProblem,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    fix_first: bool = True,
) -> Tuple[BAProblem, BAStats]:
    """One LM/GN step on the tensors' device."""
    h_pp, b_p, h_ll, b_l, w_pl, stats = _assemble(
        camera_matrix, problem.poses, problem.landmarks, problem.observations, problem.obs_mask,
        kernel_threshold)
    h_ll_inv, s_red, b_red = _schur_contributions(h_ll, b_l, w_pl, damping)
    dx_p = _solve_pose_system(h_pp, b_p, s_red, b_red, damping, fix_first)
    # Back-substitute landmarks: dx_l = -Hll^-1 (b_l + W^T dx_p).
    wt_dx = torch.einsum("flij,fi->lj", w_pl, dx_p)
    dx_l = -torch.einsum("lij,lj->li", h_ll_inv, b_l + wt_dx)

    new_poses = se3.v2t_euler(dx_p) @ problem.poses
    new_landmarks = problem.landmarks + dx_l
    return problem._replace(poses=new_poses, landmarks=new_landmarks), stats


def refine(
    camera_matrix: torch.Tensor,
    problem: BAProblem,
    num_iterations: int = 10,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
) -> Tuple[BAProblem, BAStats]:
    """Iterative refinement: ``num_iterations`` steps of :func:`ba_step`."""
    dev = problem.poses.device
    stats = BAStats(chi=torch.zeros((), device=dev),
                    num_obs=torch.zeros((), dtype=torch.int32, device=dev))
    for _ in range(num_iterations):
        problem, stats = ba_step(camera_matrix, problem, damping, kernel_threshold)
    return problem, stats
