"""Bundle adjustment on a sparse (COO) observation graph
(port of visual_odometry_tpu.parallel.sparse_ba).

The dense form (``parallel/bundle_adjustment``) holds an (F, L) observation
grid and an (F, L, 6, 3) coupling tensor; at 512 poses x 1e5..1e6 landmarks
that is terabytes. This module solves the same robust reprojection problem on
a flat per-observation layout

    obs n = (frame_idx[n], lm_idx[n], uv[n])   -- memory O(N), not O(F*L)

with a Levenberg-Marquardt Gauss-Newton step whose reduced (Schur) pose system
is solved by matrix-free preconditioned conjugate gradients:

  * residuals, Jacobian rows and robust weights are elementwise over (N,)
    (the arithmetic of the dense path and of picp_solver.cpp:25-53);
  * H_pp (F, 6, 6), b_p, H_ll (L, 3, 3) and b_l are segment sums; each
    observation is one coupling block W_n = w j_pose^T (x) j_lm (6, 3), never
    materialized per (f, l);
  * the reduced operator S v = (H_pp + lambda I) v - W Hll^-1 W^T v is applied
    in O(N): gather v at frame_idx, per-observation (3,) products, segment sum
    over lm_idx, Hll^-1, per-observation (6,) products, segment sum over
    frame_idx;
  * CG is preconditioned with the exact block diagonal of S, inverted per 6x6
    block by a Jacobi-scaled 3x3-block Schur inverse;
  * landmarks back-substitute locally: dx_l = -Hll^-1 (b_l + W^T dx_p).

Gauge: pose 0 is clamped by projecting its 6 coordinates out of the CG space.
Pose updates use the tracking Euler chart ``X <- v2tEuler(dx) X``.

Kernels. For CUDA tensors every frame-space gather and sum goes through K10
(``ops/kernels/gather_kernel.take_table``) and K9
(``ops/kernels/segsum_kernel.segment_sum_small``): the 12 pose rows of every
observation (one K10 launch of 12 rows where the JAX code needs two of
8 + 4), H_pp, b_p, the preconditioner's diagonal correction, and in every CG
matvec one K10 and one K9. The choice is by the tensors' device alone. K10
reads the (F, R) table in place through its strides and writes the layout
its consumer reads ((12, N) for the pose rows, (N, 6) in the CG), so no
transposing copy sits beside it. K9 sums each frame's observations in one
fixed order over a plan of the frame ids (``segsum_kernel.plan_segments``),
made once per step, or once per run by :func:`refine_sparse`, since the ids
do not change: its sums are the same bits in every launch and on the CPU.
Both take any number of poses, as the JAX package does (it gives way to a
plain scatter past 1,024 poses; the port never runs a plain version on the
card). For CPU tensors, plain indexing and K9's plain version; the
landmark-side sums of the unpacked layout are ``index_add_`` on both devices.

``pack_problem`` repacks the observations into a fixed-degree landmark-major
layout, in which the landmark-side sums and gathers become a reshape-reduce
and a broadcast. The JAX package packs because scatters are slow on a TPU; it
is ported because ``refine_sparse(pack=True)`` is the JAX default and the
layout changes the order of the landmark-side sums. On this card neither
layout is assumed to be the faster one.

The CG loop's exit test reads the residual on the host once an iteration. A
step's three parts (system build, pose CG, back-substitution) sit in
``utils.profiling.stage`` blocks, as the pipeline's steps do.

Landmark sharding (``make_sharded_sparse_ba_step``): the landmarks are split
into equal blocks over the ``lm`` axis of a mesh and every observation moves
to its landmark's rank (``partition_observations[_packed]``, on the host).
Each rank runs the step on its block with ``psum_axis``: the pose-space sums
(H_pp, b_p, the preconditioner's diagonal correction, chi and the count, the
reduced right-hand side and every CG matvec's coupling term) are summed over
the axis, so the CG runs replicated on (F, 6) vectors, and its exit test is
taken through a ``pmin`` of each rank's verdict. Landmark updates stay on
their rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import se3
from ..ops.kernels import gather_kernel, segsum_kernel
from ..utils.profiling import stage
from . import mesh as mesh_mod


class SparseBAProblem(NamedTuple):
    """A bundle-adjustment instance over a flat observation list."""

    poses: torch.Tensor       # (F, 4, 4) world->camera (absolute)
    landmarks: torch.Tensor   # (L, 3) world coords
    frame_idx: torch.Tensor   # (N,) int32
    lm_idx: torch.Tensor      # (N,) int32
    uv: torch.Tensor          # (N, 2) pixel measurements
    obs_mask: torch.Tensor    # (N,) bool (padding entries False)


class SparseBAStats(NamedTuple):
    chi: torch.Tensor          # () total robust chi^2
    num_obs: torch.Tensor      # () int32 live observations
    cg_residual: torch.Tensor  # () final CG relative residual of the pose solve


def _gather_frame_rows(v: torch.Tensor, frame_idx: torch.Tensor,
                       by_row: bool = False) -> torch.Tensor:
    """(F, R) table gathered by frame id to (N, R), or to (R, N) with
    ``by_row``: K10 on the card, which reads ``v`` in place through its
    strides and writes the layout asked for; its plain version on the CPU."""
    return gather_kernel.take_table(v.T, frame_idx, backend="cuda" if v.is_cuda else "torch",
                                    transpose_out=not by_row)


def _segsum_frame_rows(vals: torch.Tensor, frame_idx: torch.Tensor, f: int,
                       plan: Optional[segsum_kernel.SegmentPlan] = None) -> torch.Tensor:
    """(N, R) rows summed into (F, R) by frame id (id >= f drops the row): K9
    on the card, its plain version on the CPU. ``plan`` is
    ``segsum_kernel.plan_segments(frame_idx, f)``."""
    return segsum_kernel.segment_sum_small(vals, frame_idx, f,
                                           backend="cuda" if vals.is_cuda else "torch", plan=plan)


def plan_frames(problem: SparseBAProblem) -> Tuple[torch.Tensor, segsum_kernel.SegmentPlan]:
    """The frame ids the frame-space sums take (masked observations set to F,
    which drops them) and K9's plan of them: fixed while the observations are."""
    f = problem.poses.shape[0]
    seg = torch.where(problem.obs_mask, problem.frame_idx, f).to(torch.int32)
    return seg, segsum_kernel.plan_segments(seg, f)


def pack_problem(problem: SparseBAProblem):
    """Host-side repack into a fixed-degree landmark-major layout.

    Returns (packed_problem, degree) with N' = L * degree observation slots,
    slot ``l * degree + r`` holding landmark l's r-th observation (padded
    slots masked). Returns (problem, None) unchanged when packing would blow
    up the observation count (a landmark observed in most frames)."""
    dev = problem.uv.device
    li = problem.lm_idx.cpu().numpy()
    fi = problem.frame_idx.cpu().numpy()
    uv = problem.uv.cpu().numpy()
    mask = problem.obs_mask.cpu().numpy().astype(bool)
    l = int(problem.landmarks.shape[0])
    counts = np.bincount(li[mask], minlength=l)
    degree = max(int(counts.max()) if counts.size else 1, 1)
    if l * degree > 4 * max(len(li), 1):
        return problem, None
    fi2 = np.zeros((l, degree), np.int32)
    uv2 = np.zeros((l, degree, 2), np.float32)
    m2 = np.zeros((l, degree), bool)
    order = np.argsort(li[mask], kind="stable")
    lm_sorted = li[mask][order]
    rank = np.arange(len(lm_sorted)) - np.searchsorted(lm_sorted, lm_sorted, side="left")
    fi2[lm_sorted, rank] = fi[mask][order]
    uv2[lm_sorted, rank] = uv[mask][order]
    m2[lm_sorted, rank] = True
    li2 = np.repeat(np.arange(l, dtype=np.int32), degree)
    packed = SparseBAProblem(
        poses=problem.poses,
        landmarks=problem.landmarks,
        frame_idx=torch.from_numpy(fi2.reshape(-1)).to(dev),
        lm_idx=torch.from_numpy(li2).to(dev),
        uv=torch.from_numpy(uv2.reshape(-1, 2)).to(dev),
        obs_mask=torch.from_numpy(m2.reshape(-1)).to(dev),
    )
    return packed, degree


def _segsum_lm(rows: torch.Tensor, lm_idx: torch.Tensor, mask: torch.Tensor, l: int,
               lm_degree) -> torch.Tensor:
    """(N, R) -> (L, R) sums by landmark: a reshape-reduce in the packed
    layout, else ``index_add_`` (rows of masked slots are zero at every call
    site, so where they land does not matter)."""
    if lm_degree is not None:
        return rows.reshape(l, lm_degree, rows.shape[-1]).sum(dim=1)
    safe = torch.where(mask, lm_idx, l).long()
    return rows.new_zeros((l + 1, rows.shape[1])).index_add_(0, safe, rows)[:l]


def _gather_lm(values: torch.Tensor, lm_idx: torch.Tensor, n: int, lm_degree) -> torch.Tensor:
    """(L, ...) per-landmark values -> (N, ...) per observation: a broadcast
    over the degree axis in the packed layout, else a gather."""
    if lm_degree is not None:
        l = values.shape[0]
        return values[:, None].expand((l, lm_degree) + values.shape[1:]).reshape(
            (n,) + values.shape[1:])
    return values[lm_idx.long()]


def _per_obs_system(camera_matrix, poses, landmarks, frame_idx, lm_idx, uv, obs_mask,
                    kernel_threshold, lm_degree=None):
    """Residuals, Jacobian rows and robust weights per observation: the
    component expansion of the dense path on (N,) lanes. Returns ex, ey,
    j_pose x/y (N, 6), j_lm x/y (N, 3), weights, chi."""
    safe_f = torch.where(obs_mask, frame_idx, 0)
    safe_l = torch.where(obs_mask, lm_idx, 0)
    f = poses.shape[0]
    tab = poses[:, :3, :4].reshape(f, 12)
    pr = _gather_frame_rows(tab, safe_f, by_row=True)    # (12, N): K10 on the card
    p = _gather_lm(landmarks, safe_l, uv.shape[0], lm_degree)  # (N, 3)
    k = camera_matrix
    wx, wy, wz = p[:, 0], p[:, 1], p[:, 2]

    def rr(i, j):
        return pr[4 * i + j]

    px = rr(0, 0) * wx + rr(0, 1) * wy + rr(0, 2) * wz + pr[3]
    py = rr(1, 0) * wx + rr(1, 1) * wy + rr(1, 2) * wz + pr[7]
    pz = rr(2, 0) * wx + rr(2, 1) * wy + rr(2, 2) * wz + pr[11]

    hx = k[0, 0] * px + k[0, 1] * py + k[0, 2] * pz
    hy = k[1, 0] * px + k[1, 1] * py + k[1, 2] * pz
    hz = k[2, 0] * px + k[2, 1] * py + k[2, 2] * pz
    iz = 1.0 / torch.where(hz == 0.0, 1.0, hz)
    u = hx * iz
    v = hy * iz
    in_front = pz > 1e-3
    ex = u - uv[:, 0]
    ey = v - uv[:, 1]

    iz2 = iz * iz
    a00 = k[0, 0] * iz - k[2, 0] * hx * iz2
    a01 = k[0, 1] * iz - k[2, 1] * hx * iz2
    a02 = k[0, 2] * iz - k[2, 2] * hx * iz2
    a10 = k[1, 0] * iz - k[2, 0] * hy * iz2
    a11 = k[1, 1] * iz - k[2, 1] * hy * iz2
    a12 = k[1, 2] * iz - k[2, 2] * hy * iz2

    jx3 = a01 * (-pz) + a02 * py
    jx4 = a00 * pz + a02 * (-px)
    jx5 = a00 * (-py) + a01 * px
    jy3 = a11 * (-pz) + a12 * py
    jy4 = a10 * pz + a12 * (-px)
    jy5 = a10 * (-py) + a11 * px
    j_pose_x = torch.stack([a00, a01, a02, jx3, jx4, jx5], -1)   # (N, 6)
    j_pose_y = torch.stack([a10, a11, a12, jy3, jy4, jy5], -1)

    j_lm_x = torch.stack(
        [a00 * rr(0, c) + a01 * rr(1, c) + a02 * rr(2, c) for c in range(3)], -1)  # (N, 3)
    j_lm_y = torch.stack(
        [a10 * rr(0, c) + a11 * rr(1, c) + a12 * rr(2, c) for c in range(3)], -1)

    chi = ex * ex + ey * ey
    lam = torch.where(chi > kernel_threshold,
                      torch.sqrt(kernel_threshold / torch.clamp_min(chi, 1e-30)), 1.0)
    w = obs_mask.to(ex.dtype) * in_front.to(ex.dtype) * lam
    return ex, ey, j_pose_x, j_pose_y, j_lm_x, j_lm_y, w, chi


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched adjugate 3x3 inverse with Jacobi pre-scaling: the raw adjugate
    overflows float32 once diagonal entries reach ~1e20, so scale to unit
    diagonal, invert, scale back."""
    d = torch.sqrt(torch.clamp_min(
        torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1), 1e-30))
    s = 1.0 / d
    ms = m * s[..., :, None] * s[..., None, :]
    a, b, c = ms[..., 0, 0], ms[..., 0, 1], ms[..., 0, 2]
    dd, e, f = ms[..., 1, 0], ms[..., 1, 1], ms[..., 1, 2]
    g, h, i = ms[..., 2, 0], ms[..., 2, 1], ms[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - dd * i
    co11 = a * i - c * g
    co12 = c * dd - a * f
    co20 = dd * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * dd
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
    inv_s = adj * inv_det[..., None, None]
    return inv_s * s[..., :, None] * s[..., None, :]


def _inv6x6(m: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD inverse via the 3x3-block Schur complement (the
    preconditioner blocks; the structure of the PICP kernels' solve)."""
    a = m[..., :3, :3]
    b = m[..., :3, 3:]
    d = m[..., 3:, 3:]
    ai = _inv3x3(a)
    bt = b.transpose(-1, -2)
    s = d - bt @ ai @ b
    si = _inv3x3(s)
    top_left = ai + ai @ b @ si @ bt @ ai
    top_right = -(ai @ b @ si)
    bottom_left = top_right.transpose(-1, -2)
    return torch.cat(
        [torch.cat([top_left, top_right], -1), torch.cat([bottom_left, si], -1)], -2)


class _ReducedSystem(NamedTuple):
    """Everything the CG solve and back-substitution need, O(N + F + L)."""

    h_pp_d: torch.Tensor      # (F, 6, 6) damped pose blocks (gauge NOT applied)
    b_p: torch.Tensor         # (F, 6)
    h_ll_inv: torch.Tensor    # (L, 3, 3) damped landmark block inverses
    b_l: torch.Tensor         # (L, 3)
    w_rows_x: torch.Tensor    # (N, 6) sqrt-weighted j_pose rows (x residual)
    w_rows_y: torch.Tensor    # (N, 6)
    l_rows_x: torch.Tensor    # (N, 3) sqrt-weighted j_lm rows
    l_rows_y: torch.Tensor    # (N, 3)
    frame_idx: torch.Tensor   # (N,) sanitized (masked -> 0), for the gathers
    lm_idx: torch.Tensor      # (N,) sanitized
    precond: torch.Tensor     # (F, 6, 6) inverse of the exact diagonal of S
    frame_seg: torch.Tensor   # (N,) int32 frame ids of the sums (masked -> F)
    frame_plan: segsum_kernel.SegmentPlan   # K9's plan of frame_seg


def _psum(x: torch.Tensor, psum_axis) -> torch.Tensor:
    """``x`` summed over ``psum_axis`` = (mesh, axis name), or ``x`` when None."""
    if psum_axis is None:
        return x
    mesh, axis = psum_axis
    return mesh_mod.psum(mesh, x, axis)


def _build_reduced(camera_matrix, problem: SparseBAProblem, damping, kernel_threshold,
                   lm_degree=None, frames=None, psum_axis=None):
    """Assemble the reduced system from the observation list. On the card:
    one K10 launch (the pose rows) and three K9 launches (H_pp, b_p, the
    preconditioner's diagonal correction). ``frames`` is
    :func:`plan_frames` of the problem, made here when None. With
    ``psum_axis`` the observations and landmarks are one rank's block and the
    pose-space sums, chi and the count are summed over the axis."""
    f = problem.poses.shape[0]
    fi, plan = plan_frames(problem) if frames is None else frames
    l = problem.landmarks.shape[0]
    ex, ey, jpx, jpy, jlx, jly, w, chi = _per_obs_system(
        camera_matrix, problem.poses, problem.landmarks, problem.frame_idx, problem.lm_idx,
        problem.uv, problem.obs_mask, kernel_threshold, lm_degree)
    sqw = torch.sqrt(w)
    sw = sqw[:, None]
    wrx, wry = jpx * sw, jpy * sw           # (N, 6)
    lrx, lry = jlx * sw, jly * sw           # (N, 3)
    rx, ry = (ex * sqw)[:, None], (ey * sqw)[:, None]

    # H_pp[f] = sum_n wrx wrx^T + wry wry^T; an (N, 36) segment sum.
    outer_p = (wrx[:, :, None] * wrx[:, None, :] + wry[:, :, None] * wry[:, None, :]
               ).reshape(-1, 36)
    h_pp = _segsum_frame_rows(outer_p, fi, f, plan).reshape(f, 6, 6)
    b_p = _segsum_frame_rows(wrx * rx + wry * ry, fi, f, plan)
    outer_l = (lrx[:, :, None] * lrx[:, None, :] + lry[:, :, None] * lry[:, None, :]
               ).reshape(-1, 9)
    h_ll = _segsum_lm(outer_l, problem.lm_idx, problem.obs_mask, l, lm_degree).reshape(l, 3, 3)
    b_l = _segsum_lm(lrx * rx + lry * ry, problem.lm_idx, problem.obs_mask, l, lm_degree)

    eye3 = torch.eye(3, dtype=h_ll.dtype, device=h_ll.device)
    h_ll_inv = _inv3x3(h_ll + damping * eye3)
    eye6 = torch.eye(6, dtype=h_pp.dtype, device=h_pp.device)

    # Exact diagonal of S: H_pp + lambda - sum_{n in f} W_n Hll^-1 W_n^T,
    # where W_n = wrx_n (x) lrx_n + wry_n (x) lry_n. O(N).
    n_obs = problem.uv.shape[0]
    safe_l = torch.where(problem.obs_mask, problem.lm_idx, 0)
    hinv_n = _gather_lm(h_ll_inv, safe_l, n_obs, lm_degree)           # (N, 3, 3)
    w_n = wrx[:, :, None] * lrx[:, None, :] + wry[:, :, None] * lry[:, None, :]   # (N, 6, 3)
    y_n = (w_n[:, :, None, :] * hinv_n[:, None, :, :]).sum(-1)        # (N, 6, 3)
    diag_corr = (y_n[:, :, None, :] * w_n[:, None, :, :]).sum(-1).reshape(-1, 36)
    diag_corr = _segsum_frame_rows(diag_corr, fi, f, plan).reshape(f, 6, 6)

    chi_sum = (chi * w).sum()
    nobs = (w > 0).sum().to(torch.int32)
    if psum_axis is not None:
        sizes = (f * 36, f * 6, f * 36, 1)
        summed = _psum(torch.cat([h_pp.reshape(-1), b_p.reshape(-1), diag_corr.reshape(-1),
                                  chi_sum.reshape(1)]), psum_axis).split(sizes)
        h_pp, b_p = summed[0].reshape(f, 6, 6), summed[1].reshape(f, 6)
        diag_corr, chi_sum = summed[2].reshape(f, 6, 6), summed[3][0]
        nobs = _psum(nobs, psum_axis)

    h_pp_d = h_pp + damping * eye6
    s_diag = h_pp_d - diag_corr
    # Gauge: pose 0's preconditioner block is the identity (its CG
    # coordinates are projected out anyway).
    s_diag = torch.cat([eye6[None], s_diag[1:]], dim=0)
    precond = _inv6x6(s_diag)

    system = _ReducedSystem(
        h_pp_d=h_pp_d, b_p=b_p, h_ll_inv=h_ll_inv, b_l=b_l,
        w_rows_x=wrx, w_rows_y=wry, l_rows_x=lrx, l_rows_y=lry,
        frame_idx=torch.where(problem.obs_mask, problem.frame_idx, 0),
        lm_idx=safe_l, precond=precond, frame_seg=fi, frame_plan=plan,
    )
    mask_f = problem.obs_mask.to(ex.dtype)
    return system, mask_f, chi_sum, nobs


def _coupling_rows(system: _ReducedSystem, mask_f: torch.Tensor, m_l: torch.Tensor,
                   lm_degree) -> torch.Tensor:
    """y_n = W_n m_l[lm(n)] = wrx (lrx . m) + wry (lry . m), (N, 6)."""
    mn = _gather_lm(m_l, system.lm_idx, system.w_rows_x.shape[0], lm_degree)   # (N, 3)
    cx = (system.l_rows_x * mn).sum(dim=1) * mask_f
    cy = (system.l_rows_y * mn).sum(dim=1) * mask_f
    return system.w_rows_x * cx[:, None] + system.w_rows_y * cy[:, None]


def _coupling_transpose(system: _ReducedSystem, mask_f: torch.Tensor, v: torch.Tensor,
                        num_lm: int, lm_degree) -> torch.Tensor:
    """W^T v summed per landmark, (L, 3): u_n = lrx (wrx . v_f) + lry (wry . v_f).
    One K10 launch on the card."""
    vf = _gather_frame_rows(v, system.frame_idx)                 # (N, 6)
    dx_ = (system.w_rows_x * vf).sum(dim=1) * mask_f
    dy_ = (system.w_rows_y * vf).sum(dim=1) * mask_f
    u = system.l_rows_x * dx_[:, None] + system.l_rows_y * dy_[:, None]    # (N, 3)
    return _segsum_lm(u, system.lm_idx, mask_f > 0, num_lm, lm_degree)


def _coupling_apply(system: _ReducedSystem, mask_f: torch.Tensor, v: torch.Tensor, num_lm: int,
                    psum_axis=None, lm_degree=None) -> torch.Tensor:
    """(W Hll^-1 W^T) v for v (F, 6), matrix-free in O(N). On the card: one
    K10 launch (v at the observations) and one K9 launch (the sum back).
    With ``psum_axis`` each rank holds a disjoint set of landmarks and their
    observations, so the ranks' products sum to the global one."""
    s_l = _coupling_transpose(system, mask_f, v, num_lm, lm_degree)        # (L, 3)
    m_l = (system.h_ll_inv * s_l[:, None, :]).sum(-1)                      # (L, 3)
    y = _coupling_rows(system, mask_f, m_l, lm_degree)                     # (N, 6)
    return _psum(_segsum_frame_rows(y, system.frame_seg, system.h_pp_d.shape[0],
                                    system.frame_plan), psum_axis)


def _gauge(v: torch.Tensor) -> torch.Tensor:
    """Project pose 0's coordinates out (dx_0 = 0 gauge clamp)."""
    return torch.cat([torch.zeros_like(v[:1]), v[1:]], dim=0)


def _solve_pose_cg(system: _ReducedSystem, mask_f: torch.Tensor, num_lm: int, cg_iterations: int,
                   cg_tolerance: float, psum_axis=None,
                   lm_degree=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preconditioned CG on S dx = -b_reduced over (F, 6) vectors. On the
    card: one K9 launch for the reduced right-hand side, then one K10 and one
    K9 launch an iteration. With ``psum_axis`` the vectors are replicated and
    the loop runs while every rank's test says go on (a ``pmin``)."""

    def s_apply(v):
        v = _gauge(v)
        hv = (system.h_pp_d * v[:, None, :]).sum(-1)
        return _gauge(hv - _coupling_apply(system, mask_f, v, num_lm, psum_axis, lm_degree))

    def m_apply(v):
        return _gauge((system.precond * v[:, None, :]).sum(-1))

    # rhs = -(b_p - W Hll^-1 b_l): b_l folded through the coupling path once.
    m_l = (system.h_ll_inv * system.b_l[:, None, :]).sum(-1)
    b_red = _psum(_segsum_frame_rows(_coupling_rows(system, mask_f, m_l, lm_degree),
                                     system.frame_seg, system.b_p.shape[0], system.frame_plan),
                  psum_axis)
    rhs = _gauge(-(system.b_p - b_red))

    rhs_norm = torch.clamp_min((rhs * rhs).sum(), 1e-30)
    x = torch.zeros_like(rhs)
    r = rhs
    z = m_apply(r)
    p = z
    rz = (r * z).sum()
    tol2 = torch.as_tensor(cg_tolerance, dtype=rhs.dtype) ** 2
    it = 0

    def go_on(r, rz):
        # rz <= 0 or non-finite: the float32 system lost positive-definiteness
        # (degenerate geometry) — stop with the best iterate instead of diverging.
        ok = ((r * r).sum() > tol2 * rhs_norm) & (rz > 0.0) & torch.isfinite(rz)
        if psum_axis is not None:
            mesh, axis = psum_axis
            ok = mesh_mod.pmin(mesh, ok.to(torch.int32), axis) > 0
        return bool(ok)

    while it < cg_iterations and go_on(r, rz):
        sp = s_apply(p)
        denom = (p * sp).sum()
        alpha = torch.where(denom > 0.0, rz / torch.where(denom == 0.0, 1.0, denom), 0.0)
        x = x + alpha * p
        r = r - alpha * sp
        z = m_apply(r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz == 0.0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, torch.sqrt((r * r).sum() / rhs_norm)


def sparse_ba_step(
    camera_matrix: torch.Tensor,
    problem: SparseBAProblem,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    cg_iterations: int = 64,
    cg_tolerance: float = 1e-6,
    psum_axis=None,
    lm_degree: Optional[int] = None,
    frames: Optional[Tuple[torch.Tensor, segsum_kernel.SegmentPlan]] = None,
) -> Tuple[SparseBAProblem, SparseBAStats]:
    """One LM/GN step on the tensors' device. Memory O(N + F + L); no (F, L)
    densification. ``lm_degree`` is :func:`pack_problem`'s degree for a packed
    problem; ``frames`` is :func:`plan_frames` of the problem (made here when
    None). With ``i`` CG iterations run, a step on the card launches K10
    ``2 + i`` times and K9 ``4 + i`` times.

    ``psum_axis`` = (mesh, axis name) makes this the rank-local body of
    :func:`make_sharded_sparse_ba_step`: the problem's landmarks and
    observations are this rank's block, the pose-space sums are summed over
    the axis."""
    l = problem.landmarks.shape[0]
    with stage("ba_build_reduced"):
        system, mask_f, chi_sum, nobs = _build_reduced(
            camera_matrix, problem, damping, kernel_threshold, lm_degree, frames, psum_axis)
    with stage("ba_pose_cg"):
        dx_p, cg_rel = _solve_pose_cg(system, mask_f, l, cg_iterations, cg_tolerance, psum_axis,
                                      lm_degree)
    with stage("ba_back_substitute"):
        # Back-substitute landmarks: dx_l = -Hll^-1 (b_l + W^T dx_p), O(N).
        wt_dx = _coupling_transpose(system, mask_f, dx_p, l, lm_degree)
        dx_l = -(system.h_ll_inv * (system.b_l + wt_dx)[:, None, :]).sum(-1)
        new_poses = se3.v2t_euler(dx_p) @ problem.poses
        new_landmarks = problem.landmarks + dx_l
    stats = SparseBAStats(chi=chi_sum, num_obs=nobs, cg_residual=cg_rel)
    return problem._replace(poses=new_poses, landmarks=new_landmarks), stats


def refine_sparse(
    camera_matrix: torch.Tensor,
    problem: SparseBAProblem,
    num_iterations: int = 10,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    cg_iterations: int = 64,
    cg_tolerance: float = 1e-6,
    pack: bool = True,
) -> Tuple[SparseBAProblem, SparseBAStats]:
    """Iterative refinement: ``num_iterations`` steps of :func:`sparse_ba_step`.

    ``pack=True`` (the JAX default) repacks the observations into the
    fixed-degree landmark-major layout first (:func:`pack_problem`); the
    returned problem keeps the caller's observation layout with the refined
    poses and landmarks swapped in. The frame ids' plan is made once for all
    steps."""
    work, degree = pack_problem(problem) if pack else (problem, None)
    frames = plan_frames(work)
    dev = problem.uv.device
    stats = SparseBAStats(chi=torch.zeros((), device=dev),
                          num_obs=torch.zeros((), dtype=torch.int32, device=dev),
                          cg_residual=torch.zeros((), device=dev))
    for _ in range(num_iterations):
        work, stats = sparse_ba_step(
            camera_matrix, work, damping=damping, kernel_threshold=kernel_threshold,
            cg_iterations=int(cg_iterations), cg_tolerance=cg_tolerance, lm_degree=degree,
            frames=frames)
    return problem._replace(poses=work.poses, landmarks=work.landmarks), stats


# --------------------------------------------------------------------------
# Distribution over the lm axis of a mesh
# --------------------------------------------------------------------------


def partition_observations(
    n_shards: int,
    num_landmarks: int,
    frame_idx: np.ndarray,
    lm_idx: np.ndarray,
    uv: np.ndarray,
    obs_mask: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side shard layout: landmarks block-partition over ``n_shards``;
    each observation moves to its landmark's shard with the landmark index
    rebased to shard-local coordinates. Shards pad to a common count.

    Returns (frame_idx, local_lm_idx, uv, mask) in shard-major order (reshape
    to (n_shards, cap, ...); shard s is rank s of the ``lm`` axis), plus the
    per-shard landmark count."""
    live = obs_mask.astype(bool)
    l_per = -(-num_landmarks // n_shards)
    shard_of = lm_idx // l_per
    counts = [int(np.sum(live & (shard_of == s))) for s in range(n_shards)]
    cap = max(max(counts), 1)
    fi = np.zeros((n_shards, cap), np.int32)
    li = np.zeros((n_shards, cap), np.int32)
    uvs = np.zeros((n_shards, cap, 2), np.float32)
    msk = np.zeros((n_shards, cap), bool)
    for s in range(n_shards):
        sel = live & (shard_of == s)
        n = int(np.sum(sel))
        fi[s, :n] = frame_idx[sel]
        li[s, :n] = lm_idx[sel] - s * l_per
        uvs[s, :n] = uv[sel]
        msk[s, :n] = True
    return fi.reshape(-1), li.reshape(-1), uvs.reshape(-1, 2), msk.reshape(-1), l_per


def partition_observations_packed(
    n_shards: int,
    num_landmarks: int,
    frame_idx: np.ndarray,
    lm_idx: np.ndarray,
    uv: np.ndarray,
    obs_mask: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Shard layout and fixed-degree landmark-major packing in one host pass,
    the sharded twin of :func:`pack_problem`: landmarks block-partition over
    ``n_shards`` (l_per a shard) and each shard's observations land in slots
    ``local_lm * degree + rank`` with one global degree (the largest
    per-landmark observation count). Returns (frame_idx, local_lm_idx, uv,
    mask) in shard-major order plus (l_per, degree); ``degree`` is
    :func:`make_sharded_sparse_ba_step`'s ``lm_degree``."""
    live = obs_mask.astype(bool)
    l_per = -(-num_landmarks // n_shards)
    counts = np.bincount(lm_idx[live], minlength=num_landmarks)
    degree = max(int(counts.max()) if counts.size else 1, 1)
    cap = l_per * degree
    fi = np.zeros((n_shards, cap), np.int32)
    li = np.tile(np.repeat(np.arange(l_per, dtype=np.int32), degree)[None], (n_shards, 1))
    uvs = np.zeros((n_shards, cap, 2), np.float32)
    msk = np.zeros((n_shards, cap), bool)
    order = np.argsort(lm_idx[live], kind="stable")
    lm_sorted = lm_idx[live][order]
    rank = np.arange(len(lm_sorted)) - np.searchsorted(lm_sorted, lm_sorted, side="left")
    shard = lm_sorted // l_per
    slot = (lm_sorted - shard * l_per) * degree + rank
    fi[shard, slot] = frame_idx[live][order]
    uvs[shard, slot] = uv[live][order]
    msk[shard, slot] = True
    return fi.reshape(-1), li.reshape(-1), uvs.reshape(-1, 2), msk.reshape(-1), l_per, degree


def make_sharded_sparse_ba_step(
    mesh: mesh_mod.Mesh,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    cg_iterations: int = 64,
    cg_tolerance: float = 1e-6,
    lm_axis: str = "lm",
    lm_degree=None,
):
    """The landmark-sharded sparse BA step over ``mesh``'s ``lm_axis``:
    ``step(camera_matrix, problem, frames=None) -> (problem, stats)``, called
    by every rank.

    ``problem`` holds the whole poses and this rank's blocks: landmarks
    (l_per, 3) and the observation arrays of its shard of
    :func:`partition_observations` (shard-local landmark indices) or, with
    ``lm_degree``, of :func:`partition_observations_packed`. The returned
    poses and stats are whole and alike on every rank; the landmarks stay
    this rank's block. ``frames`` is :func:`plan_frames` of the rank's block,
    made once a run by the caller (made each step when None).

    Collectives a step: the (F, 6, 6) + (F, 6) + (F, 6, 6) sums and the count
    at assembly, the reduced right-hand side, and per CG iteration one (F, 6)
    sum and the exit test's ``pmin``."""

    def step(camera_matrix, problem: SparseBAProblem, frames=None):
        return sparse_ba_step(
            camera_matrix, problem, damping=damping, kernel_threshold=kernel_threshold,
            cg_iterations=cg_iterations, cg_tolerance=cg_tolerance, psum_axis=(mesh, lm_axis),
            lm_degree=lm_degree, frames=frames)

    return step
