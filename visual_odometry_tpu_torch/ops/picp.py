"""Projective ICP (pose from 2D-3D matches) as a batched Gauss-Newton solver
(port of visual_odometry_tpu.ops.picp).

The reference's ``PICPSolver`` (picp_solver.h, picp_solver.cpp) linearizes
with a scalar loop over correspondences and runs ``oneRound`` from a host
loop. Here the per-correspondence error and Jacobian are computed for all
correspondences at once, H and b are one contraction, and invalid,
out-of-frustum and outlier points are handled by weights.

Semantics kept exactly:
  * robust kernel: chi > threshold => weight sqrt(thr/chi), outlier
    (picp_solver.cpp:75-88); outliers contribute only with ``keep_outliers``;
  * damping added to H's diagonal every round (picp_solver.cpp:102);
  * update on the Euler chart, left-multiplied ``X <- v2tEuler(dx) X``
    (picp_solver.cpp:110);
  * a round with fewer inliers than ``min_num_inliers`` leaves the pose
    (picp_solver.cpp:103-107).

``solve`` routes by ``backend``: the whole loop as one CUDA launch (kernel K6,
``ops/kernels/picp_kernel.solve_fused``) for a CUDA tensor under ``auto``, or
the plain round-by-round loop below (``torch``). The two are different
arithmetic for the same system — the kernel solves a Jacobi-scaled Schur
form, the loop a 6x6 Cholesky — and agree to float32 tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import linalg6, se3
from .camera import Camera, project_points
from ..utils import roofline
from .kernels import _lib


class PICPStats(NamedTuple):
    """Statistics of the last GN round (picp_solver.h:44-50)."""

    chi_inliers: torch.Tensor   # () float32
    chi_outliers: torch.Tensor  # () float32
    num_inliers: torch.Tensor   # () int32


def with_pose(camera: Camera, world_in_camera: torch.Tensor) -> Camera:
    return camera._replace(world_in_camera=world_in_camera)


def projection_terms(camera: Camera, world_points, measured_points, weights, kernel_threshold,
                     keep_outliers: bool):
    """What the SE(3) and planar linearizations share: the error (N, 2), the
    camera-frame points (N, 3), ``Jp K`` (N, 2, 3), the robust weights (N,)
    and the round's stats."""
    predicted, in_frustum = project_points(camera, world_points)
    error = predicted - measured_points
    p_cam = se3.transform_points(camera.world_in_camera, world_points)

    # Jacobian of the projection (picp_solver.cpp:43-49).
    p_hom = p_cam @ camera.camera_matrix.T
    hz = p_hom[..., 2]
    iz = 1.0 / torch.where(hz == 0.0, torch.ones_like(hz), hz)
    iz2 = iz * iz
    # Minimum-depth guard: with z_near == 0 a point essentially at the pinhole
    # passes the frustum test but its 1/z^2 terms overflow float32 and poison
    # H. A micrometre of depth is far below any legitimate scene.
    near_ok = hz > 1e-6
    zero = torch.zeros_like(iz)
    jp = torch.stack(
        [
            torch.stack([iz, zero, -p_hom[..., 0] * iz2], -1),
            torch.stack([zero, iz, -p_hom[..., 1] * iz2], -1),
        ],
        -2,
    )  # (N, 2, 3)

    chi = (error * error).sum(-1)
    is_outlier = chi > kernel_threshold
    lam = torch.where(is_outlier, torch.sqrt(kernel_threshold / torch.clamp_min(chi, 1e-30)),
                      torch.ones_like(chi))
    live = weights * in_frustum.to(weights.dtype) * near_ok.to(weights.dtype)
    keep = torch.full_like(chi, float(keep_outliers))
    w = live * torch.where(is_outlier, keep, torch.ones_like(chi)) * lam

    out_f = is_outlier.to(weights.dtype)
    inlier = live * (1.0 - out_f)
    stats = PICPStats(
        chi_inliers=(chi * inlier).sum(),
        chi_outliers=(chi * live * out_f).sum(),
        num_inliers=inlier.sum().to(torch.int32),
    )
    return error, p_cam, jp @ camera.camera_matrix, w, stats


def normal_system(jac: torch.Tensor, error: torch.Tensor, w: torch.Tensor):
    """H = sum w J^T J, b = sum w J^T e with the point and residual axes folded."""
    dof = jac.shape[-1]
    j2 = jac.reshape(-1, dof)
    jw2 = (jac * w[:, None, None]).reshape(-1, dof)
    return jw2.T @ j2, jw2.T @ error.reshape(-1)


def linearize(camera: Camera, world_points, measured_points, weights, kernel_threshold,
              keep_outliers: bool = False) -> Tuple[torch.Tensor, torch.Tensor, PICPStats]:
    """The normal system H (6, 6), b (6,) over all correspondences: world (N, 3)
    model points and measured (N, 2) image points per slot, weights (N,) the
    {0, 1} mask of live slots, the camera's pose the current GN iterate."""
    kernel_threshold = torch.as_tensor(kernel_threshold, dtype=world_points.dtype)
    error, p_cam, jpk, w, stats = projection_terms(
        camera, world_points, measured_points, weights, kernel_threshold, keep_outliers)
    # Jacobian of the transformation (picp_solver.cpp:37-41): [I3 | skew(-p_cam)].
    eye = torch.eye(3, dtype=world_points.dtype, device=world_points.device)
    jr = torch.cat([eye.expand(world_points.shape[0], 3, 3), se3.skew(-p_cam)], dim=-1)
    h, b = normal_system(jpk @ jr, error, w)
    return h, b, stats


def one_round(camera: Camera, world_points, measured_points, weights, kernel_threshold, damping,
              keep_outliers: bool = False,
              min_num_inliers=0) -> Tuple[Camera, PICPStats, torch.Tensor]:
    """One GN round (picp_solver.cpp:98-112): linearize, damp, solve, update.
    Also returns the applied increment ``dx`` (6,), zero when the round's
    inlier count is below ``min_num_inliers`` (the pose then stays)."""
    h, b, stats = linearize(camera, world_points, measured_points, weights, kernel_threshold,
                            keep_outliers)
    h = h + damping * torch.eye(6, dtype=h.dtype, device=h.device)
    dx = linalg6.cholesky_solve(h, -b)
    enough = stats.num_inliers >= int(min_num_inliers)
    dx = torch.where(enough, dx, torch.zeros_like(dx))
    return with_pose(camera, se3.v2t_euler(dx) @ camera.world_in_camera), stats, dx


def run_rounds(round_fn, camera: Camera, num_iterations: int, tolerance: float,
               min_iterations: int, dtype, device, rounds_out=None) -> Tuple[Camera, PICPStats]:
    """The GN loop around ``round_fn(camera) -> (camera, stats, dx)``:
    ``tolerance <= 0`` runs exactly ``num_iterations`` rounds; otherwise it
    stops once ``||dx||^2 <= tolerance``, but not before ``min_iterations``.
    The number of rounds run is appended to the list ``rounds_out``, if given."""
    stats = PICPStats(
        chi_inliers=torch.zeros((), dtype=dtype, device=device),
        chi_outliers=torch.zeros((), dtype=dtype, device=device),
        num_inliers=torch.zeros((), dtype=torch.int32, device=device),
    )
    it, dx2 = 0, float("inf")
    while it < num_iterations and (tolerance <= 0.0 or dx2 > tolerance or it < min_iterations):
        camera, stats, dx = round_fn(camera)
        it += 1
        if tolerance > 0.0:
            dx2 = float((dx * dx).sum())   # the host decides the exit: one sync a round
    if rounds_out is not None:
        rounds_out.append(it)
    return camera, stats


def solve(camera: Camera, world_points, measured_points, weights, num_iterations: int,
          kernel_threshold: float = 10000.0, damping: float = 1.0, keep_outliers: bool = False,
          tolerance: float = 0.0, backend: str = "auto", min_num_inliers: int = 0,
          min_iterations: int = 1, rounds_out=None) -> Tuple[Camera, PICPStats]:
    """Up to ``num_iterations`` GN rounds (the host loops of
    vo_complete.cpp:163-164 and vo_daKnown.cpp:149-150). ``backend``: ``auto``
    launches kernel K6 for CUDA tensors and runs the plain loop for CPU
    tensors, ``cuda`` requires the kernel, ``torch`` is the plain loop. The
    number of rounds run is appended to the list ``rounds_out``, if given:
    an int from the plain loop, a () int32 tensor from K6."""
    # Dead correspondence slots may carry garbage (failed triangulations can be
    # NaN/inf); 0 * NaN = NaN would poison the H/b sums on either route. K6
    # sanitizes them in the kernel; the plain loop here, once up front.
    if _lib.use_kernel(backend, world_points):
        from .kernels.picp_kernel import solve_fused

        pose, stats = solve_fused(
            camera.camera_matrix, camera.world_in_camera,
            (camera.z_near, camera.z_far, camera.cols, camera.rows), world_points,
            measured_points, weights, num_iterations, kernel_threshold, damping,
            tolerance if tolerance > 0.0 else -1.0, keep_outliers=keep_outliers,
            min_num_inliers=min_num_inliers, min_iterations=min_iterations, backend="cuda",
            rounds_out=rounds_out,
        )
        return with_pose(camera, pose), stats

    # This loop stands where K6 runs on the card, but it is not K6's dispatcher
    # (``solve_fused``, whose plain version mirrors the kernel's arithmetic),
    # so it tallies K6's work itself.
    _lib.tally("picp_solve", roofline.picp_model, world_points.shape[0], num_iterations)
    live = weights > 0.0
    world_points = torch.where(live[:, None], world_points, torch.ones_like(world_points))
    measured_points = torch.where(live[:, None], measured_points,
                                  torch.zeros_like(measured_points))

    def round_fn(cam):
        return one_round(cam, world_points, measured_points, weights, kernel_threshold, damping,
                         keep_outliers, min_num_inliers)

    return run_rounds(round_fn, camera, num_iterations, tolerance, min_iterations,
                      world_points.dtype, world_points.device, rounds_out)
