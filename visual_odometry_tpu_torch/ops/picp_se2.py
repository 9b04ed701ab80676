"""Projective ICP constrained to SE(2): the planar estimation variant
(port of visual_odometry_tpu.ops.picp_se2; the reference's ``est_SE2`` branch).

The camera is rigidly mounted on the robot via ``cam_in_robot`` = c. A planar
robot increment ``T(d)``, d = (dx, dy, dtheta), acts on the world-in-camera
pose ``X`` conjugated through the mount::

    X  <-  c^-1 . T(d) . c . X

so the composed relative robot motion ``c X^-1 c^-1`` stays exactly in SE(2).
With q = c X p the model point in robot coordinates, the derivative of the
updated camera-frame point at d = 0 is ``c_R^T [e_x | e_y | skew(e_z) q]``
and the residual Jacobian is ``Jp K`` times that. H is 3x3.

As in the JAX package, this solver has no backend route: the fused planar
solve (kernel K6, ``ops/kernels/picp_kernel.solve_se2_fused``) is called
directly by whoever wants one launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import linalg6, picp, se3
from .camera import Camera
from .picp import PICPStats


def linearize_se2(camera: Camera, world_points, measured_points, weights, kernel_threshold,
                  cam_in_robot,
                  keep_outliers: bool = False) -> Tuple[torch.Tensor, torch.Tensor, PICPStats]:
    """The planar normal system H (3, 3), b (3,) over all slots."""
    kernel_threshold = torch.as_tensor(kernel_threshold, dtype=world_points.dtype)
    error, p_cam, jpk, w, stats = picp.projection_terms(
        camera, world_points, measured_points, weights, kernel_threshold, keep_outliers)
    q = se3.transform_points(cam_in_robot, p_cam)  # robot coords
    zeros, ones = torch.zeros_like(q[..., 0]), torch.ones_like(q[..., 0])
    # Columns: d/d(dx) = e_x, d/d(dy) = e_y, d/d(dtheta) = skew(e_z) q.
    jr = torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, ones, zeros], -1),
        torch.stack([-q[..., 1], q[..., 0], zeros], -1),
    ], -1)  # (N, 3, 3) in robot coords
    jr = cam_in_robot[:3, :3].T @ jr  # back to camera coords
    h, b = picp.normal_system(jpk @ jr, error, w)
    return h, b, stats


def one_round_se2(camera: Camera, world_points, measured_points, weights, kernel_threshold,
                  damping, cam_in_robot, cam_in_robot_inv, keep_outliers: bool = False,
                  min_num_inliers=0) -> Tuple[Camera, PICPStats, torch.Tensor]:
    """One planar GN round: linearize, damp, 3x3 solve, conjugated update; the
    inlier floor skips the update as in ``picp.one_round``."""
    h, b, stats = linearize_se2(camera, world_points, measured_points, weights, kernel_threshold,
                                cam_in_robot, keep_outliers)
    h = h + damping * torch.eye(3, dtype=h.dtype, device=h.device)
    dx = linalg6.cholesky_solve(h, -b, n=3)
    enough = stats.num_inliers >= int(min_num_inliers)
    dx = torch.where(enough, dx, torch.zeros_like(dx))
    incr = cam_in_robot_inv @ se3.v2t_se2(dx) @ cam_in_robot
    return picp.with_pose(camera, incr @ camera.world_in_camera), stats, dx


def solve_se2(camera: Camera, world_points, measured_points, weights, num_iterations: int,
              kernel_threshold: float = 10000.0, damping: float = 1.0,
              keep_outliers: bool = False, tolerance: float = 0.0,
              cam_in_robot: Optional[torch.Tensor] = None, min_num_inliers: int = 0,
              min_iterations: int = 1, rounds_out=None) -> Tuple[Camera, PICPStats]:
    """Planar PICP solve, the loop of ``picp.solve``. ``cam_in_robot=None``
    means the camera is the planar body (identity mount). The returned pose
    lies in the conjugated SE(2) subgroup provided the start pose does
    (callers planarize the start with ``se3.project_se2``). The number of
    rounds run is appended to the list ``rounds_out``, if given."""
    dtype, dev = world_points.dtype, world_points.device
    if cam_in_robot is None:
        c = torch.eye(4, dtype=dtype, device=dev)
    else:
        c = torch.as_tensor(cam_in_robot, dtype=dtype).to(dev)
    c_inv = se3.inverse(c)

    def round_fn(cam):
        return one_round_se2(cam, world_points, measured_points, weights, kernel_threshold,
                             damping, c, c_inv, keep_outliers, min_num_inliers)

    return picp.run_rounds(round_fn, camera, num_iterations, tolerance, min_iterations, dtype, dev,
                           rounds_out)
