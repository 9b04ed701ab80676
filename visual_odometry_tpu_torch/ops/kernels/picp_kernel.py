"""K6: one standalone projective-ICP Gauss-Newton solve in one launch, SE(3)
(:func:`solve_fused`) and planar (:func:`solve_se2_fused`).

Replaces ``visual_odometry_tpu/ops/pallas/picp_kernel.py:solve_fused`` and
``solve_se2_fused`` with ``csrc/picp_solve.cu``: one CTA of up to 1024 threads
around the device GN loops of ``csrc/gn_loop.cuh`` (shared with the frame
kernels K4/K5). A solve is a chain of dependent rounds — latency-bound on the
card; see the source's header.

Summation order, stated in both files: thread j owns points j, j + T,
j + 2T, ... (T = the block's thread count) and adds their terms in that
ascending order; the block sum is then the one of the frame kernels
(``frame_kernel._block_sum``, which implements all of it for the plain
versions). With the library built --fmad=false, kernel and plain version agree
bit for bit on the card at any N.

The arithmetic is the TPU kernel's Schur-complement form on Jacobi-scaled
sums; ``ops/picp.solve``'s plain round-by-round loop solves the same system
through a 6x6 Cholesky and agrees to float32 tolerance, not bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..picp import PICPStats
from . import _lib
from .frame_kernel import _gn_loop_plain, pack_params


def _result(pose44: torch.Tensor, stats3: torch.Tensor) -> Tuple[torch.Tensor, PICPStats]:
    return pose44, PICPStats(chi_inliers=stats3[0], chi_outliers=stats3[1],
                             num_inliers=stats3[2].to(torch.int32))


def _solve_plain(params, world_points, measured_points, weights, num_iterations, min_iterations,
                 planar, rounds_out=None):
    dev = world_points.device
    par = params.cpu().unbind(0)
    pose, stats = _gn_loop_plain(
        num_iterations, min_iterations, par, tuple(par[28:40]),
        world_points[:, 0], world_points[:, 1], world_points[:, 2],
        measured_points[:, 0], measured_points[:, 1], weights, planar, rounds_out,
    )
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)
    pose44 = torch.cat([torch.stack(pose).reshape(3, 4), bottom[None]]).to(dev)
    return _result(pose44, torch.stack(stats).to(dev))


def _solve_cuda(params, world_points, measured_points, weights, num_iterations, min_iterations,
                planar):
    n = world_points.shape[0]
    dev = _lib.cuda_device(world_points)
    _lib.check(params, "params", torch.float32, (64 if planar else 40,), dev)
    _lib.check(world_points, "world_points", torch.float32, (n, 3), dev)
    _lib.check(measured_points, "measured_points", torch.float32, (n, 2), dev)
    _lib.check(weights, "weights", torch.float32, (n,), dev)
    pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    stats = torch.empty((3,), dtype=torch.float32, device=dev)
    _lib.launch(
        *(("picp_solve_se2", "vo_picp_solve_se2") if planar else ("picp_solve", "vo_picp_solve")),
        dev,
        *(t.data_ptr() for t in (params, world_points, measured_points, weights, pose, stats)),
        n, int(num_iterations), int(min_iterations),
    )
    return _result(pose, stats)


def _solve(backend, planar, camera_matrix, world_in_camera, cam_params, cam_in_robot,
           world_points, measured_points, weights, num_iterations, kernel_threshold, damping,
           tolerance, keep_outliers, min_num_inliers, min_iterations, rounds_out=None):
    # The frame kernels' parameter row; its initial pose is the start pose,
    # warm_start and K^-1 are not read.
    params = pack_params(camera_matrix, cam_params, world_in_camera, kernel_threshold, damping,
                         tolerance, keep_outliers, False, min_num_inliers, planar, cam_in_robot,
                         k_inverse=False)
    args = (params, world_points.to(torch.float32).contiguous(),
            measured_points.to(torch.float32).contiguous(),
            weights.to(torch.float32).contiguous(), num_iterations, min_iterations, planar)
    if _lib.use_kernel(backend, world_points):
        return _solve_cuda(*args)
    return _solve_plain(*args, rounds_out)


def solve_fused(camera_matrix, world_in_camera, cam_params, world_points, measured_points,
                weights, num_iterations: int, kernel_threshold, damping, tolerance,
                keep_outliers: bool = False, min_num_inliers=0.0, min_iterations: int = 1,
                backend: str = "auto") -> Tuple[torch.Tensor, PICPStats]:
    """Whole SE(3) PICP solve (the JAX ``solve_fused`` contract): camera matrix
    (3, 3), start pose (4, 4), cam_params (4,) = [z_near, z_far, cols, rows],
    world (N, 3), measurements (N, 2), weights (N,). Pass ``tolerance < 0`` for
    the fixed-budget loop. Returns (pose (4, 4), stats of the last round)."""
    return _solve(backend, False, camera_matrix, world_in_camera, cam_params, None, world_points,
                  measured_points, weights, num_iterations, kernel_threshold, damping, tolerance,
                  keep_outliers, min_num_inliers, min_iterations)


def solve_se2_fused(camera_matrix, world_in_camera, cam_params, cam_in_robot, world_points,
                    measured_points, weights, num_iterations: int, kernel_threshold, damping,
                    tolerance, keep_outliers: bool = False, min_num_inliers=0.0,
                    min_iterations: int = 1,
                    backend: str = "auto") -> Tuple[torch.Tensor, PICPStats]:
    """Whole planar PICP solve (``ops.picp_se2.solve_se2``'s loop, est_SE2);
    ``cam_in_robot`` is the (4, 4) mount, None = identity. Same contract as
    :func:`solve_fused`."""
    return _solve(backend, True, camera_matrix, world_in_camera, cam_params, cam_in_robot,
                  world_points, measured_points, weights, num_iterations, kernel_threshold,
                  damping, tolerance, keep_outliers, min_num_inliers, min_iterations)


def solve_fused_plain(camera_matrix, world_in_camera, cam_params, world_points, measured_points,
                      weights, num_iterations: int, kernel_threshold, damping, tolerance,
                      keep_outliers: bool = False, min_num_inliers=0.0, min_iterations: int = 1,
                      rounds_out=None) -> Tuple[torch.Tensor, PICPStats]:
    """Plain PyTorch version of :func:`solve_fused` on any device; the number
    of GN rounds it ran is appended to the list ``rounds_out``, if given."""
    return _solve("torch", False, camera_matrix, world_in_camera, cam_params, None, world_points,
                  measured_points, weights, num_iterations, kernel_threshold, damping, tolerance,
                  keep_outliers, min_num_inliers, min_iterations, rounds_out)


def solve_se2_fused_plain(camera_matrix, world_in_camera, cam_params, cam_in_robot, world_points,
                          measured_points, weights, num_iterations: int, kernel_threshold,
                          damping, tolerance, keep_outliers: bool = False, min_num_inliers=0.0,
                          min_iterations: int = 1,
                          rounds_out=None) -> Tuple[torch.Tensor, PICPStats]:
    """Plain PyTorch version of :func:`solve_se2_fused` on any device."""
    return _solve("torch", True, camera_matrix, world_in_camera, cam_params, cam_in_robot,
                  world_points, measured_points, weights, num_iterations, kernel_threshold,
                  damping, tolerance, keep_outliers, min_num_inliers, min_iterations, rounds_out)
