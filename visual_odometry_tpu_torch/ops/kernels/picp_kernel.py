"""K6: one standalone projective-ICP Gauss-Newton solve in one launch, SE(3)
(:func:`solve_fused`) and planar (:func:`solve_se2_fused`); K11: one GN
linearization, H, b and the stats, in one launch (:func:`linearize`).

Replaces ``visual_odometry_tpu/ops/pallas/picp_kernel.py:solve_fused`` and
``solve_se2_fused`` with ``csrc/picp_solve.cu``: one point a lane over a
thread block cluster of up to 8 CTAs of up to 256 threads
(:func:`solve_geometry`, which the wrapper passes to the kernel) around the
device GN loop ``gn_solve_ranked`` of ``csrc/gn_loop.cuh``. A solve is a chain
of dependent rounds — latency-bound on the card; see the source's header. The
kernel reads K, the start pose and the camera's limits where the caller keeps
them and takes the knobs by value: no parameter row is packed a call (the
planar mount rows, :func:`frame_kernel.mount_rows`, are made and copied a
call). It sanitizes dead slots itself (weight <= 0: world (1, 1, 1),
measurement (0, 0)), and so does its plain version.

Summation order, stated in both files: of the L lanes of the geometry, lane l
adds the terms of points l, l + L, ... in ascending order; then each warp's
shuffle-down tree, each CTA's warps in warp order and the CTAs in rank order
(``frame_kernel._block_sum`` at the launch geometry, which the plain versions
call). With the library built --fmad=false, kernel and plain version agree bit
for bit on the card at any N.

The arithmetic is the TPU kernel's Schur-complement form on Jacobi-scaled
sums; ``ops/picp.solve``'s plain round-by-round loop solves the same system
through a 6x6 Cholesky and agrees to float32 tolerance, not bitwise.

K11 replaces ``picp_kernel.py:linearize_pallas`` with
``csrc/picp_linearize.cu``: one point a lane over ceil(N / 256) CTAs
(:func:`linearize_geometry`, passed to the kernel), each CTA's 30 lane sums folded in warp order,
the CTAs' partials in CTA order by the last CTA to finish (a ticket counter
in per-stream scratch, ``_lib.stream_scratch``), written out as H
(mirrored), b and the stats. Its plain version sums the same lane terms in the
same order, so the two agree bit for bit on the card, and every launch gives
the same bits. Unlike the TPU kernel it applies the near-depth guard
``hz > 1e-6`` of ``ops/picp.linearize`` (the lane terms are the GN loops',
which have it). The TPU kernel's tiling (``tile``) and ``interpret`` are not
carried over.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...utils import roofline
from ..picp import PICPStats
from . import _lib
from .frame_kernel import _block_sum, _gn_lane_rows, _gn_loop_plain, mount_rows, pack_params


def solve_geometry(n: int) -> Tuple[int, int]:
    """K6's launch geometry at N points, (CTAs of the cluster, threads a CTA):
    one CTA of N rounded up to whole warps (at least 64) up to 256 points,
    then up to 8 CTAs of 256 threads (lanes loop over points above 2,048)."""
    if n <= 256:
        return 1, max(64, -(-n // 32) * 32)
    return min(8, -(-n // 256)), 256


def linearize_geometry(n: int) -> Tuple[int, int]:
    """K11's launch geometry at N points, (CTAs, threads a CTA): one point a
    lane, up to 256 a CTA."""
    threads = min(256, max(64, -(-n // 32) * 32))
    return max(1, -(-n // threads)), threads


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor; ``x`` itself, with no call into
    PyTorch, when it is one already (the launch path's common case)."""
    if x.dtype is torch.float32 and x.is_contiguous():
        return x
    return x.to(torch.float32).contiguous()


def _stats(out: torch.Tensor, at: int) -> PICPStats:
    """The stats a kernel wrote at ``out[at:at + 3]``, the count as int32 bits."""
    return PICPStats(chi_inliers=out[at], chi_outliers=out[at + 1],
                     num_inliers=out.view(torch.int32)[at + 2])


def _solve_plain(params, world_points, measured_points, weights, num_iterations, min_iterations,
                 planar, rounds_out=None):
    dev = world_points.device
    live = weights > 0.0
    world_points = torch.where(live[:, None], world_points, 1.0)
    measured_points = torch.where(live[:, None], measured_points, 0.0)
    par = params.cpu().unbind(0)
    ctas, threads = solve_geometry(world_points.shape[0])
    pose, stats = _gn_loop_plain(
        num_iterations, min_iterations, par, tuple(par[28:40]),
        world_points[:, 0], world_points[:, 1], world_points[:, 2],
        measured_points[:, 0], measured_points[:, 1], weights, planar, rounds_out,
        lambda rows: _block_sum(rows, ctas, threads),
    )
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)
    pose44 = torch.cat([torch.stack(pose).reshape(3, 4), bottom[None]]).to(dev)
    stats = torch.stack(stats).to(dev)
    return pose44, PICPStats(chi_inliers=stats[0], chi_outliers=stats[1],
                             num_inliers=stats[2].to(torch.int32))


def _solve_cuda(camera_matrix, pose0, cam_params, mount, world_points, measured_points, weights,
                num_iterations, min_iterations, knobs, rounds_out=None):
    """Launch K6. ``cam_params`` is four () or one (4,) float32 tensors;
    ``mount`` the (24,) mount rows on the card, None for SE(3); ``knobs``
    (kernel_threshold, keep_outliers, damping, tolerance, min_inliers). The
    GN rounds run, a () int32 view of the output (no copy, no sync), are
    appended to the list ``rounds_out``, if given."""
    n = world_points.shape[0]
    dev = _lib.cuda_device(world_points)
    _lib.check(world_points, "world_points", torch.float32, (n, 3), dev)
    _lib.check(measured_points, "measured_points", torch.float32, (n, 2), dev)
    _lib.check(weights, "weights", torch.float32, (n,), dev)
    _lib.check(camera_matrix, "camera_matrix", torch.float32, (3, 3), dev)
    _lib.check(pose0, "world_in_camera", torch.float32, (4, 4), dev)
    if isinstance(cam_params, torch.Tensor):
        _lib.check(cam_params, "cam_params", torch.float32, (4,), dev)
        base = cam_params.data_ptr()
        cams = (base, base + 4, base + 8, base + 12)
    else:
        for c in cam_params:
            _lib.check(c, "cam_params", torch.float32, (), dev)
        cams = tuple(c.data_ptr() for c in cam_params)
    out = torch.empty((20,), dtype=torch.float32, device=dev)
    ctas, threads = solve_geometry(n)
    ptrs = (camera_matrix.data_ptr(), pose0.data_ptr(), *cams)
    if mount is not None:
        _lib.check(mount, "mount", torch.float32, (24,), dev)
        ptrs += (mount.data_ptr(),)
    _lib.launch(
        *(("picp_solve_se2", "vo_picp_solve_se2") if mount is not None
          else ("picp_solve", "vo_picp_solve")),
        dev, *ptrs,
        *(t.data_ptr() for t in (world_points, measured_points, weights, out)),
        n, ctas, threads, int(num_iterations), int(min_iterations), *knobs,
    )
    if rounds_out is not None:
        rounds_out.append(out.view(torch.int32)[19])
    return out[:16].view(4, 4), _stats(out, 16)


def _solve(backend, planar, camera_matrix, world_in_camera, cam_params, cam_in_robot,
           world_points, measured_points, weights, num_iterations, kernel_threshold, damping,
           tolerance, keep_outliers, min_num_inliers, min_iterations, rounds_out=None):
    _lib.tally("picp_solve_se2" if planar else "picp_solve",
               roofline.picp_model, world_points.shape[0], num_iterations, planar)
    points = (_f32(world_points), _f32(measured_points), _f32(weights))
    if _lib.use_kernel(backend, world_points):
        dev = world_points.device
        knobs = (float(kernel_threshold), 1.0 if keep_outliers else 0.0, float(damping),
                 float(tolerance), float(min_num_inliers))
        return _solve_cuda(_f32(camera_matrix), _f32(world_in_camera),
                           cam_params if isinstance(cam_params, tuple) else _f32(cam_params),
                           mount_rows(cam_in_robot).to(dev) if planar else None, *points,
                           num_iterations, min_iterations, knobs, rounds_out)
    # The frame kernels' parameter row, the start pose in its pose slot;
    # warm_start and K^-1 are not read.
    if isinstance(cam_params, tuple):
        cam_params = torch.stack(cam_params)
    params = pack_params(camera_matrix, cam_params, world_in_camera, kernel_threshold, damping,
                         tolerance, keep_outliers, False, min_num_inliers, planar, cam_in_robot,
                         k_inverse=False)
    return _solve_plain(params, *points, num_iterations, min_iterations, planar, rounds_out)


def solve_fused(camera_matrix, world_in_camera, cam_params, world_points, measured_points,
                weights, num_iterations: int, kernel_threshold, damping, tolerance,
                keep_outliers: bool = False, min_num_inliers=0.0, min_iterations: int = 1,
                backend: str = "auto", rounds_out=None) -> Tuple[torch.Tensor, PICPStats]:
    """Whole SE(3) PICP solve (the JAX ``solve_fused`` contract): camera matrix
    (3, 3), start pose (4, 4), cam_params (4,) = [z_near, z_far, cols, rows]
    (or, on the card, a tuple of those four () tensors), world (N, 3),
    measurements (N, 2), weights (N,); a dead slot (weight <= 0) may hold
    anything. Pass ``tolerance < 0`` for the fixed-budget loop. Returns
    (pose (4, 4), stats of the last round). The number of GN rounds run is
    appended to the list ``rounds_out``, if given: an int from the plain
    version, a () int32 tensor on the card."""
    return _solve(backend, False, camera_matrix, world_in_camera, cam_params, None, world_points,
                  measured_points, weights, num_iterations, kernel_threshold, damping, tolerance,
                  keep_outliers, min_num_inliers, min_iterations, rounds_out)


def solve_se2_fused(camera_matrix, world_in_camera, cam_params, cam_in_robot, world_points,
                    measured_points, weights, num_iterations: int, kernel_threshold, damping,
                    tolerance, keep_outliers: bool = False, min_num_inliers=0.0,
                    min_iterations: int = 1, backend: str = "auto",
                    rounds_out=None) -> Tuple[torch.Tensor, PICPStats]:
    """Whole planar PICP solve (``ops.picp_se2.solve_se2``'s loop, est_SE2);
    ``cam_in_robot`` is the (4, 4) mount, None = identity. Same contract as
    :func:`solve_fused`."""
    return _solve(backend, True, camera_matrix, world_in_camera, cam_params, cam_in_robot,
                  world_points, measured_points, weights, num_iterations, kernel_threshold,
                  damping, tolerance, keep_outliers, min_num_inliers, min_iterations, rounds_out)


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


# --------------------------------------------------------------------------
# K11: one linearization
# --------------------------------------------------------------------------


# H's 36 entries as indices into the 21 sums of its upper triangle, row-major
# (as csrc/picp_linearize.cu writes them: a gather keeps a -0.0 sum's sign).
_MIRROR = torch.tensor([min(r, c) * 6 - min(r, c) * (min(r, c) - 1) // 2 + abs(r - c)
                        for r in range(6) for c in range(6)])


def _linearize_plain(camera_matrix, pose, cam_params, world_points, measured_points, weights,
                     kernel_threshold, keep_outliers):
    params = pack_params(camera_matrix, cam_params, pose, kernel_threshold, 0.0, 0.0,
                         keep_outliers, False, 0.0, k_inverse=False)
    par = params.cpu().unbind(0)
    sums = _block_sum(_gn_lane_rows(
        par, tuple(par[28:40]), world_points[:, 0], world_points[:, 1], world_points[:, 2],
        measured_points[:, 0], measured_points[:, 1], weights),
        *linearize_geometry(world_points.shape[0]))
    dev = world_points.device
    sums_dev = sums.to(dev)
    return sums[_MIRROR].reshape(6, 6).to(dev), sums_dev[21:27], PICPStats(
        chi_inliers=sums_dev[27], chi_outliers=sums_dev[28],
        num_inliers=sums_dev[29].to(torch.int32))


def _linearize_cuda(camera_matrix, pose, cam_params, world_points, measured_points, weights,
                    kernel_threshold, keep_outliers):
    n = world_points.shape[0]
    dev = _lib.cuda_device(world_points)
    _lib.check(world_points, "world_points", torch.float32, (n, 3), dev)
    _lib.check(measured_points, "measured_points", torch.float32, (n, 2), dev)
    _lib.check(weights, "weights", torch.float32, (n,), dev)
    _lib.check(camera_matrix, "camera_matrix", torch.float32, (3, 3), dev)
    _lib.check(pose, "world_in_camera", torch.float32, (4, 4), dev)
    _lib.check(cam_params, "cam_params", torch.float32, (4,), dev)
    ctas, threads = linearize_geometry(n)
    scratch = _lib.stream_scratch(dev, 1 + 30 * ctas)
    out = torch.empty((45,), dtype=torch.float32, device=dev)
    cam = cam_params.data_ptr()
    _lib.launch("picp_linearize", "vo_picp_linearize", dev, camera_matrix.data_ptr(),
                pose.data_ptr(), cam, cam + 4, cam + 8, cam + 12,
                *(t.data_ptr() for t in (world_points, measured_points, weights, out)),
                scratch.data_ptr() + 4, scratch.data_ptr(), n, ctas, threads,
                float(kernel_threshold),
                1.0 if keep_outliers else 0.0)
    return out[:36].view(6, 6), out[36:42], _stats(out, 42)


def linearize(camera_matrix, world_in_camera, cam_params, world_points, measured_points, weights,
              kernel_threshold, keep_outliers: bool = False,
              backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, PICPStats]:
    """One GN linearization at ``world_in_camera`` (the JAX ``linearize_pallas``
    contract, a drop-in for ``ops.picp.linearize``): camera matrix (3, 3), pose
    (4, 4), cam_params (4,) = [z_near, z_far, cols, rows], world (N, 3),
    measurements (N, 2), weights (N,). Returns H (6, 6), b (6,) and the stats.
    Dead slots must hold finite values (``ops.picp.solve`` sanitizes them)."""
    _lib.tally("picp_linearize", roofline.linearize_model, world_points.shape[0])
    args = (*(_f32(x) for x in (camera_matrix, world_in_camera, cam_params, world_points,
                                measured_points, weights)), kernel_threshold, keep_outliers)
    if _lib.use_kernel(backend, world_points):
        return _linearize_cuda(*args)
    return _linearize_plain(*args)


def linearize_plain(camera_matrix, world_in_camera, cam_params, world_points, measured_points,
                    weights, kernel_threshold,
                    keep_outliers: bool = False) -> Tuple[torch.Tensor, torch.Tensor, PICPStats]:
    """Plain PyTorch version of :func:`linearize` on any device."""
    return linearize(camera_matrix, world_in_camera, cam_params, world_points, measured_points,
                     weights, kernel_threshold, keep_outliers, backend="torch")
