"""Mid-point two-view triangulation (port of visual_odometry_tpu.ops.triangulation).

For correspondence (i, j) with X = pose of camera 1 in camera 2's frame:
``d1 = K^-1 [p1; 1]``, ``d2 = (X^-1.R K^-1) [p2; 1]``, ``t = X^-1.t``; the
2x2 normal equations give the ray parameters, a point is rejected behind a
camera (utils.cpp:41-42), on near-parallel rays or when not finite, and the
result is the segment midpoint in camera-1 coordinates.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import se3

_DET_EPS = 1e-12


def triangulate_pairs(
    camera_matrix: torch.Tensor,
    x_1_in_2: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangulate gathered pairs ``(..., N, 2)`` -> ``((..., N, 3), (..., N) ok)``."""
    i_x = se3.inverse(x_1_in_2)
    i_k = torch.linalg.inv(camera_matrix)
    ir_ik = se3.rot(i_x) @ i_k
    t = se3.trans(i_x)

    ones = torch.ones(p1.shape[:-1] + (1,), dtype=p1.dtype, device=p1.device)
    d1 = torch.cat([p1, ones], -1) @ i_k.T
    d2 = torch.cat([p2, ones], -1) @ ir_ik.T

    a00 = torch.sum(d1 * d1, -1)
    a01 = -torch.sum(d1 * d2, -1)
    a11 = torch.sum(d2 * d2, -1)
    b0 = -torch.sum(-d1 * t, -1)
    b1 = -torch.sum(d2 * t, -1)
    det = a00 * a11 - a01 * a01
    safe_det = torch.where(det.abs() < _DET_EPS, torch.ones_like(det), det)
    s0 = (a11 * b0 - a01 * b1) / safe_det
    s1 = (a00 * b1 - a01 * b0) / safe_det

    ok = valid & (s0 >= 0.0) & (s1 >= 0.0) & (det.abs() >= _DET_EPS)
    points = 0.5 * (s0[..., None] * d1 + t + s1[..., None] * d2)
    ok = ok & torch.all(points.abs() < 1e18, dim=-1)
    points = torch.where(ok[..., None], points, torch.zeros_like(points))
    return points, ok


def inv3_elementwise(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a (3, 3) matrix by its adjugate over its determinant, every
    product and sum written out in a fixed order (``csrc/eight_point.cu``
    repeats it)."""
    c = [[m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1], m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2],
          m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]],
         [m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2], m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0],
          m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]],
         [m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1], m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2],
          m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]]]
    det = (m[0, 0] * c[0][0] + m[0, 1] * c[0][1]) + m[0, 2] * c[0][2]
    return torch.stack([torch.stack([c[j][i] / det for j in range(3)]) for i in range(3)])


def _ray(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``m [x; y; 1]`` row by row, ``(m_r0 x + m_r1 y) + m_r2``; ``m`` (..., 3, 3)
    broadcasts over the trailing point axis of ``x``, ``y``."""
    return [(m[..., r, 0, None] * x + m[..., r, 1, None] * y) + m[..., r, 2, None]
            for r in range(3)]


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def triangulate_pairs_elementwise(
    camera_matrix: torch.Tensor,
    x_1_in_2: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`triangulate_pairs` with every product and sum written per
    element in a fixed order: poses ``(..., 4, 4)``, pairs ``(..., N, 2)``.
    No matmul or reduction, so a pair's bits do not depend on the batch
    around it. The pose's 3x3 matrices (``K^-1``, ``R^T K^-1``, ``-R^T t``)
    are formed in float64 and rounded once to the points' type, as
    :func:`triangulate_pairs` takes them from LAPACK and fused multiply-add
    matmuls; the rays are taken in the points' type; the 2x2 mid-point
    system runs in float64 on the widened rays (its determinant ``a00 a11 -
    a01^2`` cancels for near-parallel rays), the points rounded once at the
    end. The batched bootstrap (``models/pipeline.initialize_batched``)
    triangulates so on float32 points; the eight-point kernel's votes
    (``csrc/eight_point.cu``, ``epipolar_kernel.choose``) take float64
    points, so every step of theirs runs in float64."""
    dt, wd = p1.dtype, torch.float64
    i_k = inv3_elementwise(camera_matrix.to(wd))
    r, t = se3.rot(x_1_in_2).to(wd), se3.trans(x_1_in_2).to(wd)
    ir_ik = se3.matmul_elementwise(r.transpose(-1, -2), i_k).to(dt)
    ti = r[..., 0, :] * t[..., 0, None] + r[..., 1, :] * t[..., 1, None]
    ti = (-(ti + r[..., 2, :] * t[..., 2, None])).to(dt)
    d1 = [d.to(wd) for d in _ray(i_k.to(dt), p1[..., 0], p1[..., 1])]
    d2 = [d.to(wd) for d in _ray(ir_ik, p2[..., 0], p2[..., 1])]
    tv = [ti[..., k, None].to(wd) for k in range(3)]
    a00, a01, a11 = _dot(d1, d1), -_dot(d1, d2), _dot(d2, d2)
    b0, b1 = _dot(d1, tv), -_dot(d2, tv)
    det = a00 * a11 - a01 * a01
    safe_det = torch.where(det.abs() < _DET_EPS, torch.ones_like(det), det)
    s0 = (a11 * b0 - a01 * b1) / safe_det
    s1 = (a00 * b1 - a01 * b0) / safe_det
    ok = valid & (s0 >= 0.0) & (s1 >= 0.0) & (det.abs() >= _DET_EPS)
    points = torch.stack([((s0 * d1[k] + tv[k]) + s1 * d2[k]) * 0.5 for k in range(3)], -1)
    points = points.to(dt)
    ok = ok & torch.all(points.abs() < 1e18, dim=-1)
    points = torch.where(ok[..., None], points, torch.zeros_like(points))
    return points, ok


def triangulate_correspondences(
    camera_matrix: torch.Tensor,
    x_1_in_2: torch.Tensor,
    idx1: torch.Tensor,
    idx2: torch.Tensor,
    corr_valid: torch.Tensor,
    p1_img: torch.Tensor,
    p2_img: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot ``s`` holds the triangulation of correspondence ``s`` (utils.cpp:51-105)."""
    return triangulate_pairs(
        camera_matrix, x_1_in_2, p1_img[idx1.long()], p2_img[idx2.long()], corr_valid
    )
