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
