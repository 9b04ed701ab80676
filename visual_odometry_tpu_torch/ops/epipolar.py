"""Two-view epipolar initialization (port of visual_odometry_tpu.ops.epipolar).

8-point fundamental matrix over masked correspondences ([-1, 1]
normalization, null vector of the 9x9 normal matrix polished by inverse
iteration, rank-2 projection), E = K^T F K, the two SVD rotation candidates
with both translation signs, and the cheirality vote
(epipolar_utils.cpp:103-213). Eigenvector and singular-vector signs may
differ from JAX's; the candidate set and hence the chosen pose do not.

The normal matrix of the 8-point system and its null vector are taken in
float64, unlike the JAX package's (a TPU has no float64). At a baseline of a
hundredth of the depth the matrix's two smallest eigenvalues lie closer
together than float32 rounds its entries, so a float32 null vector is rounding
noise: the pose moves by 1e-2 to 1e-1 with the eigensolver and the order of
the sums, and on a third of 128-slot fields the track then loses inliers. The
float64 form is within 1e-6 of the JAX function evaluated in float64.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import se3, triangulation


def normalize_points(points: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale pixel coords into [-1, 1] per axis; returns (normalized, T)."""
    masked = torch.where(mask[..., None], points, torch.zeros_like(points))
    maxs = masked.amax(dim=-2)
    half = maxs / 2.0
    safe_half = torch.where(half == 0.0, torch.ones_like(half), half)
    normalized = points / safe_half[..., None, :] - 1.0
    t = torch.tensor(
        [[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]],
        dtype=points.dtype, device=points.device,
    )
    t[0, 0] = 1.0 / safe_half[..., 0]
    t[1, 1] = 1.0 / safe_half[..., 1]
    return normalized, t


def _null_vector(ata: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Unit null vector of a PSD normal matrix: eigh, then ridge-regularized
    inverse iteration (the f32 eigh vector alone is too coarse for E)."""
    _, vecs = torch.linalg.eigh(ata)
    v0 = vecs[:, 0]
    ridge = 1e-6 * torch.trace(ata)
    ata_r = ata + ridge * torch.eye(ata.shape[0], dtype=ata.dtype, device=ata.device)
    v = v0
    for _ in range(iters):
        # solve_ex, not solve: a singular system must fall back to the eigh
        # vector below (JAX's solve yields non-finite values there), not raise.
        sol, info = torch.linalg.solve_ex(ata_r, v)
        v = torch.where(info == 0, sol, float("nan"))
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    return torch.where(torch.all(torch.isfinite(v)), v, v0)


def _design_rows(d1: torch.Tensor, d2: torch.Tensor, corr_valid: torch.Tensor) -> torch.Tensor:
    rows = (d1[..., :, None] * d2[..., None, :]).reshape(d1.shape[:-1] + (9,))
    return torch.where(corr_valid[..., None], rows, torch.zeros_like(rows))


def estimate_fundamental(idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2) -> torch.Tensor:
    """8-point fundamental matrix with masked correspondences."""
    p1n, t1 = normalize_points(p1_img, mask1)
    p2n, t2 = normalize_points(p2_img, mask2)
    ones = torch.ones(idx1.shape + (1,), dtype=p1_img.dtype, device=p1_img.device)
    d1 = torch.cat([p1n[idx1.long()], ones], -1)
    d2 = torch.cat([p2n[idx2.long()], ones], -1)
    # float64 from here to the null vector: float32 is too coarse (module docstring)
    rows = _design_rows(d1, d2, corr_valid).double()
    f_approx = _null_vector(rows.T @ rows).to(p1_img.dtype).reshape(3, 3)
    u, s, vt = torch.linalg.svd(f_approx, full_matrices=True)
    s = torch.cat([s[:2], torch.zeros_like(s[2:])])
    f = (u * s) @ vt
    return t1.T @ f @ t2


def essential_to_transform_pair(e: torch.Tensor):
    """E -> (R1, t1, R2, t2) with the det(R) < 0 fix-up applied as a sign."""
    w = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=e.dtype, device=e.device
    )
    u, _, vt = torch.linalg.svd(e, full_matrices=True)
    v = vt.T
    r1 = v @ w @ u.T
    sign = torch.sign(torch.linalg.det(r1))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    r1 = sign * r1
    r2 = sign * (v @ w.T @ u.T)

    def unskew(m):
        return torch.stack([m[2, 1], m[0, 2], m[1, 0]])

    return r1, unskew(r1 @ e), r2, unskew(r2 @ e)


def homography_transfer_residuals(idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2):
    """Per-correspondence transfer residual of the best-fit DLT homography, in
    the [-1, 1]-normalized frame; returns (residuals, valid)."""
    p1n, _ = normalize_points(p1_img, mask1)
    p2n, _ = normalize_points(p2_img, mask2)
    i1, i2 = idx1.long(), idx2.long()
    x1, y1 = p1n[i1, 0], p1n[i1, 1]
    x2, y2 = p2n[i2, 0], p2n[i2, 1]
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    row_a = torch.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], dim=-1)
    row_b = torch.stack([zeros, zeros, zeros, x1, y1, ones, -y2 * x1, -y2 * y1, -y2], dim=-1)
    rows = torch.cat([row_a, row_b], dim=0)
    keep = torch.cat([corr_valid, corr_valid])[:, None]
    rows = torch.where(keep, rows, torch.zeros_like(rows))
    h = _null_vector(rows.T @ rows, iters=2).reshape(3, 3)

    px = h[0, 0] * x1 + h[0, 1] * y1 + h[0, 2]
    py = h[1, 0] * x1 + h[1, 1] * y1 + h[1, 2]
    pz = h[2, 0] * x1 + h[2, 1] * y1 + h[2, 2]
    safe_pz = torch.where(pz.abs() < 1e-12, torch.ones_like(pz), pz)
    res = torch.hypot(px / safe_pz - x2, py / safe_pz - y2)
    valid = corr_valid & (pz.abs() >= 1e-12)
    return torch.where(valid, res, torch.zeros_like(res)), valid


def estimate_transform(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2):
    """F -> E -> 4 candidates -> cheirality vote; the (4, 4) pose of camera 1
    in camera 2's frame (identity when no candidate puts a point in front)."""
    f = estimate_fundamental(idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2)
    e = camera_matrix.T @ f @ camera_matrix
    r1, t1, r2, t2 = essential_to_transform_pair(e)
    candidates = se3.pose_from_rt(
        torch.stack([r1, r1, r2, r2]), torch.stack([t1, -t1, t2, -t2])
    )  # (4, 4, 4), the reference's test order X1, X1(-t), X2, X2(-t)
    p1, p2 = p1_img[idx1.long()], p2_img[idx2.long()]
    votes = torch.stack([
        triangulation.triangulate_pairs(camera_matrix, x, p1, p2, corr_valid)[1].sum()
        for x in candidates
    ])                              # (4,)
    best = torch.argmax(votes)      # first max == the reference's strict > scan
    x_best = candidates[best]
    eye = torch.eye(4, dtype=x_best.dtype, device=x_best.device)
    return torch.where(votes[best] > 0, x_best, eye)
