"""Two-view epipolar initialization (port of visual_odometry_tpu.ops.epipolar).

8-point fundamental matrix over masked correspondences ([-1, 1]
normalization, null vector of the 9x9 normal matrix polished by inverse
iteration, rank-2 projection), E = K^T F K, the two SVD rotation candidates
with both translation signs, and the cheirality vote
(epipolar_utils.cpp:103-213). Eigenvector and singular-vector signs may
differ from JAX's; the candidate set and hence the chosen pose do not.
``estimate_transform`` is the batch of one of the eight-point kernel P1
(``ops/kernels/epipolar_kernel``), which writes each of these steps out in a
fixed order. ``estimate_fundamental`` and ``essential_to_transform_pair``,
the JAX names' counterparts, keep the library form (``torch.linalg``); the
pipeline does not call them.

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

from . import se3
from .kernels import epipolar_kernel


def transform_to_essential(x_1_in_2: torch.Tensor) -> torch.Tensor:
    """Ground-truth essential matrix ``E = R^T skew(t)`` of a relative pose
    (``transform2essential``, epipolar_utils.cpp:3-7)."""
    return se3.rot(x_1_in_2).transpose(-1, -2) @ se3.skew(se3.trans(x_1_in_2))


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
    ).repeat(points.shape[:-2] + (1, 1))
    t[..., 0, 0] = 1.0 / safe_half[..., 0]
    t[..., 1, 1] = 1.0 / safe_half[..., 1]
    return normalized, t


def _trace(m: torch.Tensor) -> torch.Tensor:
    """Trace over the last two axes. One matrix takes ``torch.trace``; a stack
    repeats what that gives on the CPU (a sequential float64 sum, rounded
    once), so that there each matrix of a stack gets the bits it gets alone.
    That equality holds on the CPU alone: it is what the CPU tests of the
    batched fits check. Were they held to the residuals' rounding instead,
    ``m.diagonal(dim1=-2, dim2=-1).sum(-1)`` would do."""
    if m.dim() == 2:
        return torch.trace(m)
    d = m.diagonal(dim1=-2, dim2=-1).double()
    out = d[..., 0]
    for i in range(1, d.shape[-1]):
        out = out + d[..., i]
    return out.to(m.dtype)


def _null_vector(ata: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Unit null vector of a PSD normal matrix (..., n, n): eigh, then
    ridge-regularized inverse iteration (the f32 eigh vector alone is too
    coarse for E), each matrix of a stack on its own."""
    _, vecs = torch.linalg.eigh(ata)
    v0 = vecs[..., :, 0]
    ridge = 1e-6 * _trace(ata)
    ata_r = ata + ridge[..., None, None] * torch.eye(ata.shape[-1], dtype=ata.dtype,
                                                    device=ata.device)
    v = v0
    for _ in range(iters):
        # solve_ex, not solve: a singular system must fall back to the eigh
        # vector below (JAX's solve yields non-finite values there), not raise.
        # A stack's solutions come back column-major: made row-major, each
        # row's norm is summed in the order of a lone vector's (on the CPU;
        # the card's order is its own).
        sol, info = torch.linalg.solve_ex(ata_r, v)
        v = torch.where((info == 0)[..., None], sol, float("nan")).contiguous()
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return torch.where(torch.isfinite(v).all(dim=-1, keepdim=True), v, v0)


def normalize_points_gauss(points: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitening normalization of one frame's (N, 2) points; returns (p, T)
    (``normalizeGauss``, epipolar_utils.cpp:67-101). Mean and 1/(n-1)
    covariance over the live points, ``T = [[L^-1, -L^-1 mu], [0, 1]]`` with
    ``L`` the covariance's lower Cholesky factor; live points map to
    ``L^-1 (p - mu)``, masked slots pass through. A degenerate covariance
    (fewer than 2 points, or collinear ones) gives the identity transform."""
    m = mask.to(points.dtype)
    n = m.sum()
    mu = (points * m[:, None]).sum(dim=0) / torch.clamp_min(n, 1.0)
    c = (points - mu) * m[:, None]
    sigma = (c.T @ c) / torch.clamp_min(n - 1.0, 1.0)
    a, b, d = sigma[0, 0], sigma[1, 0], sigma[1, 1]
    one = torch.ones_like(a)
    ok = (n >= 2.0) & (a > 0.0)
    l00 = torch.sqrt(torch.where(ok, a, one))       # the 2x2 Cholesky in closed form
    l10 = b / l00
    s22 = d - l10 * l10
    ok = ok & (s22 > 0.0)
    l11 = torch.sqrt(torch.where(ok, s22, one))
    i00, i11 = 1.0 / l00, 1.0 / l11
    inv_l = torch.stack([torch.stack([i00, torch.zeros_like(i00)]),
                         torch.stack([-l10 * i00 * i11, i11])])
    eye2 = torch.eye(2, dtype=points.dtype, device=points.device)
    w = torch.where(ok, inv_l, eye2)
    shift = torch.where(ok, -(w @ mu), torch.zeros_like(mu))
    t = torch.eye(3, dtype=points.dtype, device=points.device)
    t[:2, :2] = w
    t[:2, 2] = shift
    whitened = points @ w.T + shift
    return torch.where(mask[:, None], whitened, points), t


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


def estimate_essential(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img) -> torch.Tensor:
    """Direct essential matrix (3, 3) from calibrated rays (``estimate_essential``,
    epipolar_utils.cpp:9-46, unused by the reference's pipeline): design rows
    ``vec(d1 d2^T)`` of ``d = K^-1 [p; 1]`` over the valid correspondences, E
    the null vector of the 9x9 normal matrix, taken in float64 as in
    :func:`estimate_fundamental`; no rank-2 constraint, as in the reference.
    Its sign and scale are arbitrary. Callers check the correspondence count
    (the reference aborts below 8)."""
    ik = torch.linalg.inv(camera_matrix)
    ones = torch.ones(idx1.shape + (1,), dtype=p1_img.dtype, device=p1_img.device)
    d1 = torch.cat([p1_img[idx1.long()], ones], -1) @ ik.T
    d2 = torch.cat([p2_img[idx2.long()], ones], -1) @ ik.T
    rows = _design_rows(d1, d2, corr_valid).double()
    return _null_vector(rows.T @ rows).to(p1_img.dtype).reshape(3, 3)


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
    the [-1, 1]-normalized frame; returns (residuals, valid). Takes one frame
    pair (idx (S,), points (S, 2)) or a stack of them (leading axes on every
    argument), each pair solved on its own."""
    p1n, _ = normalize_points(p1_img, mask1)
    p2n, _ = normalize_points(p2_img, mask2)

    def take(p, idx):   # the rows idx of p, as x and y
        rows = torch.gather(p, -2, idx.long()[..., None].expand(idx.shape + (2,)))
        return rows[..., 0], rows[..., 1]

    x1, y1 = take(p1n, idx1)
    x2, y2 = take(p2n, idx2)
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    row_a = torch.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], dim=-1)
    row_b = torch.stack([zeros, zeros, zeros, x1, y1, ones, -y2 * x1, -y2 * y1, -y2], dim=-1)
    rows = torch.cat([row_a, row_b], dim=-2)
    keep = torch.cat([corr_valid, corr_valid], dim=-1)[..., None]
    rows = torch.where(keep, rows, torch.zeros_like(rows))
    h = _null_vector(rows.transpose(-1, -2) @ rows, iters=2).reshape(rows.shape[:-2] + (3, 3))

    def row(i):   # homography row i applied to (x1, y1, 1)
        return h[..., i, 0, None] * x1 + h[..., i, 1, None] * y1 + h[..., i, 2, None]

    px, py, pz = row(0), row(1), row(2)
    safe_pz = torch.where(pz.abs() < 1e-12, torch.ones_like(pz), pz)
    res = torch.hypot(px / safe_pz - x2, py / safe_pz - y2)
    valid = corr_valid & (pz.abs() >= 1e-12)
    return torch.where(valid, res, torch.zeros_like(res)), valid


def estimate_transform(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2):
    """F -> E -> 4 candidates -> cheirality vote; the (4, 4) pose of camera 1
    in camera 2's frame (identity when no candidate puts a point in front).
    The batch of one of kernel P1 (``ops/kernels/epipolar_kernel``), which
    takes the normal matrix's null vector by Jacobi and its own LU in
    float64 and the 3x3 SVDs by one-sided Jacobi: within 1e-6 of this
    module's ``eigh``/``solve_ex``/``svd`` form on the pipeline's scenes."""
    return epipolar_kernel.estimate_transform_batched(
        camera_matrix, idx1[None], idx2[None], corr_valid[None], p1_img[None], p2_img[None],
        mask1[None], mask2[None])[0]
