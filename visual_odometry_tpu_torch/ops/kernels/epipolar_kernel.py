"""P1: the eight-point two-view pose of a batch of frame pairs in one launch,
``estimate_transform_batched``, and the whole two-view bootstrap of the
batch in one launch, ``bootstrap_batched`` (``csrc/eight_point.cu``, its
``SEED`` instance).

A port-only kernel: the JAX package computes this step with XLA
(``visual_odometry_tpu/ops/epipolar.py:estimate_transform``, vmapped by its
batched programs) and has no ``pallas_call`` for it. It is here because the
port's batched programs must give a sequence the bits it gets alone, and the
card's batched library solvers round by an algorithm chosen for the batch
(syevd against batched Jacobi, getrf against getrfBatched, gesvd against
gesvdj). Every step below is written out, so a pair's arithmetic is fixed
whatever the batch around it.

Per pair, what ``ops/epipolar.estimate_transform`` computes, every step in
float64 from the float32 inputs and the pose rounded to float32 once: the
JAX function evaluated in float64 (which the parity tests hold the port to,
``test_torch_pipeline.jax_bootstrap_in_double``) is the same computation, so
the two poses agree to about one float32 rounding on well-posed pairs
(3e-8). A float32 tail after the null vector (the per-pair form before P1)
left the pose ~1e-6 from that value, and the monocular chain grows such
differences.

1. ``normalize_points`` of both frames (masked max per axis);
2. the design rows ``vec(d1 d2^T)`` of the valid correspondences and the 45
   distinct entries of the 9x9 normal matrix. Each sum runs in one order:
   correspondence ``s`` goes to lane ``s % 32`` at step ``s // 32``, each lane
   adds its rows serially from 0.0, and the 32 lane partials meet in a
   shuffle-down tree (lane l takes lane l + o at o = 16, 8, 4, 2, 1);
3. the null vector, as ``epipolar._null_vector``: the eigenvector of the
   smallest eigenvalue from a cyclic Jacobi (pivots (p, q) in
   row-major order; the rotation of Numerical Recipes' ``jacobi``; from sweep
   4 on an entry negligible beside both diagonal entries is set to zero; a
   matrix stops when its off-diagonal is all zero, at most 50 sweeps; the
   first smallest diagonal entry picks the column), the ridge ``1e-6 trace``
   (the diagonal summed in index order), three inverse iterations through one
   LU with partial pivoting (a zero pivot is singular and falls back to the
   eigenvector, a non-finite result too);
4. the rank-2 projection by a one-sided Jacobi SVD of the 3x3 (column pairs
   (0, 1), (0, 2), (1, 2), rotated while ``|gamma| > 2^-50 sqrt(alpha
   beta)``, at most 16 sweeps; the smallest column is dropped),
   ``F = t1^T f t2``, ``E = K^T F K``, the same SVD of E with its columns in
   descending norm (U's third column ``u1 x u2``), ``R1 = V W U^T`` and
   ``R2 = V W^T U^T`` with the sign of ``det R1`` applied to both, ``t =
   unskew(R E)``;
5. the cheirality vote of the candidates X1, X1(-t), X2, X2(-t) over the
   correspondences with ``triangulation.triangulate_pairs_elementwise``'s
   arithmetic; the first maximum wins, the identity when no candidate has a
   vote.

6. (``bootstrap_batched``) what ``models/pipeline.initialize`` does after the
   pose: with a planar mount ``c``, the pose becomes ``c^-1 P(c X c^-1) c``
   (``se3.project_se2_elementwise``, float32 products); the valid
   correspondences are triangulated with
   ``triangulation.triangulate_pairs_elementwise``'s arithmetic (the pose's
   matrices formed in float64 and rounded once, float32 rays, the 2x2
   mid-point system in float64); the map that ``landmark_map.update`` seeds
   from an empty one: the triangulated slots in slot order, truncated at the
   capacity, with the second frame's appearances (utils.cpp:127); the
   lookup from each second-frame measurement to the first live slot on it
   (``matching.lookup_from_corr``, -1 where none); the pose's inverse as the
   history (``se3.inverse_elementwise``).

Eigenvector and singular-vector signs and orders may differ from LAPACK's;
the candidate set, and so the chosen pose, does not.
:func:`estimate_transform_batched_plain` repeats the kernel's arithmetic in its order on stacked tensors (elementwise operations
only, each correctly rounded), so on the card the two agree bit for bit under
``--fmad=false``, and a pair's pose is the same alone or in any batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...models import landmark_map
from ...models.landmark_map import LandmarkMap
from ...utils import roofline
from .. import matching, se3, triangulation
from . import _lib

WARP = 32
JACOBI_SWEEPS = 50      # the 9x9 eigen-solve's sweep cap
JACOBI_ZERO_FROM = 4    # first sweep that zeroes negligible off-diagonal entries
SVD3_SWEEPS = 16
SVD3_TOL = 2.0 ** -50   # rotate a column pair while |gamma| > SVD3_TOL sqrt(alpha beta)
INVERSE_ITERATIONS = 3
RIDGE = 1e-6
PAIRS9 = tuple((a, b) for a in range(9) for b in range(a, 9))   # the 45 normal-matrix entries


def lane_sums(x: torch.Tensor) -> torch.Tensor:
    """(B, S, K) -> (B, K): each column summed in the kernel's order (module
    docstring, step 2). Padding rows are zeros, which change no partial: a
    partial that starts at +0.0 never becomes -0.0."""
    b, s, k = x.shape
    steps = max(-(-s // WARP), 1)
    if steps * WARP != s:
        x = torch.cat([x, x.new_zeros((b, steps * WARP - s, k))], dim=1)
    x = x.reshape(b, steps, WARP, k)
    acc = x.new_zeros((b, WARP, k))
    for i in range(steps):
        acc = acc + x[:, i]
    for o in (16, 8, 4, 2, 1):
        acc = acc[:, :o] + acc[:, o:2 * o]
    return acc[:, 0]


def _normalize(p: torch.Tensor, mask: torch.Tensor):
    """``epipolar.normalize_points`` on (B, N, 2): (normalized points, 1 / half-extent (B, 2))."""
    masked = torch.where(mask[..., None], p, torch.zeros_like(p))
    half = masked.amax(dim=1) * 0.5
    safe = torch.where(half == 0.0, torch.ones_like(half), half)
    return p / safe[:, None, :] - 1.0, torch.reciprocal(safe)


def _take(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, S) of ``p`` (B, N, 2), indices clipped to [0, N - 1]."""
    k = idx.long().clamp(0, p.shape[1] - 1)
    return torch.gather(p, 1, k[..., None].expand(k.shape + (2,)))


def normal_matrix(idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2):
    """(B, 9, 9) normal matrices and the normalizations (B, 2) of both frames,
    float64 from float32 points."""
    p1n, s1 = _normalize(p1_img.double(), mask1)
    p2n, s2 = _normalize(p2_img.double(), mask2)
    q1, q2 = _take(p1n, idx1), _take(p2n, idx2)
    one = torch.ones_like(q1[..., 0])
    d1 = (q1[..., 0], q1[..., 1], one)
    d2 = (q2[..., 0], q2[..., 1], one)
    rows = torch.stack([d1[i] * d2[j] for i in range(3) for j in range(3)], dim=-1)
    rows = torch.where(corr_valid[..., None], rows, torch.zeros_like(rows))
    prods = torch.stack([rows[..., a] * rows[..., b] for a, b in PAIRS9], dim=-1)
    sums = lane_sums(prods)
    ata = sums.new_empty(sums.shape[:1] + (9, 9))
    for k, (a, b) in enumerate(PAIRS9):
        ata[:, a, b] = sums[:, k]
        ata[:, b, a] = sums[:, k]
    return ata, s1, s2


def _first_argmin(values) -> torch.Tensor:
    """Index of the first smallest of a list of (B,) tensors (a NaN counts as smallest)."""
    best, k = values[0], torch.zeros_like(values[0], dtype=torch.long)
    for i in range(1, len(values)):
        take = (values[i] < best) | (torch.isnan(values[i]) & ~torch.isnan(best))
        best = torch.where(take, values[i], best)
        k = torch.where(take, i, k)
    return k


def jacobi_eigvec_min(ata: torch.Tensor) -> torch.Tensor:
    """(B, 9) eigenvector of each matrix's smallest eigenvalue (module docstring, step 3)."""
    a = ata.clone()
    n = a.shape[-1]
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a).clone()
    off = ~torch.eye(n, dtype=torch.bool, device=a.device)
    for sweep in range(JACOBI_SWEEPS):
        if not bool((a[:, off] != 0.0).any()):
            break
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
                g = 100.0 * apq.abs()
                if sweep >= JACOBI_ZERO_FROM:
                    drop = (app.abs() + g == app.abs()) & (aqq.abs() + g == aqq.abs())
                else:
                    drop = torch.zeros_like(apq, dtype=torch.bool)
                rot = (apq != 0.0) & ~drop
                h = aqq - app
                theta = 0.5 * h / apq
                t = torch.reciprocal(theta.abs() + torch.sqrt(1.0 + theta * theta))
                t = torch.where(theta < 0.0, -t, t)
                t = torch.where(h.abs() + g == h.abs(), apq / h, t)
                c = torch.reciprocal(torch.sqrt(1.0 + t * t))
                s = t * c
                tau = s / (1.0 + c)
                hh = t * apq
                s_, tau_ = s[:, None], tau[:, None]
                gp, hq = a[:, :, p], a[:, :, q]
                new_p = gp - s_ * (hq + gp * tau_)
                new_q = hq + s_ * (gp - hq * tau_)
                b = a.clone()
                b[:, :, p], b[:, p, :] = new_p, new_p
                b[:, :, q], b[:, q, :] = new_q, new_q
                b[:, p, p] = app - hh
                b[:, q, q] = aqq + hh
                b[:, p, q] = 0.0
                b[:, q, p] = 0.0
                a = torch.where(rot[:, None, None], b, a)
                if sweep >= JACOBI_ZERO_FROM:
                    pq = torch.zeros_like(off)
                    pq[p, q] = pq[q, p] = True
                    a = torch.where(drop[:, None, None] & pq, torch.zeros_like(a), a)
                gp, hq = v[:, :, p], v[:, :, q]
                w = v.clone()
                w[:, :, p] = gp - s_ * (hq + gp * tau_)
                w[:, :, q] = hq + s_ * (gp - hq * tau_)
                v = torch.where(rot[:, None, None], w, v)
    k = _first_argmin([a[:, i, i] for i in range(n)])
    return torch.gather(v, 2, k[:, None, None].expand(-1, n, 1))[..., 0]


def lu_factor(m: torch.Tensor):
    """In-order LU with partial pivoting of (B, n, n): (packed LU, pivot rows
    (n, B), singular (B,)): the first largest |entry| pivots (the first NaN
    before any number), a zero pivot is singular."""
    m = m.clone()
    n = m.shape[-1]
    ar = torch.arange(m.shape[0], device=m.device)
    pivots, singular = [], torch.zeros(m.shape[0], dtype=torch.bool, device=m.device)
    for k in range(n):
        col = [m[:, i, k].abs() for i in range(k, n)]
        best, pk = col[0], torch.full_like(ar, k)
        for i in range(1, len(col)):
            take = (col[i] > best) | (torch.isnan(col[i]) & ~torch.isnan(best))
            best = torch.where(take, col[i], best)
            pk = torch.where(take, k + i, pk)
        rk, rp = m[:, k, :].clone(), m[ar, pk, :].clone()
        m[ar, pk, :] = rk
        m[:, k, :] = rp
        pivots.append(pk)
        singular = singular | (m[:, k, k] == 0.0)
        l = m[:, k + 1:, k] / m[:, k, k, None]
        m[:, k + 1:, k] = l
        m[:, k + 1:, k + 1:] = m[:, k + 1:, k + 1:] - l[..., None] * m[:, k, None, k + 1:]
    return m, pivots, singular


def lu_solve(lu: torch.Tensor, pivots, rhs: torch.Tensor) -> torch.Tensor:
    """Solve with :func:`lu_factor`'s result, each sum in index order."""
    n = lu.shape[-1]
    ar = torch.arange(lu.shape[0], device=lu.device)
    x = rhs.clone()
    for k in range(n):
        xk, xp = x[:, k].clone(), x[ar, pivots[k]].clone()
        x[ar, pivots[k]] = xk
        x[:, k] = xp
    xs = [x[:, i] for i in range(n)]
    for i in range(1, n):
        for j in range(i):
            xs[i] = xs[i] - lu[:, i, j] * xs[j]
    for i in range(n - 1, -1, -1):
        for j in range(i + 1, n):
            xs[i] = xs[i] - lu[:, i, j] * xs[j]
        xs[i] = xs[i] / lu[:, i, i]
    return torch.stack(xs, dim=-1)


def null_vector(ata: torch.Tensor) -> torch.Tensor:
    """(B, 9) unit null vectors of the normal matrices (module docstring, step 3)."""
    v0 = jacobi_eigvec_min(ata)
    n = ata.shape[-1]
    tr = ata[:, 0, 0]
    for i in range(1, n):
        tr = tr + ata[:, i, i]
    ridge = RIDGE * tr
    ata_r = ata.clone()
    for i in range(n):
        ata_r[:, i, i] = ata[:, i, i] + ridge
    lu, pivots, singular = lu_factor(ata_r)
    v = v0
    for _ in range(INVERSE_ITERATIONS):
        x = torch.where(singular[:, None], float("nan"), lu_solve(lu, pivots, v))
        sq = x[:, 0] * x[:, 0]
        for i in range(1, n):
            sq = sq + x[:, i] * x[:, i]
        nrm = torch.sqrt(sq)
        nrm = torch.where(nrm < 1e-30, torch.full_like(nrm, 1e-30), nrm)
        v = x / nrm[:, None]
    return torch.where(torch.isfinite(v).all(dim=-1, keepdim=True), v, v0)


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def svd3_columns(m: torch.Tensor):
    """One-sided Jacobi of (B, 3, 3): (columns of ``m V``, columns of ``V``),
    each a list of three lists of three (B,) tensors (step 4)."""
    cols = [[m[:, r, c] for r in range(3)] for c in range(3)]
    one, zero = torch.ones_like(m[:, 0, 0]), torch.zeros_like(m[:, 0, 0])
    vcols = [[one if r == c else zero for r in range(3)] for c in range(3)]
    live = torch.ones_like(one, dtype=torch.bool)
    for _ in range(SVD3_SWEEPS):
        turned = torch.zeros_like(live)
        for i, j in ((0, 1), (0, 2), (1, 2)):
            ai, aj = cols[i], cols[j]
            alpha, beta, gamma = _dot3(ai, ai), _dot3(aj, aj), _dot3(ai, aj)
            rot = live & (gamma.abs() > SVD3_TOL * torch.sqrt(alpha * beta))
            zeta = (beta - alpha) / (2.0 * gamma)
            t = torch.reciprocal(zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(zeta < 0.0, -t, t)
            c = torch.reciprocal(torch.sqrt(1.0 + t * t))
            s = c * t
            for group in (cols, vcols):
                gi, gj = group[i], group[j]
                group[i] = [torch.where(rot, c * x - s * y, x) for x, y in zip(gi, gj)]
                group[j] = [torch.where(rot, s * x + c * y, y) for x, y in zip(gi, gj)]
            turned = turned | rot
        live = live & turned
        if not bool(live.any()):
            break
    return cols, vcols


def _order3(cols):
    """(first, second, last) column indices (B,) by descending squared norm:
    the last is the smallest (the higher index on a tie, a NaN norm counting
    as -1), the other two in index order unless the second is larger."""
    n = []
    for c in cols:
        q = _dot3(c, c)
        n.append(torch.where(torch.isnan(q), torch.full_like(q, -1.0), q))
    last = torch.full(n[0].shape, 2, dtype=torch.long, device=n[0].device)
    best = n[2]
    for i in (1, 0):
        take = n[i] < best
        best = torch.where(take, n[i], best)
        last = torch.where(take, i, last)
    a = torch.where(last == 0, 1, 0)
    b = torch.where(last == 2, 1, 2)
    na = torch.gather(torch.stack(n, -1), 1, a[:, None])[:, 0]
    nb = torch.gather(torch.stack(n, -1), 1, b[:, None])[:, 0]
    swap = nb > na
    return torch.where(swap, b, a), torch.where(swap, a, b), last


def _pick(cols, k):
    """Column ``k`` (B,) of a list-of-columns matrix, as three (B,) tensors."""
    st = torch.stack([torch.stack(c, -1) for c in cols], 1)        # (B, 3 cols, 3 rows)
    return [x for x in torch.gather(st, 1, k[:, None, None].expand(-1, 1, 3))[:, 0].unbind(-1)]


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _mul3(a, b):
    """(B, 3, 3) product, each entry summed in index order."""
    return _mat([[(a[:, i, 0] * b[:, 0, j] + a[:, i, 1] * b[:, 1, j]) + a[:, i, 2] * b[:, 2, j]
                  for j in range(3)] for i in range(3)])


def essential(camera_matrix, ata, s1, s2) -> torch.Tensor:
    """(B, 3, 3) E = K^T (t1^T f t2) K from the normal matrices (step 4)."""
    f = null_vector(ata).reshape(-1, 3, 3)
    cols, vcols = svd3_columns(f)
    _, _, last = _order3(cols)
    zero = torch.zeros_like(cols[0][0])
    bz = [[torch.where(last == c, zero, x) for x in cols[c]] for c in range(3)]
    f2 = _mat([[(bz[0][i] * vcols[0][j] + bz[1][i] * vcols[1][j]) + bz[2][i] * vcols[2][j]
                for j in range(3)] for i in range(3)])
    o, z = torch.ones_like(zero), zero
    t1 = _mat([[s1[:, 0], z, -o], [z, s1[:, 1], -o], [z, z, o]])
    t2 = _mat([[s2[:, 0], z, -o], [z, s2[:, 1], -o], [z, z, o]])
    k = camera_matrix.double().expand(f.shape[0], 3, 3)
    big_f = _mul3(_mul3(t1.transpose(1, 2), f2), t2)
    return _mul3(_mul3(k.transpose(1, 2), big_f), k)


def candidates(e: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4, 4) candidate poses X1, X1(-t), X2, X2(-t) of E (step 4)."""
    cols, vcols = svd3_columns(e)
    i0, i1, i2 = _order3(cols)
    ba, bb = _pick(cols, i0), _pick(cols, i1)
    sa, sb = torch.sqrt(_dot3(ba, ba)), torch.sqrt(_dot3(bb, bb))
    sa = torch.where(sa == 0.0, torch.ones_like(sa), sa)
    sb = torch.where(sb == 0.0, torch.ones_like(sb), sb)
    ua, ub = [x / sa for x in ba], [x / sb for x in bb]
    uc = [ua[1] * ub[2] - ua[2] * ub[1], ua[2] * ub[0] - ua[0] * ub[2],
          ua[0] * ub[1] - ua[1] * ub[0]]
    va, vb, vc = _pick(vcols, i0), _pick(vcols, i1), _pick(vcols, i2)
    u = (ua, ub, uc)
    r1 = _mat([[(vb[r] * u[0][c] + (-va[r]) * u[1][c]) + vc[r] * u[2][c] for c in range(3)]
               for r in range(3)])
    r2 = _mat([[((-vb[r]) * u[0][c] + va[r] * u[1][c]) + vc[r] * u[2][c] for c in range(3)]
               for r in range(3)])
    det = ((r1[:, 0, 0] * (r1[:, 1, 1] * r1[:, 2, 2] - r1[:, 1, 2] * r1[:, 2, 1])
            - r1[:, 0, 1] * (r1[:, 1, 0] * r1[:, 2, 2] - r1[:, 1, 2] * r1[:, 2, 0]))
           + r1[:, 0, 2] * (r1[:, 1, 0] * r1[:, 2, 1] - r1[:, 1, 1] * r1[:, 2, 0]))
    sign = torch.where(det < 0.0, -torch.ones_like(det), torch.ones_like(det))[:, None, None]
    r1, r2 = sign * r1, sign * r2
    m1, m2 = _mul3(r1, e), _mul3(r2, e)
    t1 = torch.stack([m1[:, 2, 1], m1[:, 0, 2], m1[:, 1, 0]], -1)
    t2 = torch.stack([m2[:, 2, 1], m2[:, 0, 2], m2[:, 1, 0]], -1)
    return se3.pose_from_rt(torch.stack([r1, r1, r2, r2], 1), torch.stack([t1, -t1, t2, -t2], 1))


def choose(camera_matrix, cands, idx1, idx2, corr_valid, p1_img, p2_img) -> torch.Tensor:
    """The cheirality vote over the candidates (step 5): (B, 4, 4) float32 poses."""
    p1 = _take(p1_img.double(), idx1)[:, None]
    p2 = _take(p2_img.double(), idx2)[:, None]
    _, ok = triangulation.triangulate_pairs_elementwise(camera_matrix.double(), cands, p1, p2,
                                                        corr_valid[:, None])
    votes = ok.sum(dim=-1)                                   # (B, 4), integers
    best = torch.argmax(votes, dim=1)                        # the first maximum
    x = torch.gather(cands, 1, best[:, None, None, None].expand(-1, 1, 4, 4))[:, 0]
    eye = torch.eye(4, dtype=x.dtype, device=x.device).expand_as(x)
    won = torch.gather(votes, 1, best[:, None])[:, 0] > 0
    return torch.where(won[:, None, None], x, eye).float()


def estimate_transform_batched_plain(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img,
                                     mask1, mask2) -> torch.Tensor:
    """The kernel's arithmetic on stacked tensors (module docstring)."""
    ata, s1, s2 = normal_matrix(idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2)
    e = essential(camera_matrix, ata, s1, s2)
    return choose(camera_matrix, candidates(e), idx1, idx2, corr_valid, p1_img, p2_img)


def estimate_transform_batched_cuda(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img,
                                    mask1, mask2) -> torch.Tensor:
    """Launch P1: one CTA of one warp a pair. camera_matrix (3, 3) float32,
    idx (B, S) int32, corr_valid (B, S) bool, points (B, N, 2) float32,
    masks (B, N) bool; all contiguous on one card."""
    dev = _lib.cuda_device(p1_img)
    b, n = p1_img.shape[:2]
    s = idx1.shape[1]
    if n < 1:
        raise ValueError("eight_point takes frames of at least one slot")
    _lib.check(camera_matrix, "camera_matrix", torch.float32, (3, 3), dev)
    for name, t in (("idx1", idx1), ("idx2", idx2)):
        _lib.check(t, name, torch.int32, (b, s), dev)
    _lib.check(corr_valid, "corr_valid", torch.bool, (b, s), dev)
    for name, t in (("p1_img", p1_img), ("p2_img", p2_img)):
        _lib.check(t, name, torch.float32, (b, n, 2), dev)
    for name, t in (("mask1", mask1), ("mask2", mask2)):
        _lib.check(t, name, torch.bool, (b, n), dev)
    out = p1_img.new_empty((b, 4, 4))
    if b == 0:
        return out
    _lib.launch("eight_point", "vo_eight_point", dev, camera_matrix.data_ptr(), idx1.data_ptr(),
                idx2.data_ptr(), corr_valid.data_ptr(), p1_img.data_ptr(), p2_img.data_ptr(),
                mask1.data_ptr(), mask2.data_ptr(), out.data_ptr(), b, s, n)
    return out


def estimate_transform_batched(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img, mask1,
                               mask2, backend: str = "auto") -> torch.Tensor:
    """(B, 4, 4) pose of camera 1 in camera 2's frame for each of B frame
    pairs: idx (B, S), corr_valid (B, S), points (B, N, 2), masks (B, N); one
    camera for the batch. A pair's pose does not depend on the batch."""
    b, s = idx1.shape
    _lib.tally("eight_point", roofline.eight_point_model, b, s, p1_img.shape[1])
    if _lib.use_kernel(backend, p1_img):
        c = lambda t, dt: t.to(dt).contiguous()   # noqa: E731
        return estimate_transform_batched_cuda(
            c(camera_matrix, torch.float32), c(idx1, torch.int32), c(idx2, torch.int32),
            c(corr_valid, torch.bool), c(p1_img, torch.float32), c(p2_img, torch.float32),
            c(mask1, torch.bool), c(mask2, torch.bool))
    return estimate_transform_batched_plain(camera_matrix, idx1, idx2, corr_valid, p1_img,
                                            p2_img, mask1, mask2)


class Bootstrap(NamedTuple):
    """A batch's two-view bootstrap (module docstring, step 6), every tensor
    with the batch first."""

    x_init: torch.Tensor        # (B, 4, 4) frame 0 in frame 1, planarized with a mount
    history: torch.Tensor       # (B, 4, 4) its inverse
    tri_points: torch.Tensor    # (B, S, 3) frame-0 coordinates, zero where not valid
    tri_valid: torch.Tensor     # (B, S) bool
    map: LandmarkMap            # (B, C, ...) seeded from an empty map
    point_lookup: torch.Tensor  # (B, S) int32: second-frame measurement -> first slot, or -1


def bootstrap_batched_plain(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2,
                            apps2, capacity: int,
                            mount: Optional[np.ndarray] = None) -> Bootstrap:
    """The bootstrap instance's arithmetic on stacked tensors: the pose's
    plain version, then step 6 as the composition ``models/pipeline`` ran
    before P1 took it over, op for op."""
    x_init = estimate_transform_batched_plain(camera_matrix, idx1, idx2, corr_valid, p1_img,
                                              p2_img, mask1, mask2)
    mul = se3.matmul_elementwise
    if mount is not None:
        # Planarize the two-view init so the whole trajectory stays in the
        # conjugated SE(2) subgroup the solver moves in (ops/picp_se2).
        c = torch.from_numpy(mount).to(device=x_init.device, dtype=x_init.dtype)
        ci = se3.inverse_elementwise(c)
        x_init = mul(mul(ci, se3.project_se2_elementwise(mul(mul(c, x_init), ci))), c)

    def take(rows, idx):
        k = idx.long()
        return torch.gather(rows, 1, k[..., None].expand(k.shape + rows.shape[-1:]))

    tri, ok = triangulation.triangulate_pairs_elementwise(
        camera_matrix, x_init, take(p1_img, idx1), take(p2_img, idx2), corr_valid)
    # Triangulated appearances come from the SECOND frame (utils.cpp:127).
    tri_apps = take(apps2, idx2)
    b = tri.shape[0]
    empty = LandmarkMap.empty(capacity, apps2.shape[-1], tri.dtype, tri.device)
    map_state = landmark_map.update(LandmarkMap(*(x.expand((b,) + x.shape) for x in empty)),
                                    tri, tri_apps, ok)
    lookup = matching.lookup_from_corr(matching.Correspondences(idx1, idx2, corr_valid), ok,
                                       idx1.shape[-1])
    return Bootstrap(x_init, se3.inverse_elementwise(x_init), tri, ok, map_state, lookup)


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Whether each pair's rows ``t[i]`` lie contiguous (row-major strides,
    read without making a view)."""
    want = 1
    for n, st in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if n != 1 and st != want:
            return False
        want *= n
    return True


def _pair_rows(t: torch.Tensor, name: str, dtype, shape, dev) -> int:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` on ``dev`` whose
    pairs' rows are contiguous (the pairs may lie apart, as the frames of a
    (B, F, ...) stack do); returns the elements from one pair to the next."""
    if t.device != dev or t.dtype is not dtype or t.shape != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not _rows_contiguous(t):
        raise ValueError(f"{name}: each pair's rows must be contiguous")
    return t.stride(0)


_NO_MOUNT = _lib.Mount()


def mount_arg(mount: Optional[np.ndarray]) -> _lib.Mount:
    """The kernel's by-value mount: ``None`` for no planar projection."""
    if mount is None:
        return _NO_MOUNT
    arg = _lib.Mount()
    arg.m[:] = [float(x) for x in np.asarray(mount, np.float32).reshape(16)]
    arg.planar = 1
    return arg


def bootstrap_batched_cuda(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2,
                           apps2, capacity: int,
                           mount: Optional[np.ndarray] = None) -> Bootstrap:
    """Launch P1's bootstrap instance: one CTA of 256 threads a pair, every
    output written by the launch (no other kernel, no host sync).
    camera_matrix (3, 3) float32, idx (B, S) int32, corr_valid (B, S) bool,
    contiguous; points (B, S, 2) float32, masks (B, S) bool, apps2 (B, S, D)
    float32, each pair's rows contiguous; all on one card."""
    dev = _lib.cuda_device(p1_img)
    b, n = p1_img.shape[:2]
    s, d = idx1.shape[1], apps2.shape[-1]
    if n < 1 or s != n:
        raise ValueError(f"the bootstrap takes S = N >= 1 correspondences and slots, got {s}, {n}")
    _lib.check(camera_matrix, "camera_matrix", torch.float32, (3, 3), dev)
    for name, t in (("idx1", idx1), ("idx2", idx2)):
        _lib.check(t, name, torch.int32, (b, s), dev)
    _lib.check(corr_valid, "corr_valid", torch.bool, (b, s), dev)
    strides = [_pair_rows(p1_img, "p1_img", torch.float32, (b, n, 2), dev),
               _pair_rows(p2_img, "p2_img", torch.float32, (b, n, 2), dev),
               _pair_rows(mask1, "mask1", torch.bool, (b, n), dev),
               _pair_rows(mask2, "mask2", torch.bool, (b, n), dev),
               _pair_rows(apps2, "apps2", torch.float32, (b, n, d), dev)]
    f32 = dict(dtype=torch.float32, device=dev)
    out = Bootstrap(
        x_init=torch.empty((b, 4, 4), **f32), history=torch.empty((b, 4, 4), **f32),
        tri_points=torch.empty((b, s, 3), **f32),
        tri_valid=torch.empty((b, s), dtype=torch.bool, device=dev),
        map=LandmarkMap(points=torch.empty((b, capacity, 3), **f32),
                        appearances=torch.empty((b, capacity, d), **f32),
                        valid=torch.empty((b, capacity), dtype=torch.bool, device=dev),
                        count=torch.empty((b,), dtype=torch.int32, device=dev)),
        point_lookup=torch.empty((b, s), dtype=torch.int32, device=dev))
    if b == 0:
        return out
    outs = (out.x_init, out.history, out.tri_points, out.tri_valid, *out.map, out.point_lookup)
    _lib.launch("eight_point", "vo_eight_point_seed", dev,
                *(t.data_ptr() for t in (camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img,
                                         mask1, mask2, apps2, *outs)),
                b, s, n, capacity, d, *strides, mount_arg(mount))
    return out


def bootstrap_batched(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img, mask1, mask2,
                      apps2, capacity: int, mount: Optional[np.ndarray] = None) -> Bootstrap:
    """The two-view bootstrap of B frame pairs (module docstring, steps 1-6):
    idx (B, S), corr_valid (B, S), points (B, S, 2), masks (B, S), the second
    frames' appearances (B, S, D), one camera and map capacity for the batch;
    ``mount`` (4, 4) planarizes the pose (None: not planar). A pair's outputs
    do not depend on the batch. The kernel on CUDA tensors, the plain version
    on the CPU's."""
    b, s = idx1.shape
    _lib.tally("eight_point", roofline.eight_point_model, b, s, p1_img.shape[1], None, capacity,
               apps2.shape[-1])
    if p1_img.is_cuda:
        def rows(t, dt):   # pairs may lie apart (a frame of a stack); rows contiguous
            t = t.to(dt)
            return t if _rows_contiguous(t) else t.contiguous()

        c = lambda t, dt: t.to(dt).contiguous()   # noqa: E731
        return bootstrap_batched_cuda(
            c(camera_matrix, torch.float32), c(idx1, torch.int32), c(idx2, torch.int32),
            c(corr_valid, torch.bool), rows(p1_img, torch.float32), rows(p2_img, torch.float32),
            rows(mask1, torch.bool), rows(mask2, torch.bool), rows(apps2, torch.float32),
            capacity, mount)
    return bootstrap_batched_plain(camera_matrix, idx1, idx2, corr_valid, p1_img, p2_img, mask1,
                                   mask2, apps2, capacity, mount)
