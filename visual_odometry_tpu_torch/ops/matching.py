"""Appearance-based data association (port of visual_odometry_tpu.ops.matching).

Exact top-1 nearest neighbour within the strict radius (``d^2 < r^2``,
brute_force_search.h:31-37), first index on ties. The reference builds its
kd-tree over whichever frame has MORE valid points and queries from the other
(vo_complete.cpp:15-46): both directions come from one pass of the pair
matcher (kernel K1 on CUDA tensors) and the query side is selected per pair
by the valid counts, with pairs kept as (frame-1 idx, frame-2 idx) in query
order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.config import MATCHER_PRECISIONS
from ..utils.profiling import host_wait
from .kernels import matcher_kernel
from .kernels.matcher_kernel import pairwise_sq_dists


class Correspondences(NamedTuple):
    """Fixed-size correspondence set, ordered by query index."""

    idx1: torch.Tensor   # (..., S) int32
    idx2: torch.Tensor   # (..., S) int32
    valid: torch.Tensor  # (..., S) bool


def best_match(queries, q_mask, db, db_mask, backend: str = "auto",
               precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 nearest database row per query -> (squared distance, index), the
    kd-tree best-match query (eigen_kdtree.h:90-115, brute_force_search.h:22-41)
    at map scale: queries (Q, D), db (K, D), bool masks. First index wins
    ties, masked queries return 3.4e38, masked database rows never win.

    ``backend="auto"`` launches kernel K7 for CUDA tensors at any database
    size and runs its plain version for CPU tensors. ``precision="fast"``
    selects on a bfloat16-rounded gram and re-scores the winner exactly in
    float32: returned distances, and so every radius decision, are exact for
    the returned index; the selection can differ from ``"highest"`` only
    between candidates within bfloat16 rounding of each other."""
    if precision not in MATCHER_PRECISIONS:
        raise ValueError(f"precision={precision!r}; expected one of {MATCHER_PRECISIONS}")
    return matcher_kernel.best_match(
        queries.contiguous(), q_mask.contiguous(), db.contiguous(), db_mask.contiguous(),
        backend=backend, fast=precision == "fast",
    )


def radius_search(queries, q_mask, db, db_mask, radius: float = 0.1) -> torch.Tensor:
    """Every match within the radius as a dense (Q, K) bool matrix, the kd-tree
    radius queries (eigen_kdtree.h:54-70, brute_force_search.h:3-20): entry
    (q, k) is True iff both slots are live and ``||a_q - b_k||^2 < radius^2``
    (strict, as the reference's ``< squared_norm``)."""
    d = pairwise_sq_dists(queries, db)
    r2 = torch.tensor(radius, dtype=d.dtype, device=d.device) ** 2
    return (d < r2) & q_mask[:, None] & db_mask[None, :]


def match_appearances_batch(app1, mask1, app2, mask2, radius: float = 0.1,
                            backend: str = "auto") -> Correspondences:
    """Associations for B frame pairs: app (B, N, D), mask (B, N)."""
    best1_d, best1, best2_d, best2 = matcher_kernel.match_pairs(
        app1.contiguous(), mask1.contiguous(), app2.contiguous(), mask2.contiguous(),
        backend=backend,
    )
    n = app1.shape[1]
    r2 = torch.tensor(radius, dtype=app1.dtype) ** 2
    slots = torch.arange(n, dtype=torch.int32, device=app1.device)[None, :]
    n1 = mask1.sum(dim=1, keepdim=True)
    n2 = mask2.sum(dim=1, keepdim=True)
    kd_is_1 = n1 >= n2   # frame 1 has >= points -> tree over frame 1, frame 2 queries
    idx1 = torch.where(kd_is_1, best1, slots)
    idx2 = torch.where(kd_is_1, slots, best2)
    best_d = torch.where(kd_is_1, best1_d, best2_d)
    query_mask = torch.where(kd_is_1, mask2, mask1)
    with host_wait("match.radius"):
        valid = query_mask & (best_d < r2.to(best_d.device))
    return Correspondences(idx1=idx1, idx2=idx2, valid=valid)


def match_appearances(app1, mask1, app2, mask2, radius: float = 0.1,
                      backend: str = "auto") -> Correspondences:
    """One frame pair: app (N, D), mask (N,); the batched matcher at B = 1."""
    if app1.shape[0] != app2.shape[0]:
        raise ValueError("padded frames must share a slot count")
    corr = match_appearances_batch(
        app1[None], mask1[None], app2[None], mask2[None], radius, backend
    )
    return Correspondences(*(x[0] for x in corr))


def lookup_from_corr(corr: Correspondences, tri_ok, n_slots: int) -> torch.Tensor:
    """(meas idx in frame 2) -> correspondence slot, first-wins (vo_complete.cpp:55-63);
    (S,) rows or (B, S) stacks, each row on its own."""
    dev = corr.idx2.device
    lead = corr.idx2.shape[:-1]
    big = n_slots + 1
    live = (corr.valid & tri_ok).reshape(-1, n_slots)
    slots = torch.arange(n_slots, dtype=torch.int64, device=dev).expand_as(live)
    # Dead correspondences go to a spare column n_slots, dropped after.
    target = torch.where(live, corr.idx2.reshape(-1, n_slots).long(), n_slots)
    lut = torch.full((live.shape[0], n_slots + 1), big, dtype=torch.int64, device=dev)
    lut = lut.scatter_reduce(1, target, slots, reduce="amin")[:, :n_slots]
    return torch.where(lut <= n_slots, lut, -1).to(torch.int32).reshape(lead + (n_slots,))
