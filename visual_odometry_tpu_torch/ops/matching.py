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

from typing import NamedTuple

import torch

from .kernels import matcher_kernel
from .kernels.matcher_kernel import pairwise_sq_dists  # noqa: F401  (public re-export)


class Correspondences(NamedTuple):
    """Fixed-size correspondence set, ordered by query index."""

    idx1: torch.Tensor   # (..., S) int32
    idx2: torch.Tensor   # (..., S) int32
    valid: torch.Tensor  # (..., S) bool


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
