"""Batched PCA-split tree (port of visual_odometry_tpu.ops.pca_tree).

The reference's kd-tree splits a point set recursively at its mean along the
covariance's largest eigenvector (eigen_kdtree.h:18-38, split.h:8-34,
eigen_covariance.h:5-43). Here every node of a level splits at once, and the
tree is flat: ``axes (2^L - 1, D)`` and ``thresholds (2^L - 1,)`` in heap order
(node ``c`` of level ``l`` at ``2^l - 1 + c``), and each point's leaf as a
code, the bits of its root-to-leaf comparisons.

A level's per-node count, sum and scatter come from kernel K9
(``segsum_kernel.segment_sum_small``) over a plan of the points' node codes:
one fixed order of addition, so a tree built on the card has the same bits in
every run (``index_add_`` would add in atomic order there), and on the CPU K9's
plain version adds in that same order. The node axes are one batched ``eigh``.
Queries descend one side at every node and search their own leaf only, as
the JAX module does: the dense (Q, N) distances masked to the rows that share
the query's leaf code.

Query semantics are the reference's and the JAX module's:
  * :func:`descend`: one-sided, ``projection > threshold`` goes right
    (eigen_kdtree.h:75-85);
  * :func:`best_match_fast`: the leaf's best row, strict ``d^2 < r^2``, the
    first index on ties (``bestMatchFast`` -> brute_force_search.h:22-41); it
    misses a true neighbour across a split plane;
  * :func:`fast_radius_search`: every row of the leaf within the strict radius,
    as a dense (Q, N) mask (``fastSearch``, eigen_kdtree.h:40-52).
The exact search is the dense matcher (``ops/matching``).

An eigenvector's sign is arbitrary and differs between eigensolvers: a
flipped axis swaps a node's children. The leaves, and so every query's
answer, are the same; the codes' labels are not.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import stats
from .kernels import segsum_kernel
from .kernels.matcher_kernel import pairwise_sq_dists

_BIG = 3.4e38


class PCATree(NamedTuple):
    """Flat heap-ordered PCA-split tree over a padded point set; ``codes[i]``
    is point i's leaf in ``[0, 2^levels)``, -1 for a dead slot."""

    axes: torch.Tensor        # (2^L - 1, D)
    thresholds: torch.Tensor  # (2^L - 1,)
    codes: torch.Tensor       # (N,) int32
    levels: int


def build_tree(points: torch.Tensor, mask: torch.Tensor, levels: int) -> PCATree:
    """All ``2^levels - 1`` split planes, a level at a time: each node's masked
    mean, its 1/(n-1) covariance and that covariance's largest eigenvector
    (eigen_kdtree.h:27-29), then every live point steps to the child its
    projection on its node's axis picks."""
    n, d = points.shape
    codes = torch.where(mask, 0, -1).to(torch.int32)
    axes, thresholds = [], []
    counted = torch.cat([torch.ones_like(points[:, :1]), points], 1)   # (N, 1 + D)
    for level in range(levels):
        nb = 1 << level
        seg = torch.where(codes >= 0, codes, nb)           # dead slots add nothing
        plan = segsum_kernel.plan_segments(seg, nb)
        sums = segsum_kernel.segment_sum_small(counted, seg, nb, plan=plan)
        count = sums[:, 0]
        mean = sums[:, 1:] / torch.clamp_min(count, 1.0)[:, None]
        own = codes.clamp(0, nb - 1).long()
        centered = points - mean[own]
        outer = (centered[:, :, None] * centered[:, None, :]).reshape(n, d * d)
        cov = segsum_kernel.segment_sum_small(outer, seg, nb, plan=plan).reshape(nb, d, d)
        cov = cov / torch.clamp_min(count - 1.0, 1.0)[:, None, None]
        axis = stats.largest_eigenvector(cov)               # (nb, D)
        thr = (mean * axis).sum(-1)                          # the plane through the mean
        axes.append(axis)
        thresholds.append(thr)
        bit = ((points * axis[own]).sum(-1) > thr[own]).to(torch.int32)
        codes = torch.where(codes >= 0, codes * 2 + bit, -1).to(torch.int32)
    return PCATree(torch.cat(axes), torch.cat(thresholds), codes, levels)


def descend(tree: PCATree, queries: torch.Tensor) -> torch.Tensor:
    """Leaf code (Q,) int32 of each query under one-sided descent."""
    code = torch.zeros(queries.shape[:-1], dtype=torch.int64, device=queries.device)
    for level in range(tree.levels):
        node = (1 << level) - 1 + code
        bit = (queries * tree.axes[node]).sum(-1) > tree.thresholds[node]
        code = code * 2 + bit.long()
    return code.to(torch.int32)


def best_match_fast(tree: PCATree, db_points: torch.Tensor, queries: torch.Tensor,
                    q_mask: torch.Tensor, radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate nearest neighbour, the best row of the query's own leaf:
    (index (Q,) int32, found (Q,) bool). Found needs ``d^2 < radius^2``
    (strict); ties go to the lower index; a query whose leaf holds no row
    returns index 0, not found."""
    same_leaf = descend(tree, queries)[:, None] == tree.codes[None, :]   # dead rows are -1
    d = torch.where(same_leaf, pairwise_sq_dists(queries, db_points), _BIG)   # (Q, N)
    idx = d.argmin(dim=1)                                                     # first minimum
    best = d.min(dim=1).values
    r2 = torch.tensor(radius, dtype=d.dtype, device=d.device) ** 2
    return idx.to(torch.int32), q_mask & (best < r2)


def fast_radius_search(tree: PCATree, db_points: torch.Tensor, queries: torch.Tensor,
                       q_mask: torch.Tensor, radius: float) -> torch.Tensor:
    """Every row of the query's own leaf within the strict radius, as a dense
    (Q, N) bool mask."""
    q_codes = descend(tree, queries)
    d = pairwise_sq_dists(queries, db_points)
    r2 = torch.tensor(radius, dtype=d.dtype, device=d.device) ** 2
    return (q_codes[:, None] == tree.codes[None, :]) & (d < r2) & q_mask[:, None]
