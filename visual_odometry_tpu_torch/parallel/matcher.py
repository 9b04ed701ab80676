"""Sharded appearance matching: the landmark database split over the ranks of
the ``lm`` axis (port of visual_odometry_tpu.parallel.matcher).

Each rank holds one block of the database rows and the whole query set; it
finds its local top-1 (``ops.matching.best_match``, kernel K7 on the card),
and two ``pmin`` reductions over the axis combine the (distance, global
index) pairs: first the winning distance, then the smallest index among the
blocks that reached it, so the first global minimum wins ties as in a serial
scan over the blocks in order. Every rank returns the whole result.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import matching
from . import mesh as mesh_mod
from .mesh import Mesh

_INT32_MAX = 2**31 - 1


def sharded_best_match(
    mesh: Mesh,
    db: torch.Tensor,        # (L / n, D) this rank's block of the database rows
    db_mask: torch.Tensor,   # (L / n,)
    queries: torch.Tensor,   # (Q, D) whole
    q_mask: torch.Tensor,    # (Q,)
    radius: float = 0.1,
    axis: str = "lm",
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-1 match per query -> (global database index | -1, squared
    distance), on every rank of ``axis``.

    Semantics of ``ops.matching``: strict ``d^2 < radius^2`` acceptance, the
    first global minimum wins ties. ``db`` is this rank's block of a database
    split into equal blocks in axis order (:func:`shard_rows`); ``backend``
    routes the local top-1 (K7 for CUDA tensors under ``"auto"``)."""
    l_local = db.shape[0]
    dist, idx_local = matching.best_match(queries, q_mask, db, db_mask, backend)
    idx_global = idx_local + mesh.axis_index(axis) * l_local
    best_dist = mesh_mod.pmin(mesh, dist, axis)
    idx_cand = torch.where(dist == best_dist, idx_global, _INT32_MAX)
    best_idx = mesh_mod.pmin(mesh, idx_cand, axis)
    r2 = torch.tensor(radius, dtype=best_dist.dtype, device=best_dist.device) ** 2
    accept = q_mask & (best_dist < r2)
    return torch.where(accept, best_idx, -1), best_dist


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on this rank's device."""
    return x.to(mesh.device)


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: str = "lm") -> torch.Tensor:
    """This rank's block of the rows of ``x`` (equal blocks in axis order), on
    its device."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"database size {x.shape[0]} not divisible by mesh axis {n}")
    rows = x.shape[0] // n
    i = mesh.axis_index(axis)
    return x[i * rows:(i + 1) * rows].to(mesh.device)
