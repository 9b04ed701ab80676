"""Fixed-capacity landmark map with exact-appearance merge
(port of visual_odometry_tpu.models.landmark_map).

Merge semantics of PointCloud.h:52-66: an incoming point whose appearance
equals a live entry's (exact float equality — appearances are carried
verbatim as landmark keys) replaces that entry's position; otherwise it is
appended in incoming order; appearances are never modified.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import se3
from ..ops.kernels import _lib, map_kernel
from ..utils.profiling import host_wait


class LandmarkMap(NamedTuple):
    points: torch.Tensor       # (C, 3)
    appearances: torch.Tensor  # (C, D)
    valid: torch.Tensor        # (C,) bool
    count: torch.Tensor        # () int32 live entries (a prefix of the slots)

    @classmethod
    def empty(cls, capacity: int, appearance_dim: int = 10, dtype=torch.float32,
              device="cpu") -> "LandmarkMap":
        return cls(
            points=torch.zeros((capacity, 3), dtype=dtype, device=device),
            # Empty slots hold +inf keys, which no real appearance equals.
            appearances=torch.full((capacity, appearance_dim), float("inf"), dtype=dtype,
                                   device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )


def update(map_state: LandmarkMap, points, appearances, mask) -> LandmarkMap:
    """Merge a cloud (N, 3) / (N, D) / (N,) into the map; entries past the
    remaining capacity are dropped. With a leading batch axis on the map and
    the cloud, each map takes its own cloud (comparisons, integer counts and
    copies only: a map's result does not depend on the batch)."""
    if mask.dim() == 1:
        out = _update(LandmarkMap(*(x[None] for x in map_state)), points[None],
                      appearances[None], mask[None])
        return LandmarkMap(*(x[0] for x in out))
    return _update(map_state, points, appearances, mask)


def _update(map_state: LandmarkMap, points, appearances, mask) -> LandmarkMap:
    """:func:`update` of (B, ...) maps and clouds."""
    b, cap = map_state.valid.shape
    eq = torch.all(appearances[:, :, None, :] == map_state.appearances[:, None, :, :], dim=-1)
    eq = eq & map_state.valid[:, None, :] & mask[:, :, None]
    found = eq.any(dim=2)
    match_idx = eq.to(torch.int8).argmax(dim=2)   # first match
    rows = torch.arange(b, device=mask.device)[:, None].expand_as(mask)

    new_points = map_state.points.clone()
    new_points[rows[found], match_idx[found]] = points[found]

    append = mask & ~found
    offsets = torch.cumsum(append.to(torch.int32), 1) - 1
    pos = map_state.count[:, None] + offsets
    keep = append & (pos < cap)
    at = (rows[keep], pos[keep].long())
    new_points[at] = points[keep]
    new_apps = map_state.appearances.clone()
    new_apps[at] = appearances[keep]
    new_valid = map_state.valid.clone()
    new_valid[at] = True
    return LandmarkMap(
        points=new_points,
        appearances=new_apps,
        valid=new_valid,
        count=map_state.count + keep.sum(dim=1).to(torch.int32),
    )


def transform(map_state: LandmarkMap, pose: torch.Tensor) -> LandmarkMap:
    """Apply an isometry to every point (PointCloud.h:77-82); appearances kept."""
    return map_state._replace(points=se3.transform_points(pose, map_state.points))


def compact(map_state: LandmarkMap) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: live (points, appearances) in insertion order."""
    valid = map_state.valid.cpu().numpy()
    return map_state.points.cpu().numpy()[valid], map_state.appearances.cpu().numpy()[valid]


def merge_stream(points, appearances, mask, capacity: int, backend: str = "auto",
                 head=None) -> LandmarkMap:
    """Fold a time-ordered observation stream into a map in one pass; equal to
    iterating :func:`update` over it.

    Rows group by the bit pattern of their appearance key (-0.0 is first
    canonicalized to +0.0, so bit equality is float equality). Per group the
    position is the LAST observation's (each re-observation replaces it) and
    groups enter the map in FIRST-observation order, truncated at
    ``capacity``.

    With a leading sequence axis ((B, T, 3), (B, T, D), (B, T)) every
    sequence folds its own stream into its own map, in the same one pass:
    groups never span sequences, and each sequence keeps its own
    first-observation order and capacity (the counterpart of ``jax.vmap``
    over the JAX fold). Integer keys and copied rows only: a sequence's map
    has the bits its own fold gives.

    ``head``: optional (points, appearances, mask) rows that come before the
    stream's, as though concatenated in front of them along the row axis
    (the bootstrap's seed, or a carried map): P2 reads both where they lie,
    the plain fold concatenates them.

    ``backend``: ``"auto"`` launches P2 (``ops/kernels/map_kernel``: an
    exact-key hash, four launches, no host wait) on CUDA tensors and runs the
    plain fold :func:`_merge_streams` on CPU tensors; ``"cuda"`` insists on
    the kernel; ``"torch"`` takes the plain fold on any device. Both give the
    same bits.
    """
    one = mask.dim() == 1
    if one:
        points, appearances, mask = points[None], appearances[None], mask[None]
        head = None if head is None else tuple(x[None] for x in head)
    if _lib.use_kernel(backend, points):
        out = LandmarkMap(*map_kernel.merge_streams_cuda(points, appearances, mask, capacity,
                                                         head))
    else:
        if head is not None:
            points, appearances, mask = (torch.cat([h, x], dim=1)
                                         for h, x in zip(head, (points, appearances, mask)))
        out = _merge_streams(points, appearances, mask, capacity)
    return LandmarkMap(*(x[0] for x in out)) if one else out


def _merge_streams(points, appearances, mask, capacity: int) -> LandmarkMap:
    """The plain :func:`merge_stream` of (B, T, ...) streams: the JAX
    package's two payload-carrying sorts become ``torch.unique`` over the keys
    (the sequence index the first key column) and two ``scatter_reduce``
    passes over time; the group count and the kept slots are read back."""
    b, t, d = appearances.shape
    dev = points.device
    apps_c = (appearances + 0.0).reshape(b * t, d)      # -0.0 -> +0.0
    flat_pts = points.reshape(b * t, 3)
    with host_wait("map_fold.nonzero"):
        rows = torch.nonzero(mask.reshape(-1)).squeeze(1)   # live rows, sequence then time order
    out_pts = torch.zeros((b, capacity, 3), dtype=points.dtype, device=dev)
    out_apps = torch.full((b, capacity, d), float("inf"), dtype=appearances.dtype, device=dev)
    out_valid = torch.zeros((b, capacity), dtype=torch.bool, device=dev)
    if rows.numel() == 0:
        return LandmarkMap(out_pts, out_apps, out_valid,
                           torch.zeros((b,), dtype=torch.int32, device=dev))
    keys = apps_c[rows].contiguous().view(torch.int32)
    if b > 1:   # one stream needs no sequence column: its groups are the same
        keys = torch.cat([(rows // t).to(torch.int32)[:, None], keys], dim=1)
    with host_wait("map_fold.unique"):
        uniq, group = torch.unique(keys, dim=0, return_inverse=True)
    g = uniq.shape[0]
    first = torch.full((g,), b * t, dtype=torch.int64, device=dev).scatter_reduce(
        0, group, rows, reduce="amin")
    last = torch.full((g,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, group, rows, reduce="amax")
    order = torch.argsort(first)                       # first rows are distinct
    first, last = first[order], last[order]
    owner = first // t
    with host_wait("map_fold.bincount", 2):   # its bounds, read back
        counts = torch.bincount(owner, minlength=b)
    rank = torch.arange(g, device=dev) - (torch.cumsum(counts, 0) - counts)[owner]
    keep = rank < capacity
    with host_wait("map_fold.keep", 4):       # each mask's count, read back
        at = (owner[keep], rank[keep])
        last_kept, first_kept = last[keep], first[keep]
    out_pts[at] = flat_pts[last_kept]
    out_apps[at] = apps_c[first_kept]
    with host_wait("map_fold.valid"):         # the host's True, copied over
        out_valid[at] = True
    return LandmarkMap(out_pts, out_apps, out_valid,
                       counts.clamp(max=capacity).to(torch.int32))
