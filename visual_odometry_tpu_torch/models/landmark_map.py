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
    remaining capacity are dropped."""
    cap = map_state.points.shape[0]
    eq = torch.all(appearances[:, None, :] == map_state.appearances[None, :, :], dim=-1)
    eq = eq & map_state.valid[None, :] & mask[:, None]
    found = eq.any(dim=1)
    match_idx = eq.to(torch.int8).argmax(dim=1)   # first match

    new_points = map_state.points.clone()
    new_points[match_idx[found]] = points[found]

    append = mask & ~found
    offsets = torch.cumsum(append.to(torch.int32), 0) - 1
    pos = map_state.count + offsets
    keep = append & (pos < cap)
    slots = pos[keep].long()
    new_points[slots] = points[keep]
    new_apps = map_state.appearances.clone()
    new_apps[slots] = appearances[keep]
    new_valid = map_state.valid.clone()
    new_valid[slots] = True
    return LandmarkMap(
        points=new_points,
        appearances=new_apps,
        valid=new_valid,
        count=map_state.count + keep.sum().to(torch.int32),
    )


def compact(map_state: LandmarkMap) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: live (points, appearances) in insertion order."""
    valid = map_state.valid.cpu().numpy()
    return map_state.points.cpu().numpy()[valid], map_state.appearances.cpu().numpy()[valid]


def merge_stream(points, appearances, mask, capacity: int) -> LandmarkMap:
    """Fold a time-ordered observation stream into a map in one pass; equal to
    iterating :func:`update` over it.

    Rows group by the bit pattern of their appearance key (-0.0 is first
    canonicalized to +0.0, so bit equality is float equality). Per group the
    position is the LAST observation's (each re-observation replaces it) and
    groups enter the map in FIRST-observation order, truncated at
    ``capacity``. The JAX package's two payload-carrying sorts become
    ``torch.unique`` over the keys and two ``scatter_reduce`` passes over time.
    """
    t, d = appearances.shape
    dev = points.device
    apps_c = appearances + 0.0                          # -0.0 -> +0.0
    rows = torch.nonzero(mask).squeeze(1)               # live rows, time order
    keys = apps_c[rows].contiguous().view(torch.int32)
    out_pts = torch.zeros((capacity, 3), dtype=points.dtype, device=dev)
    out_apps = torch.full((capacity, d), float("inf"), dtype=appearances.dtype, device=dev)
    out_valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    if rows.numel() == 0:
        return LandmarkMap(out_pts, out_apps, out_valid, torch.zeros((), dtype=torch.int32,
                                                                     device=dev))
    uniq, group = torch.unique(keys, dim=0, return_inverse=True)
    g = uniq.shape[0]
    first = torch.full((g,), t, dtype=torch.int64, device=dev).scatter_reduce(
        0, group, rows, reduce="amin")
    last = torch.full((g,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, group, rows, reduce="amax")
    order = torch.argsort(first)[:capacity]             # first times are distinct
    n = order.shape[0]
    out_pts[:n] = points[last[order]]
    out_apps[:n] = apps_c[first[order]]
    out_valid[:n] = True
    return LandmarkMap(out_pts, out_apps, out_valid,
                       torch.tensor(n, dtype=torch.int32, device=dev))
