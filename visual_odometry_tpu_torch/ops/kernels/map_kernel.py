"""P2: the landmark-map fold of a call on the card (``csrc/map_fold.cu``).

:func:`merge_streams_cuda` folds B time-ordered streams of T rows into B maps
of ``capacity`` slots: a per-sequence exact-key hash table of each group's
first and last row, then the groups' heads ranked in row order: four
kernels (fill, insert, count, write) from one launch call, with no host wait
and no size read back. A stream may come as a head segment (the bootstrap's seed, or a
carried map) and a body, each read where it lies. Its plain version is
``models/landmark_map._merge_streams``, whose four outputs it gives bit for
bit; ``landmark_map.merge_stream`` dispatches between the two. No TPU
kernel: the JAX package folds with two XLA sorts.
"""

from __future__ import annotations

import torch

from . import _lib

TILE_ROWS = 1024   # rows a tile of the count and write passes (csrc/map_fold.cu kTile)


def table_entries(t: int) -> int:
    """A sequence's hash-table entries: the smallest power of two >= 2 T."""
    return 1 << max(2 * t - 1, 1).bit_length()


def merge_streams_cuda(points: torch.Tensor, appearances: torch.Tensor, mask: torch.Tensor,
                       capacity: int, head=None):
    """Launch P2 over (B, T, 3) float32 points, (B, T, D) float32
    appearances and a (B, T) bool mask, after the (B, H, ...) rows of
    ``head`` (points, appearances, mask) where one is given: both segments
    are read where they lie. Returns the maps' (points (B, C, 3),
    appearances (B, C, D), valid (B, C), count (B,) int32)."""
    dev = _lib.cuda_device(points)
    b, body, d = appearances.shape
    stream = [points.contiguous(), appearances.contiguous(), mask.contiguous()]
    front = stream if head is None else [x.contiguous() for x in head]
    h = 0 if head is None else front[2].shape[-1]
    parts = [(stream, body, "")] + ([] if head is None else [(front, h, "head ")])
    for (pts, apps, live), rows, part in parts:
        _lib.check(pts, part + "points", torch.float32, (b, rows, 3), dev)
        _lib.check(apps, part + "appearances", torch.float32, (b, rows, d), dev)
        _lib.check(live, part + "mask", torch.bool, (b, rows), dev)
    t = h + body
    p = table_entries(t)
    if b * p > 1 << 30 or d < 1 or capacity < 0:
        raise ValueError(f"map_fold kernel takes B x P <= 2^30 table entries, D >= 1 and a "
                         f"capacity >= 0; got B={b}, T={t}, D={d}, capacity={capacity}")
    tiles = -(-t // TILE_ROWS)
    scratch = torch.empty((b * (2 * p + t + tiles),), dtype=torch.int32, device=dev)
    out_pts = torch.empty((b, capacity, 3), dtype=torch.float32, device=dev)
    out_apps = torch.empty((b, capacity, d), dtype=torch.float32, device=dev)
    out_valid = torch.empty((b, capacity), dtype=torch.bool, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    _lib.launch("map_fold", "vo_map_fold", dev, *(x.data_ptr() for x in front + stream),
                out_pts.data_ptr(), out_apps.data_ptr(), out_valid.data_ptr(), count.data_ptr(),
                scratch.data_ptr(), b, t, h, d, capacity, p)
    return out_pts, out_apps, out_valid, count
