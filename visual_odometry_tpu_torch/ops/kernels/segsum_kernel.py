"""K9: segment sum into a small segment space,
``out[t, r] = sum_n values[n, r] * (seg[n] == t)``.

Replaces ``visual_odometry_tpu/ops/pallas/segsum_kernel.py:segment_sum_small``
with ``csrc/segment_sum.cu`` (the source's header gives the design and its
bound). The TPU kernel's one-hot matmul, its padding of R to 8 rows and of N
to whole blocks are not carried over, nor its limit of 1,024 segments: any
T and any R are taken.

A sum runs over a :class:`SegmentPlan` of the ids (:func:`plan_segments`):
the rows with an id in ``[0, T)`` stably sorted by id, and each segment's
offsets in that order. Rows whose id lies outside ``[0, T)`` add nothing.
The ids of a bundle adjustment stay fixed for the whole run, so its caller
makes the plan once (``parallel/sparse_ba``); a call without a plan makes one.

Order of the sum, fixed: segment t's rows in ascending sorted position
(ascending row index), its rank-q row going to lane ``q % 32`` at step
``q // 32``; each lane adds its rows serially from 0.0 in ascending step, and
the 32 lane partials meet in a shuffle-down tree (lane l takes lane l + o at
o = 16, 8, 4, 2, 1). The kernel and :func:`segment_sum_small_plain` add in
this order, so they agree bit for bit (up to the sign of a zero sum) and two
launches give identical bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...utils import roofline
from . import _lib


class SegmentPlan(NamedTuple):
    """The rows of each segment, in the order K9 adds them."""

    order: torch.Tensor    # (N,) int32 rows with an id in [0, T), stably sorted by id, then the rest
    offsets: torch.Tensor  # (T + 1,) int32: segment t is order[offsets[t]:offsets[t + 1]]


def plan_segments(seg: torch.Tensor, num_segments: int) -> SegmentPlan:
    """Sort the ids ``seg`` (N,) once for any number of sums over them."""
    if seg.shape[0] >= 2**31:
        raise ValueError(f"segment_sum takes fewer than 2^31 rows, got {seg.shape[0]}")
    key = seg.long()
    key = torch.where((key >= 0) & (key < num_segments), key, num_segments)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=num_segments + 1)[:num_segments]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return SegmentPlan(order.to(torch.int32), offsets.to(torch.int32))


def segment_sum_small_plain(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                            plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """The kernel's sum in the kernel's order (see the module docstring):
    one masked step of 32 lanes at a time, then the lane tree."""
    if plan is None:
        plan = plan_segments(seg, num_segments)
    r = values.shape[1]
    offsets = plan.offsets.long()
    counts = offsets.diff()
    m = int(offsets[-1])
    rows = plan.order[:m].long()
    sid = torch.repeat_interleave(torch.arange(num_segments, device=values.device), counts)
    rank = torch.arange(m, device=values.device) - offsets[:-1][sid]
    step = rank // 32
    dest = sid * 32 + rank % 32
    by_step = torch.argsort(step, stable=True)
    bounds = torch.cumsum(torch.bincount(step, minlength=1), 0).tolist()
    acc = values.new_zeros((num_segments * 32, r))
    lo = 0
    for hi in bounds:   # within a step every (segment, lane) appears at most once
        pick = by_step[lo:hi]
        d = dest[pick]
        acc[d] = acc[d] + values[rows[pick]]
        lo = hi
    acc = acc.reshape(num_segments, 32, r)
    for o in (16, 8, 4, 2, 1):
        acc = acc[:, :o] + acc[:, o:2 * o]
    return acc[:, 0]


def segment_sum_small_cuda(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                           plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """Launch K9. values (N, R) float32, seg (N,) int32, any T >= 1; ``plan``
    from :func:`plan_segments` on ``seg`` (made here when None)."""
    dev = _lib.cuda_device(values)
    n, r = values.shape
    if num_segments < 1:
        raise ValueError(f"segment_sum kernel takes at least one segment, got {num_segments}")
    _lib.check(values, "values", torch.float32, (n, r), dev)
    _lib.check(seg, "seg", torch.int32, (n,), dev)
    if plan is None:
        plan = plan_segments(seg, num_segments)
    _lib.check(plan.order, "plan.order", torch.int32, (n,), dev)
    _lib.check(plan.offsets, "plan.offsets", torch.int32, (num_segments + 1,), dev)
    out = values.new_empty((num_segments, r))
    _lib.launch("segment_sum", "vo_segment_sum", dev, values.data_ptr(), plan.order.data_ptr(),
                plan.offsets.data_ptr(), out.data_ptr(), r, num_segments)
    return out


def segment_sum_small(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                      backend: str = "auto", plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """(T, R) sums of the rows of ``values`` (N, R) by segment id ``seg`` (N,);
    rows whose id is outside ``[0, T)`` add nothing (pass T for masked rows).
    ``plan``, if given, is :func:`plan_segments` of ``seg`` and saves its sort."""
    _lib.tally("segment_sum", roofline.segment_sum_model, values.shape[0], num_segments,
               values.shape[1])
    if _lib.use_kernel(backend, values):
        return segment_sum_small_cuda(values.to(torch.float32).contiguous(),
                                      seg.to(torch.int32).contiguous(), num_segments, plan)
    return segment_sum_small_plain(values, seg, num_segments, plan)
