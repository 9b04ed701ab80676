"""K9: segment sum into a small segment space,
``out[t, r] = sum_n values[n, r] * (seg[n] == t)``.

Replaces ``visual_odometry_tpu/ops/pallas/segsum_kernel.py:segment_sum_small``
with ``csrc/segment_sum.cu``: each CTA adds a contiguous block of rows into a
(T, R) table in shared memory and then adds the table into the output, both
with atomics (the source's header gives the design and its bound). The TPU
kernel's one-hot matmul, its padding of R to 8 rows and of N to whole blocks
are not carried over.

Order of the sum: not fixed. Atomics land in the order the hardware schedules
them, so the kernel's sums differ in their last bits from run to run, and
from the plain version (``index_add_`` into T + 1 rows, the last dropped).
The kernel is held to the plain version at rtol 2e-5, atol 1e-4, the JAX
package's own tolerance for its kernel.
"""

from __future__ import annotations

import torch

from . import _lib

MAX_SEGMENTS = 1024


def segment_sum_small_plain(values: torch.Tensor, seg: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    seg = seg.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((num_segments + 1, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values)[:num_segments]


def segment_sum_small_cuda(values: torch.Tensor, seg: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Launch K9. values (N, R) float32, seg (N,) int32, T <= 1024."""
    dev = _lib.cuda_device(values)
    n, r = values.shape
    if not 1 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_sum kernel takes 1..{MAX_SEGMENTS} segments, "
                         f"got {num_segments}")
    _lib.check(values, "values", torch.float32, (n, r), dev)
    _lib.check(seg, "seg", torch.int32, (n,), dev)
    out = torch.zeros((num_segments, r), dtype=torch.float32, device=dev)
    _lib.launch("segment_sum", "vo_segment_sum", dev, values.data_ptr(), seg.data_ptr(),
                out.data_ptr(), n, r, num_segments)
    return out


def segment_sum_small(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                      backend: str = "auto") -> torch.Tensor:
    """(T, R) sums of the rows of ``values`` (N, R) by segment id ``seg`` (N,);
    rows whose id is outside ``[0, T)`` add nothing (pass T for masked rows)."""
    if _lib.use_kernel(backend, values):
        return segment_sum_small_cuda(values.to(torch.float32).contiguous(),
                                      seg.to(torch.int32).contiguous(), num_segments)
    return segment_sum_small_plain(values, seg, num_segments)
