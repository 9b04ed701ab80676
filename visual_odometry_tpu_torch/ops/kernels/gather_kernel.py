"""K3: batched lane gather ``out[f, r, j] = src[f, r, idx[f, r, j]]``.

Replaces ``visual_odometry_tpu/ops/pallas/gather_kernel.py:gather_rows`` with
``csrc/gather_rows.cu`` (one thread per output element, bound by device
memory bandwidth). Contract: indices are pre-sanitized to ``[0, S)`` by the
caller — the pipeline maps invalid correspondence lanes to 0 — and the kernel
does not bound-check them (the plain version raises on the CPU).
"""

from __future__ import annotations

import torch

from . import _lib


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(src, 2, idx.long())


def gather_rows_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K3. src (F, R, S) float32 and idx (F, R, S) int32, contiguous."""
    dev = _lib.cuda_device(src)
    _lib.check(src, "src", torch.float32, src.shape, dev)
    _lib.check(idx, "idx", torch.int32, src.shape, dev)
    f, r, s = src.shape
    out = torch.empty_like(src)
    _lib.launch("gather_rows", "vo_gather_rows", dev,
                src.data_ptr(), idx.data_ptr(), out.data_ptr(), f * r, s)
    return out


def gather_rows(src: torch.Tensor, idx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    if _lib.use_kernel(backend, src):
        return gather_rows_cuda(src, idx)
    return gather_rows_plain(src, idx)


def take_lanes(rows, idx, backend: str = "auto"):
    """Gather a list of (F, S) rows by a matching list of (F, S) index rows in
    one call; each output keeps its input's dtype (integers round-trip
    exactly through float32 below 2^24)."""
    src = torch.stack([r.to(torch.float32) for r in rows], dim=1).contiguous()
    ix = torch.stack([i.to(torch.int32) for i in idx], dim=1).contiguous()
    out = gather_rows(src, ix, backend=backend)
    return tuple(out[:, i].to(r.dtype) for i, r in enumerate(rows))
