"""K3: batched lane gather ``out[f, r, j] = src[f, r, idx[f, r, j]]``; K10:
gather from a small shared table ``out[r, n] = table[r, idx[n]]``.

Replaces ``visual_odometry_tpu/ops/pallas/gather_kernel.py:gather_rows`` with
``csrc/gather_rows.cu`` (one thread per output element, bound by device
memory bandwidth). Contract: indices are pre-sanitized to ``[0, S)`` by the
caller — the pipeline maps invalid correspondence lanes to 0 — and the kernel
does not bound-check them (the plain version raises on the CPU).

K10 (:func:`take_table`) replaces ``gather_kernel.py:take_table`` with
``csrc/take_table.cu``: the table staged in shared memory once per CTA, a
thread per observation. Indices are clipped to ``[0, T - 1]``; the TPU kernel
clips to the end of its lane-padded table, which is the same at a whole-tile
T and reads its zero padding at a ragged one. Not carried over: the padding of the table to 8 rows and
whole 128-lane tiles and the indices replicated over 8 sublanes (Mosaic layout
needs), and with them the limit of 8 rows: R goes up to 12, so the 12 pose
rows of a bundle adjustment take one launch where the JAX caller splits them
into 8 + 4.
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


# --------------------------------------------------------------------------
# K10: shared-table gather
# --------------------------------------------------------------------------

TABLE_MAX_ROWS, TABLE_MAX_COLS = 12, 1024


def take_table_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[:, idx.long().clamp(0, table.shape[1] - 1)]


def take_table_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K10. table (R, T) float32, R <= 12, T <= 1024; idx (N,) int32."""
    dev = _lib.cuda_device(table)
    r, t = table.shape
    if r > TABLE_MAX_ROWS or not 1 <= t <= TABLE_MAX_COLS:
        raise ValueError(f"take_table kernel takes a table of at most {TABLE_MAX_ROWS} x "
                         f"{TABLE_MAX_COLS}, got {r} x {t}")
    n = idx.shape[0]
    _lib.check(table, "table", torch.float32, (r, t), dev)
    _lib.check(idx, "idx", torch.int32, (n,), dev)
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    _lib.launch("take_table", "vo_take_table", dev, table.data_ptr(), idx.data_ptr(),
                out.data_ptr(), n, r, t)
    return out


def take_table(table: torch.Tensor, idx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """``out[r, n] = table[r, idx[n]]`` for a small shared table (R, T) and
    indices (N,), clipped to ``[0, T - 1]``; returns (R, N)."""
    if _lib.use_kernel(backend, table):
        return take_table_cuda(table.to(torch.float32).contiguous(),
                               idx.to(torch.int32).contiguous())
    return take_table_plain(table, idx)
