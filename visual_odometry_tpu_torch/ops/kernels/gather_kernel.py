"""K3: lane gather of records ``out[..., j, :] = src[..., clamp(idx[..., j]), :]``;
K10: gather from a small shared table ``out[r, n] = table[r, idx[n]]``.

K3 (:func:`gather_rows`) replaces ``visual_odometry_tpu/ops/pallas/gather_kernel.py:gather_rows``
with ``csrc/gather_rows.cu`` for the case every caller of either package
has: the D rows of a record share one index row. The JAX kernel takes (F, R,
S) rows and an index repeated over R; here src is the (F, S, D) layout the
pipeline holds (points D=2, appearances D=10; any D is taken), or a (B, F,
S, D) batch whose two leading strides are free (a frame slice of the serving
batch is read in place), and idx is (F, S) / (B, F, S). Indices are clipped
to ``[0, S - 1]`` (the JAX kernel needs them pre-sanitized to ``[0, S)``,
where the two agree).

K10 (:func:`take_table`) replaces ``gather_kernel.py:take_table`` with
``csrc/take_table.cu``, a warp per 32 observations. The table is read
through its two strides, so the transpose of an (F, R) tensor needs no copy,
and the output comes in the layout its consumer reads: (R, N) as in JAX, or
(N, R) with ``transpose_out``. Indices are clipped to ``[0, T - 1]``; the TPU
kernel clips to the end of its lane-padded table, which is the same at a
whole-tile T and reads its zero padding at a ragged one. Not carried over:
the padding of the table to 8 rows and whole 128-lane tiles and the indices
replicated over 8 sublanes (Mosaic layout needs), and with them the limit of
8 rows and of 1,024 columns: R goes up to 12, so the 12 pose rows of a bundle
adjustment take one launch where the JAX caller splits them into 8 + 4, and
T is any number of poses.
"""

from __future__ import annotations

import torch

from ...utils import roofline
from . import _lib

def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    s, d = src.shape[-2:]
    k = idx.long().clamp(0, s - 1)
    return torch.gather(src, -2, k[..., None].expand(*k.shape, d))


def gather_rows_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K3. src (F, S, D) or (B, F, S, D) float32, any D; its leading
    strides are free, and a source whose frames are not S x D contiguous
    floats is copied first. idx (F, S) or (B, F, S) int32, contiguous.
    Returns a contiguous ``src``-shaped tensor."""
    dev = _lib.cuda_device(src)
    *lead, s, d = src.shape
    if len(lead) not in (1, 2) or src.dtype is not torch.float32:
        raise ValueError(f"gather_rows kernel takes float32 (F, S, D) or (B, F, S, D) records; "
                         f"got {src.dtype} {tuple(src.shape)}")
    strides = src.stride()
    if (d > 1 and strides[-1] != 1) or (s > 1 and strides[-2] != d):
        src = src.contiguous()
        strides = src.stride()
    _lib.check(idx, "idx", torch.int32, (*lead, s), dev)
    out = src.new_empty(src.shape)
    seqs, seq_stride = (lead[0], strides[0]) if len(lead) == 2 else (1, 0)
    _lib.launch("gather_rows", "vo_gather_rows", dev, src.data_ptr(), idx.data_ptr(),
                out.data_ptr(), seqs, lead[-1], s, d, seq_stride, strides[-3])
    return out


def gather_rows(src: torch.Tensor, idx: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """``out[..., j, :] = src[..., clamp(idx[..., j], 0, S - 1), :]`` for
    records src (..., S, D) and indices (..., S)."""
    s = idx.shape[-1]
    _lib.tally("gather_rows", roofline.gather_model, idx.numel() // max(s, 1), s, src.shape[-1])
    if _lib.use_kernel(backend, src):
        return gather_rows_cuda(src, idx)
    return gather_rows_plain(src, idx)


# --------------------------------------------------------------------------
# K10: shared-table gather
# --------------------------------------------------------------------------

TABLE_MAX_ROWS = 12


def take_table_plain(table: torch.Tensor, idx: torch.Tensor,
                     transpose_out: bool = False) -> torch.Tensor:
    k = idx.long().clamp(0, table.shape[1] - 1)
    return table.T[k] if transpose_out else table[:, k]


def take_table_cuda(table: torch.Tensor, idx: torch.Tensor,
                    transpose_out: bool = False) -> torch.Tensor:
    """Launch K10. table (R, T) float32 with any strides, R <= 12, T >= 1;
    idx (N,) int32, contiguous. Returns (R, N), or (N, R) with
    ``transpose_out``."""
    dev = _lib.cuda_device(table)
    r, t = table.shape
    if r > TABLE_MAX_ROWS or t < 1:
        raise ValueError(f"take_table kernel takes a table of at most {TABLE_MAX_ROWS} rows "
                         f"and at least one column, got {r} x {t}")
    if table.dtype is not torch.float32:
        raise ValueError(f"table has dtype {table.dtype}, expected torch.float32")
    n = idx.shape[0]
    _lib.check(idx, "idx", torch.int32, (n,), dev)
    out = table.new_empty((n, r) if transpose_out else (r, n))
    st_r, st_t = table.stride()
    _lib.launch("take_table", "vo_take_table", dev, table.data_ptr(), st_r, st_t, idx.data_ptr(),
                out.data_ptr(), n, r, t, int(transpose_out))
    return out


def take_table(table: torch.Tensor, idx: torch.Tensor, backend: str = "auto",
               transpose_out: bool = False) -> torch.Tensor:
    """``out[r, n] = table[r, idx[n]]`` for a small shared table (R, T) and
    indices (N,), clipped to ``[0, T - 1]``; returns (R, N), or its transpose
    (N, R) with ``transpose_out``."""
    _lib.tally("take_table", roofline.take_table_model, idx.shape[0], table.shape[1],
               table.shape[0])
    if _lib.use_kernel(backend, table):
        return take_table_cuda(table, idx, transpose_out)
    return take_table_plain(table, idx, transpose_out)
