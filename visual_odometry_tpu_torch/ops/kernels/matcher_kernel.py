"""K1: both-direction top-1 appearance matches for a batch of frame pairs;
K7: streaming top-1 of a query set against a map-scale database.

Replaces ``visual_odometry_tpu/ops/pallas/matcher_kernel.py``:
``match_pairs_pallas`` with ``csrc/match_pairs.cu`` (a CTA per direction
and 128-row tile of a pair, four rows a lane in registers against the other
frame staged in shared memory, FP32 pipes) and ``best_match_pallas`` with
``csrc/best_match.cu`` (query tiles x database splits, then a fold of the
splits). K1 runs on the FP32 pipes. K7 runs a gram on the tensor cores in
both modes (the fast mode on bf16-rounded operands, the exact mode on each
float32 split into two bf16 terms) and re-selects on the plain key among the
rows a proven error bound cannot rule out, see the sources' headers; small
exact problems and the fast mode past D = 16 take an FP32 scan
(``fp32_scan``).

Distances use the gram form ``(|a|^2 + |b|^2) - 2 a.b`` with every dot product
and squared norm summed in descriptor order from separately rounded products,
in the kernels and in the plain versions alike, so each kernel and its plain
version agree bitwise. K1 clamps at 0 before it compares; K7 selects on the
unclamped value and clamps the winner, as the TPU kernels do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...utils import roofline
from . import _lib

BIG = 3.4e38  # masked distance, selected before any comparison


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k] * x[..., k]
    return acc


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(..., N, D), (..., M, D) -> (..., N, M)`` squared distances, gram form."""
    dot = a[..., :, None, 0] * b[..., None, :, 0]
    for k in range(1, a.shape[-1]):
        dot.add_(a[..., :, None, k] * b[..., None, :, k])
    d = (_sq_norms(a)[..., :, None] + _sq_norms(b)[..., None, :]) - 2.0 * dot
    return torch.clamp_min(d, 0.0)


def match_pairs_plain(app1, mask1, app2, mask2) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K1: the dense (B, N, N) distances."""
    d = pairwise_sq_dists(app1, app2)
    d = torch.where(mask1[:, :, None] & mask2[:, None, :], d, BIG)
    best1_d, best1 = d.min(dim=1)   # per frame-2 column: first best frame-1 row
    best2_d, best2 = d.min(dim=2)   # per frame-1 row: first best frame-2 column
    return best1_d, best1.to(torch.int32), best2_d, best2.to(torch.int32)


def match_pairs_cuda(app1, mask1, app2, mask2) -> Tuple[torch.Tensor, ...]:
    """Launch K1. app (B, N, D) float32, mask (B, N) bool, all contiguous on
    one CUDA device; N <= 2048 (shared memory), D <= 32."""
    b, n, d = app1.shape
    dev = _lib.cuda_device(app1)
    if n > 2048 or d > 32:
        raise ValueError(f"match_pairs kernel takes N <= 2048 and D <= 32, got N={n}, D={d}")
    _lib.check(app1, "app1", torch.float32, (b, n, d), dev)
    _lib.check(app2, "app2", torch.float32, (b, n, d), dev)
    _lib.check(mask1, "mask1", torch.bool, (b, n), dev)
    _lib.check(mask2, "mask2", torch.bool, (b, n), dev)
    best1_d = torch.empty((b, n), dtype=torch.float32, device=dev)
    best2_d = torch.empty((b, n), dtype=torch.float32, device=dev)
    best1 = torch.empty((b, n), dtype=torch.int32, device=dev)
    best2 = torch.empty((b, n), dtype=torch.int32, device=dev)
    _lib.launch(
        "match_pairs", "vo_match_pairs", dev,
        *(t.data_ptr() for t in (app1, mask1, app2, mask2, best1_d, best1, best2_d, best2)),
        b, n, d,
    )
    return best1_d, best1, best2_d, best2


def match_pairs(app1, mask1, app2, mask2, backend: str = "auto") -> Tuple[torch.Tensor, ...]:
    """Returns (best1_d, best1, best2_d, best2), each (B, N): ``best1[j]`` is
    the frame-1 index best matching frame-2 point j, ``best2[i]`` the frame-2
    index best matching frame-1 point i; first index wins ties, all-masked
    rows give index 0 at distance 3.4e38."""
    _lib.tally("match_pairs", roofline.match_pairs_model, *app1.shape)
    if _lib.use_kernel(backend, app1):
        return match_pairs_cuda(app1, mask1, app2, mask2)
    return match_pairs_plain(app1, mask1, app2, mask2)


# --------------------------------------------------------------------------
# K7: map-scale top-1
# --------------------------------------------------------------------------

PLAIN_CHUNK = 16384   # database rows per step of the plain version
_TQ, _TK = 128, 256   # the kernel's query tile and staged database tile


def _ordered_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, D), (K, D) -> (Q, K) dot products summed in descriptor order."""
    dot = a[:, None, 0] * b[None, :, 0]
    for k in range(1, a.shape[-1]):
        dot.add_(a[:, None, k] * b[None, :, k])
    return dot


def best_match_plain(queries, q_mask, db, db_mask, fast: bool = False):
    """Plain PyTorch version of K7. Walks the database in chunks of
    ``PLAIN_CHUNK`` rows (the (Q, K) matrix is never whole in memory) and
    folds them in ascending order with a strict '<', so the first index wins
    ties, as in the kernel.

    Exact mode selects on ``(|q|^2 + n_k) - 2 q.k``, unclamped, where n_k is
    ``|k|^2`` or 3.4e38 with the row zeroed for a masked row. ``fast`` selects
    on the same expression with q and the rows rounded to bfloat16 inside the
    dot product (float32 accumulation, float32 norms), clamped at 0 and packed
    with the column into one 64-bit key (distance bits high, column low), then
    recomputes the winner's distance exactly as sum((q - k)^2); a masked
    winner gives 3.4e38. A NaN distance never wins in either mode."""
    nq, nk = queries.shape[0], db.shape[0]
    dev = queries.device
    qn = _sq_norms(queries)
    qd = queries.to(torch.bfloat16).to(torch.float32) if fast else queries
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    best = torch.full((nq,), BIG, dtype=torch.float32, device=dev)
    arg = torch.zeros((nq,), dtype=torch.int64, device=dev)
    best_key = (best.view(torch.int32).to(torch.int64) << 32) | arg
    for lo in range(0, nk, PLAIN_CHUNK):
        m = db_mask[lo:lo + PLAIN_CHUNK]
        rows = torch.where(m[:, None], db[lo:lo + PLAIN_CHUNK], 0.0)
        dbn = torch.where(m, _sq_norms(rows), BIG)
        if fast:
            rows = rows.to(torch.bfloat16).to(torch.float32)
        v = (qn[:, None] + dbn[None, :]) - 2.0 * _ordered_dot(qd, rows)
        v = torch.where(v.isnan(), inf, v)
        cols = torch.arange(lo, lo + rows.shape[0], dtype=torch.int64, device=dev)
        if fast:
            v = torch.where(v < 0.0, 0.0, v)
            key = ((v.view(torch.int32).to(torch.int64) << 32) | cols[None, :]).amin(dim=1)
            best_key = torch.minimum(best_key, key)
        else:
            tile_min = v.amin(dim=1)
            tile_arg = torch.where(v == tile_min[:, None], cols[None, :], nk).amin(dim=1)
            better = tile_min < best
            arg = torch.where(better, tile_arg, arg)
            best = torch.where(better, tile_min, best)
    if fast:
        arg = best_key & 0xFFFFFFFF
        row = arg.clamp(0, nk - 1)
        diff = queries - db[row]
        best = torch.where(db_mask[row], _sq_norms(diff), BIG)
    dist = torch.where(best < 0.0, 0.0, best)
    return torch.where(q_mask, dist, BIG), arg.to(torch.int32)


def split_geometry(nq: int, nk: int) -> Tuple[int, int]:
    """(splits, rows a split) of K7's grid: enough (128-query tile, database
    split) CTAs to fill the card, each split a whole number of 256-row
    tiles; the tensor-core scan takes 256 queries a CTA over the same
    splits."""
    q_tiles = max(1, -(-nq // _TQ))
    splits = max(1, min(-(-nk // _TK), -(-2048 // q_tiles)))
    return splits, -(-(-(-nk // splits)) // _TK) * _TK


# Below this many (query, row) pairs the exact mode at D = 10 takes the FP32
# scan: the tensor-core filter's memset, seed pass and per-CTA latency cost
# more than its scan saves there (PERF.md §6, the K7 exact row).
EXACT_SCAN_PAIRS = 1 << 24


def fp32_scan(nq: int, nk: int, d: int, fast: bool) -> bool:
    """Whether K7 takes the FP32 scan (one query a thread) rather than the
    tensor-core filter (csrc/best_match.cu): the fast mode past D = 16,
    which the filter's one k-chunk does not hold, and the exact mode at
    D = 10 on fewer than ``EXACT_SCAN_PAIRS`` pairs."""
    return d > 16 if fast else d == 10 and nq * nk < EXACT_SCAN_PAIRS


def best_match_cuda(queries, q_mask, db, db_mask, fast: bool = False, survivors=None):
    """Launch K7. queries (Q, D) and db (K, D) float32, masks bool, contiguous
    on one CUDA device; K >= 1, D <= 32. ``survivors``, a (1,) int64 tensor
    on the same device or None: the tensor-core scan adds to it the (query,
    row) pairs its filter could not rule out and rescored with the plain key,
    in either mode; the FP32 scan (``fp32_scan``) rescores nothing and leaves
    it alone."""
    nq, d = queries.shape
    nk = db.shape[0]
    dev = _lib.cuda_device(queries)
    if nk < 1 or d < 1 or d > 32:
        raise ValueError(f"best_match kernel takes K >= 1 and 1 <= D <= 32, got K={nk}, D={d}")
    _lib.check(queries, "queries", torch.float32, (nq, d), dev)
    _lib.check(q_mask, "q_mask", torch.bool, (nq,), dev)
    _lib.check(db, "db", torch.float32, (nk, d), dev)
    _lib.check(db_mask, "db_mask", torch.bool, (nk,), dev)
    if survivors is not None:
        _lib.check(survivors, "survivors", torch.int64, (1,), dev)
    splits, _ = split_geometry(nq, nk)
    part_key = torch.empty((splits, nq), dtype=torch.int64, device=dev)
    seed = (None if fp32_scan(nq, nk, d, fast)
            else torch.empty((nq,), dtype=torch.int32, device=dev))
    dist = torch.empty((nq,), dtype=torch.float32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    _lib.launch(
        "best_match_fast" if fast else "best_match", "vo_best_match", dev,
        *(t.data_ptr() for t in (queries, q_mask, db, db_mask, part_key)),
        *(None if t is None else t.data_ptr() for t in (seed, survivors)),
        *(t.data_ptr() for t in (dist, idx)), nq, nk, d, splits, int(fast),
    )
    return dist, idx


def best_match(queries, q_mask, db, db_mask, backend: str = "auto", fast: bool = False):
    """Top-1 database row per query -> (squared distance (Q,) float32, index
    (Q,) int32): first index wins ties, a masked row never wins (an all-masked
    database gives index 0), a masked query returns 3.4e38. With ``fast`` the
    selection runs on a bfloat16-rounded gram and the returned distance is
    the exact float32 one of the returned index."""
    _lib.tally("best_match_fast" if fast else "best_match", roofline.matcher_model,
               queries.shape[0], db.shape[0], queries.shape[1], "fast" if fast else "highest")
    if _lib.use_kernel(backend, queries):
        return best_match_cuda(queries, q_mask, db, db_mask, fast)
    return best_match_plain(queries, q_mask, db, db_mask, fast)
