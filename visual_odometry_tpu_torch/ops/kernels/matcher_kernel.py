"""K1: both-direction top-1 appearance matches for a batch of frame pairs.

Replaces ``visual_odometry_tpu/ops/pallas/matcher_kernel.py:match_pairs_pallas``
with ``csrc/match_pairs.cu`` (see its header for the design: one CTA per pair,
FP32 pipes, descriptors in shared memory, bound by FP32 issue).

Distances use the gram form ``max((|a|^2 + |b|^2) - 2 a.b, 0)`` with every
dot product and squared norm summed in descriptor order from separately
rounded products, in the kernel and in :func:`pairwise_sq_dists` alike, so
the kernel and its plain version agree bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
    if _lib.use_kernel(backend, app1):
        return match_pairs_cuda(app1, mask1, app2, mask2)
    return match_pairs_plain(app1, mask1, app2, mask2)
