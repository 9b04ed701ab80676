"""Masked point-set statistics (port of visual_odometry_tpu.ops.stats).

The reference's covariance helpers (eigen_covariance.h): mean, covariance and
the principal axis of a masked, padded point set, batched over leading dims.
"""

from __future__ import annotations

from typing import Tuple

import torch


def mean_and_covariance(points: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked sample mean and covariance of ``(..., N, D)`` points, with the
    1/(n-1) normalization of ``computeMeanAndCovariance`` (eigen_covariance.h:5-30)."""
    w = mask.to(points.dtype)
    n = w.sum(dim=-1)
    safe_n = torch.clamp_min(n, 1.0)
    mu = (points * w[..., None]).sum(dim=-2) / safe_n[..., None]
    centered = (points - mu[..., None, :]) * w[..., None]
    cov = torch.einsum("...ni,...nj->...ij", centered, centered)
    return mu, cov / torch.clamp_min(n - 1.0, 1.0)[..., None, None]


def largest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    """Principal axis of a symmetric ``(..., D, D)`` matrix (eigen_covariance.h:35-43):
    ``eigh`` orders eigenvalues ascending, so the last column."""
    return torch.linalg.eigh(cov).eigenvectors[..., :, -1]


def smallest_eigenvector(m: torch.Tensor) -> torch.Tensor:
    """``smallestEigenVector`` (utils.h:83-91)."""
    return torch.linalg.eigh(m).eigenvectors[..., :, 0]
