"""Tiny fixed-size linear algebra, unrolled (port of visual_odometry_tpu.ops.linalg6).

For the SPD systems Gauss-Newton produces (H = sum w J^T J + damping * I) an
unrolled Cholesky is a few dozen scalar operations with no control flow. All
functions broadcast over leading batch dimensions; float32 throughout.
"""

from __future__ import annotations

import torch


def cholesky_solve(h: torch.Tensor, b: torch.Tensor, n: int = 6, eps: float = 1e-30) -> torch.Tensor:
    """Solve ``h x = b`` for SPD ``h`` of static size ``(..., n, n)``, unrolled.

    Equivalent to the reference's ``H.ldlt().solve(b)`` (picp_solver.cpp:109)
    for SPD H. ``eps`` guards the pivots so an all-masked (zero) system gives
    finite values instead of NaN.
    """
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = h[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp_min(s, eps))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, -1)


def solve_2x2(a00, a01, a11, b0, b1, eps: float = 1e-12):
    """Closed-form symmetric 2x2 solve; returns (x0, x1, det)."""
    det = a00 * a11 - a01 * a01
    safe = torch.where(det.abs() < eps, torch.ones_like(det), det)
    return (a11 * b0 - a01 * b1) / safe, (a00 * b1 - a01 * b0) / safe, det
