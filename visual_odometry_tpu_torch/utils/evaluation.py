"""Offline trajectory / map evaluation (a numpy copy of
visual_odometry_tpu.utils.evaluation).

Host-side re-design of the ``evaluation`` app
(``/root/reference/src/apps/evaluate.cpp``) with identical metric
definitions (README.md:33-50; SURVEY.md §6):

  * relative pose error per consecutive pair: ``X_rel = X_prev⁻¹ X_curr``,
    orientation error ``e_θ = trace(I₃ − R_relᵀ R_rel,gt)``
    (evaluate.cpp:24-36);
  * translation ratio ``r_t = ||t_rel|| / ||t_rel,gt||`` (evaluate.cpp:37);
  * monocular scale correction = 1 / median(r_t) — the reference's
    ``median`` is ``nth_element`` at n/2, i.e. the UPPER median
    (evaluation_utils.cpp:65-70), reproduced exactly;
  * RMSE over positions with scaled estimates, over ALL poses
    (evaluate.cpp:46-53);
  * map RMSE over landmarks matched by EXACT appearance equality
    (evaluate.cpp:71-86).

Stationary frames give ``||t_gt|| = 0`` => inf/nan ratios; the median is
robust to them by construction (README.md:113).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class EvaluationResult:
    orientation_errors: np.ndarray  # (F-1,)
    ratios: np.ndarray              # (F-1,)
    scale: float                    # 1 / median(ratio)
    rmse_position: float
    rmse_map: Optional[float]
    n_map_matched: int


def upper_median(v: np.ndarray) -> float:
    """nth_element-at-n/2 median (evaluation_utils.cpp:65-70)."""
    v = np.asarray(v, np.float32).copy()
    n = len(v) // 2
    return float(np.partition(v, n)[n])


def relative_errors(est: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair orientation error and translation ratio (evaluate.cpp:24-38).

    Args: (F, 4, 4) absolute pose arrays (robot frame).
    """
    e_prev, e_curr = est[:-1], est[1:]
    g_prev, g_curr = gt[:-1], gt[1:]

    def rel(a, b):
        r = np.swapaxes(a[:, :3, :3], 1, 2)
        t = (b[:, :3, 3] - a[:, :3, 3])[..., None]
        return np.einsum("fij,fjk->fik", r, b[:, :3, :3]), (r @ t)[..., 0]

    r_rel, t_rel = rel(e_prev, e_curr)
    r_rel_gt, t_rel_gt = rel(g_prev, g_curr)
    err = np.eye(3) - np.einsum("fji,fjk->fik", r_rel, r_rel_gt)
    orient = np.trace(err, axis1=1, axis2=2).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (
            np.linalg.norm(t_rel, axis=1) / np.linalg.norm(t_rel_gt, axis=1)
        ).astype(np.float32)
    return orient, ratio


def match_map_to_world(
    map_points: np.ndarray,
    map_appearances: np.ndarray,
    world_points: np.ndarray,
    world_appearances: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pair map and world landmarks by exact appearance equality.

    Replaces the O(map x world) scan of evaluate.cpp:74-84 with a hash join
    on the raw appearance bytes (identical result: appearances are unique
    keys and equality is bitwise for carried-verbatim floats).
    """
    world_by_key = {}
    for j in range(len(world_appearances)):
        world_by_key.setdefault(world_appearances[j].tobytes(), j)
    pairs_m, pairs_w = [], []
    for i in range(len(map_appearances)):
        j = world_by_key.get(map_appearances[i].tobytes())
        if j is not None:
            pairs_m.append(i)
            pairs_w.append(j)
    return np.asarray(pairs_m, np.int64), np.asarray(pairs_w, np.int64)


def evaluate(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    map_points: Optional[np.ndarray] = None,
    map_appearances: Optional[np.ndarray] = None,
    world_points: Optional[np.ndarray] = None,
    world_appearances: Optional[np.ndarray] = None,
) -> EvaluationResult:
    """Full evaluation (evaluate.cpp:24-88)."""
    orient, ratio = relative_errors(est_poses, gt_poses)
    scale = 1.0 / upper_median(ratio)

    diff = gt_poses[:, :3, 3] - est_poses[:, :3, 3] * scale
    rmse_pos = float(np.sqrt(np.mean(np.sum(diff**2, axis=1))))

    rmse_map, n_matched = None, 0
    if map_points is not None and world_points is not None:
        mi, wi = match_map_to_world(
            map_points, map_appearances, world_points, world_appearances
        )
        n_matched = len(mi)
        if n_matched:
            d = map_points[mi] * scale - world_points[wi]
            rmse_map = float(np.sqrt(np.mean(np.sum(d**2, axis=1))))

    return EvaluationResult(
        orientation_errors=orient,
        ratios=ratio,
        scale=scale,
        rmse_position=rmse_pos,
        rmse_map=rmse_map,
        n_map_matched=n_matched,
    )
