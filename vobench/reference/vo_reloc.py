"""Plain reference of map-scale relocalization, as
``visual_odometry_tpu_torch`` defines it at commit 909746c
(``models/pipeline.relocalize_frame``), written again from its semantics,
batched over query frames, in float64 by default:

1. each live slot's nearest live map row by squared appearance distance
   (first row on ties), walked over the map in blocks;
2. a slot matches where that distance is under the strict radius (d^2 <
   r^2, r^2 rounded in float32);
3. the matched rows' points and the slots' measurements feed ``vo``'s
   damped Gauss-Newton solve, started from the frame's prior: the points are
   moved into the prior's camera frame, solved from the identity there, and
   the solution composed with the prior (the solve's left-multiplied update
   makes the two the same iteration).

``track`` reads the pool the benchmark made (``generators/reloc.py``) and
takes nothing of the program. ``gaps`` computes the two numbers compared,
``pose_gap`` and ``count_gap``.
"""

from __future__ import annotations

import torch

from vobench.reference import vo

_BLOCK = 1 << 27   # distances held at once


def nearest(queries, q_mask, rows, row_valid, dtype):
    """(Q, D) queries against (K, D) rows: (squared distance (Q,), row (Q,)),
    the first row on ties; a masked query or an all-masked map gives +inf."""
    q = queries.to(dtype)
    qn = (q * q).sum(-1)
    best = torch.full((q.shape[0],), float("inf"), dtype=dtype, device=q.device)
    arg = torch.zeros((q.shape[0],), dtype=torch.long, device=q.device)
    step = max(1, _BLOCK // max(1, q.shape[0]))
    for lo in range(0, rows.shape[0], step):
        live = row_valid[lo:lo + step]
        r = torch.where(live[:, None], rows[lo:lo + step], 0.0).to(dtype)
        rn = torch.where(live, (r * r).sum(-1), float("inf"))
        d = (qn[:, None] + rn[None, :]) - 2.0 * (q @ r.T)
        d_min, d_arg = d.min(dim=1)   # the first minimum
        better = d_min < best
        best = torch.where(better, d_min, best)
        arg = torch.where(better, d_arg + lo, arg)
    return torch.where(q_mask, best.clamp_min(0.0), float("inf")), arg


def track(points, appearances, masks, vo_cfg: dict, cam: dict, dtype=torch.float64, *,
          map_points, map_appearances, map_valid, priors) -> dict:
    """N query frames (N, 1, S, ...) against the map: {"pose" (N, 4, 4)
    camera-from-map, "num_matches" (N,), "num_inliers" (N,) of the last GN
    round, "rounds" (N,)}."""
    n, _, s, _ = points.shape
    dev = points.device
    k_mat = torch.tensor(cam["camera_matrix"], dtype=torch.float64, device=dev).to(dtype)
    r2 = float(torch.tensor(float(vo_cfg["match_radius"]), dtype=torch.float32) ** 2)
    apps, masks_f = appearances[:, 0], masks[:, 0]
    dist, idx = nearest(apps.reshape(n * s, -1), masks_f.reshape(-1), map_appearances,
                        map_valid, dtype)
    matched = (masks_f.reshape(-1) & (dist < r2)).reshape(n, s)
    prior = priors.to(dtype)
    world = map_points.to(dtype)[idx].reshape(n, s, 3)
    moved = world @ prior[:, :3, :3].transpose(1, 2) + prior[:, None, :3, 3]
    moved = torch.where(matched[..., None], moved, torch.ones_like(moved))
    meas = torch.where(matched[..., None], points[:, 0].to(dtype), torch.zeros_like(moved[..., :2]))
    solved, inliers, rounds = vo.gauss_newton(k_mat, cam, vo_cfg, moved, meas, matched.to(dtype))
    return {"pose": solved @ prior, "num_matches": matched.sum(-1), "num_inliers": inliers,
            "rounds": rounds}


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of one call's frames, each the worst over them:

    * ``pose_gap``: the rotation entries' largest absolute difference, or the
      distance between the two camera centres in map metres, whichever is
      larger;
    * ``count_gap``: the largest difference of a frame's matches or of its
      last GN round's inliers.

    A NaN makes its number NaN, which no limit passes."""
    dev = ref["pose"].device
    f64 = torch.float64
    p, r = prog["pose"].to(dev, f64), ref["pose"].to(f64)
    rot = (p[:, :3, :3] - r[:, :3, :3]).abs().flatten(1).amax(1)

    def centre(x):
        return -(x[:, :3, :3].transpose(1, 2) @ x[:, :3, 3:])[..., 0]

    dist = torch.linalg.vector_norm(centre(p) - centre(r), dim=-1)
    pose = torch.maximum(rot, dist)
    counts = torch.stack([(prog[k].to(dev).long() - ref[k].long()).abs()
                          for k in ("num_matches", "num_inliers")])
    return {"pose_gap": float("nan") if bool(pose.isnan().any()) else float(pose.max()),
            "count_gap": float(counts.max())}
