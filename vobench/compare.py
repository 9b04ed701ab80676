"""The comparison that decides ``correct``: the program's outputs of a call
against the reference's for the same sequences.

Each number is the worst over the call's sequences:

* ``boot_gap``: the bootstrap pose (P1), its rotation entries' largest
  absolute difference or its translation's distance over the reference
  translation's length, whichever is larger;
* ``pose_gap``: the same over every tracked frame's relative pose (K1-K4,
  K8), translations over the sequence's bootstrap translation length (the
  monocular scale);
* ``tri_gap``: every tracked frame's triangulation valid on both sides, the
  distance over the reference point's length;
* ``map_gap``: the folded map's slots live on both sides with the same key,
  the distance over the reference point's length;
* ``count_gap``: the largest difference of a frame's matches, solver
  correspondences or inliers, or of a map's entry count;
* ``mismatch``: triangulation flags, map flags and map keys that differ.

A NaN anywhere makes its number NaN, which no limit passes.
"""

from __future__ import annotations

import torch

NUMBERS = ("boot_gap", "pose_gap", "tri_gap", "map_gap", "count_gap", "mismatch")


def _max(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    if bool(torch.isnan(x).any()):
        return float("nan")
    return float(x.max())


def _pose_gap(p, r, scale):
    rot = (p[..., :3, :3] - r[..., :3, :3]).abs().flatten(-2).amax(-1)
    trans = torch.linalg.vector_norm(p[..., :3, 3] - r[..., :3, 3], dim=-1) / scale
    return torch.maximum(rot, trans)


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers above for one call: ``prog`` and ``ref`` hold the same
    sequences on a leading axis (``program.collect``, ``reference.vo.track``)."""
    dev = ref["trajectory"].device
    p = {k: v.to(dev) for k, v in prog.items()}
    r = ref
    f64 = torch.float64
    traj_p, traj_r = p["trajectory"].to(f64), r["trajectory"].to(f64)
    scale = torch.linalg.vector_norm(traj_r[:, 1, :3, 3], dim=-1)
    boot = _pose_gap(traj_p[:, 1], traj_r[:, 1], scale)
    poses = _pose_gap(traj_p[:, 2:], traj_r[:, 2:], scale[:, None])

    def point_gap(pp, rp, live):
        d = torch.linalg.vector_norm(pp.to(f64) - rp.to(f64), dim=-1)
        rel = d / torch.linalg.vector_norm(rp.to(f64), dim=-1).clamp_min(1e-30)
        return rel[live]

    tri_both = p["tri_valid"] & r["tri_valid"]
    keys_equal = (p["map_apps"].to(f64) == r["map_apps"].to(f64)).all(-1)
    map_both = p["map_valid"] & r["map_valid"] & keys_equal
    counts = torch.stack([
        (p[k].long() - r[k].long()).abs().amax() if p[k].numel() else torch.zeros((), device=dev,
                                                                                  dtype=torch.long)
        for k in ("num_matches", "num_solver_corr", "num_inliers", "map_count")])
    mismatch = ((p["tri_valid"] != r["tri_valid"]).sum()
                + (p["map_valid"] != r["map_valid"]).sum()
                + (p["map_valid"] & r["map_valid"] & ~keys_equal).sum())
    return {
        "boot_gap": _max(boot),
        "pose_gap": _max(poses),
        "tri_gap": _max(point_gap(p["tri_points"], r["tri_points"], tri_both)),
        "map_gap": _max(point_gap(p["map_points"], r["map_points"], map_both)),
        "count_gap": float(counts.max()),
        "mismatch": float(mismatch),
    }


def worst(readings) -> dict:
    """The worst of each number any of several calls' readings holds (NaN
    wins, and so does a number missing from a reading)."""
    out = {}
    for name in dict.fromkeys(k for g in readings for k in g):
        vals = [g.get(name, float("nan")) for g in readings]
        out[name] = float("nan") if any(v != v for v in vals) else max(vals, default=0.0)
    return out


def select(ref: dict, rows: range) -> dict:
    """The reference's outputs of the pool sequences ``rows``."""
    return {k: v[rows.start:rows.stop] for k, v in ref.items()}
