"""Command-line applications of the port.

    python -m visual_odometry_tpu_torch.apps vo_complete <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps vo_se2      <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps vo_daknown  <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps relocalize  <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps evaluation  <data_dir> [out_dir]

Output-file contract of the reference (README.md:56-68 there): vo_complete
and vo_se2 write world.txt, map.txt, map_appearances.txt, trajectory_gt.txt,
trajectory_est_complete.txt and trajectory_est_data.txt; vo_daknown writes
trajectory_est_noWorld.txt, trajectory_est_data.txt and time_known.txt;
relocalize writes relocalization.txt; evaluation writes out_performance.txt,
map_corrected.txt, arrows.txt and world_pruned.txt.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from . import default_device
from .models import pipeline, refinement
from .models.landmark_map import compact
from .models.refinement import absolute_from_relative
from .ops.camera import Camera
from .utils import evaluation as eval_mod
from .utils import io
from .utils.config import DEFAULT_CONFIG, VOConfig
from .utils.profiling import StageTimer


def _load(data_dir: str, config: VOConfig, device):
    """(camera parameters, camera on ``device``, the padded sequence as numpy)."""
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    camera = Camera.create(params.camera_matrix, rows=params.height, cols=params.width,
                           z_near=params.z_near, z_far=params.z_far, device=device)
    return params, camera, io.load_sequence(data_dir, config.n_slots)


def _stage(seq, device):
    """The sequence's tensors on ``device``, there before any clock starts
    (loading is set-up): points, appearances, mask, ids."""
    out = tuple(torch.from_numpy(x).to(device)
                for x in (seq.points, seq.appearances, seq.mask, seq.ids))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _check_bootstrap(config: VOConfig, pts, apps, mask, ids, use_known_da: bool = False):
    """Guard the first frame pair (pipeline.check_bootstrap): raises
    BootstrapError on < 8 correspondences and warns on a degenerate pair."""
    return pipeline.check_bootstrap(
        config, pipeline.FrameData(pts[0], apps[0], mask[0], ids[0]),
        pipeline.FrameData(pts[1], apps[1], mask[1], ids[1]), use_known_da)


def run_vo_complete(
    data_dir: str,
    out_dir: str = ".",
    config: VOConfig = DEFAULT_CONFIG,
    verbose: bool = True,
    device=None,
):
    """Full VO with appearance-based DA (vo_complete.cpp:68-186), one chunk;
    SE(3), or planar when ``config.planar``. With ``config.refine_iterations
    > 0`` the tracked trajectory and map are bundle-adjusted before they are
    written (``models/refinement``: ``refine_backend`` ``dense`` or
    ``sparse``), outside the timed tracking. ``device`` defaults to the CUDA
    card.

    Returns (trajectory (F, 4, 4) numpy, map, per-frame outputs, seconds).
    """
    config.check_supported()
    device = torch.device(device) if device is not None else default_device()
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config, device)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))
    io.write_vectors(os.path.join(out_dir, "world.txt"), world_points)
    io.save_gt_trajectory(
        os.path.join(data_dir, "trajectory.dat"), os.path.join(out_dir, "trajectory_gt.txt")
    )

    pts, apps, mask, ids = _stage(seq, device)

    t0 = time.perf_counter()
    _check_bootstrap(config, pts, apps, mask, ids)
    trajectory, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, mask)
    trajectory = trajectory.cpu().numpy()   # waits for the device
    elapsed = time.perf_counter() - t0

    if config.refine_iterations > 0:
        refine = (refinement.refine_trajectory_sparse if config.refine_backend == "sparse"
                  else refinement.refine_trajectory)
        trajectory, map_pts, map_apps, _ = refine(
            params.camera_matrix, trajectory, map_state, seq.points, seq.appearances, seq.mask,
            num_iterations=config.refine_iterations, damping=config.refine_damping,
            kernel_threshold=config.kernel_threshold, device=device)
    else:
        map_pts, map_apps = compact(map_state)
    h = params.cam_in_robot
    map_robot = map_pts @ h[:3, :3].T + h[:3, 3]       # map = H * map (vo_complete.cpp:181)
    io.write_vectors(os.path.join(out_dir, "map.txt"), map_robot)
    io.write_vectors(os.path.join(out_dir, "map_appearances.txt"), map_apps)
    io.save_trajectory(os.path.join(out_dir, "trajectory_est_complete.txt"), trajectory, h)
    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_data.txt"), trajectory, h, save_rotation=True
    )
    if verbose:
        f = len(trajectory)
        print(f"tracked {f} frames in {elapsed:.3f}s ({f / elapsed:.1f} frames/s) on {device}")
        print(f"map landmarks: {len(map_pts)}")
    return trajectory, map_state, outs, elapsed


def run_vo_se2(data_dir: str, out_dir: str = ".", config: Optional[VOConfig] = None,
               verbose: bool = True, device=None):
    """Full VO with the estimation constrained to SE(2) in the robot plane
    (the reference's ``est_SE2`` branch): :func:`run_vo_complete` with the
    per-frame solve on the 3-DoF planar solver (kernel K5 on the card)
    conjugated by the camera mount of ``camera.dat``, and the two-view init
    planarized. Same output files, so ``evaluation`` works unchanged."""
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    config = (config or DEFAULT_CONFIG).with_planar_mount(params.cam_in_robot)
    return run_vo_complete(data_dir, out_dir, config, verbose, device)


def run_vo_da_known(data_dir: str, out_dir: str = ".", config: Optional[VOConfig] = None,
                    verbose: bool = True, device=None):
    """VO with ground-truth data association (vo_daKnown.cpp): the landmark
    ids of the measurement files instead of the appearance matcher, and the
    reference's 1000 GN iterations per frame (vo_daKnown.cpp:149-150). Writes
    ``trajectory_est_noWorld.txt``, ``trajectory_est_data.txt`` and the
    per-frame association times ``time_known.txt``.

    Returns (trajectory (F, 4, 4) numpy, per-frame outputs, seconds)."""
    if config is None:
        config = DEFAULT_CONFIG.replace(gn_iterations=1000)
    config.check_supported()
    device = torch.device(device) if device is not None else default_device()
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config, device)
    pts, apps, mask, ids = _stage(seq, device)

    _check_bootstrap(config, pts, apps, mask, ids, use_known_da=True)
    t0 = time.perf_counter()
    trajectory, _, outs = pipeline.run_sequence_known_da(camera, config, pts, apps, mask, ids)
    trajectory = trajectory.cpu().numpy()   # waits for the device
    elapsed = time.perf_counter() - t0

    # Per-frame DA timing (vo_daKnown.cpp:127-129, 163-164). Tracking matches
    # all pairs in one batch, so the times come from a per-frame run of the
    # id matcher.
    timer = StageTimer()
    pipeline.match_by_ids(ids[0], mask[0], ids[1], mask[1])   # warm-up
    for k in range(1, len(trajectory)):
        with timer.stage("da", sync_on=mask):
            pipeline.match_by_ids(ids[k - 1], mask[k - 1], ids[k], mask[k])
    timer.dump(os.path.join(out_dir, "time_known.txt"), "da")

    h = params.cam_in_robot
    io.save_trajectory(os.path.join(out_dir, "trajectory_est_noWorld.txt"), trajectory, h)
    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_data.txt"), trajectory, h, save_rotation=True
    )
    if verbose:
        f = len(trajectory)
        print(f"tracked {f} frames (known DA) in {elapsed:.3f}s ({f / elapsed:.1f} frames/s) "
              f"on {device}")
    return trajectory, outs, elapsed


def run_relocalize(data_dir: str, out_dir: str = ".", config: VOConfig = DEFAULT_CONFIG,
                   every: int = 10, verbose: bool = True, device=None):
    """Map-scale re-localization sweep: track the sequence (building the
    landmark map), then re-localize every ``every``-th frame against the whole
    map (pipeline.relocalize_frame: kernels K7 and K6 on the card) with the
    previous absolute pose as prior. Writes ``relocalization.txt``: frame,
    position error against the tracked absolute pose, orientation error,
    matches, inliers. Returns those rows."""
    config.check_supported()
    device = torch.device(device) if device is not None else default_device()
    os.makedirs(out_dir, exist_ok=True)
    _, camera, seq = _load(data_dir, config, device)
    pts, apps, mask, ids = _stage(seq, device)
    _check_bootstrap(config, pts, apps, mask, ids)
    trajectory, map_state, _ = pipeline.run_sequence(camera, config, pts, apps, mask)
    absolute = absolute_from_relative(trajectory.cpu().numpy())

    rows = []
    no_ids = torch.full_like(ids[0], -1)
    for f in range(every, len(absolute), every):
        frame = pipeline.FrameData(pts[f], apps[f], mask[f], no_ids)
        pose, stats, n_matches = pipeline.relocalize_frame(
            camera, config, map_state, frame, torch.from_numpy(absolute[f - 1]).to(device))
        pose = pose.cpu().numpy()
        err_t = float(np.linalg.norm(pose[:3, 3] - absolute[f][:3, 3]))
        err_r = float(np.trace(np.eye(3) - pose[:3, :3].T @ absolute[f][:3, :3]))
        rows.append((f, err_t, err_r, int(n_matches), int(stats.num_inliers)))
    with open(os.path.join(out_dir, "relocalization.txt"), "w") as fh:
        for r in rows:
            fh.write(f"{r[0]} {r[1]:.6f} {r[2]:.6e} {r[3]} {r[4]}\n")
    if verbose:
        errs = np.array([r[1] for r in rows])
        print(f"relocalized {len(rows)} frames on {device}: median pos err "
              f"{np.median(errs):.4f}, max {errs.max():.4f}")
    return rows


def run_evaluation(data_dir: str, out_dir: str = ".", verbose: bool = True):
    """Offline metrics (evaluate.cpp), reading the files run_vo_complete wrote."""
    _, gt_xyt = io.load_trajectory(os.path.join(data_dir, "trajectory.dat"))
    gt_poses = io.gt_poses_se3(gt_xyt)
    est_poses = io.load_est_trajectory(os.path.join(out_dir, "trajectory_est_data.txt"))
    map_est = np.loadtxt(os.path.join(out_dir, "map.txt"), ndmin=2, dtype=np.float32)
    map_apps = np.loadtxt(os.path.join(out_dir, "map_appearances.txt"), ndmin=2, dtype=np.float32)
    _, world_points, world_apps = io.load_world(os.path.join(data_dir, "world.dat"))

    res = eval_mod.evaluate(est_poses, gt_poses, map_est, map_apps, world_points, world_apps)

    perf = np.stack([res.orientation_errors, res.ratios], axis=1)
    np.savetxt(os.path.join(out_dir, "out_performance.txt"), perf, fmt="%g")
    io.write_vectors(os.path.join(out_dir, "map_corrected.txt"), map_est * res.scale)
    mi, wi = eval_mod.match_map_to_world(map_est, map_apps, world_points, world_apps)
    arrows = np.concatenate([map_est[mi] * res.scale, world_points[wi]], axis=1)
    io.write_vectors(os.path.join(out_dir, "arrows.txt"), arrows)
    io.write_vectors(os.path.join(out_dir, "world_pruned.txt"), world_points[wi])

    if verbose:
        finite = np.isfinite(res.orientation_errors)
        print(f"ratio used for map correction: {res.scale}")
        print(f"orientation error mean: {np.abs(res.orientation_errors[finite]).mean()}")
        print(f"RMSE position: {res.rmse_position}")
        print(f"RMSE map: {res.rmse_map}  ({res.n_map_matched} landmarks matched)")
    return res


_COMMANDS = {"vo_complete": run_vo_complete, "vo_se2": run_vo_se2,
             "vo_daknown": run_vo_da_known, "relocalize": run_relocalize}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m visual_odometry_tpu_torch.apps",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=tuple(_COMMANDS) + ("evaluation",))
    p.add_argument("data_dir")
    p.add_argument("out_dir", nargs="?", default=".")
    p.add_argument("--device", default=None,
                   help="torch device of the tracking commands (default: cuda, which must exist)")
    a = p.parse_args(argv)
    if a.command == "evaluation":
        run_evaluation(a.data_dir, a.out_dir)
    else:
        _COMMANDS[a.command](a.data_dir, a.out_dir, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
