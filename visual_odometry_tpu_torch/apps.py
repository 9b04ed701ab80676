"""Command-line applications of the port (vo_complete and evaluation).

    python -m visual_odometry_tpu_torch.apps vo_complete <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps evaluation  <data_dir> [out_dir]

Output-file contract of the reference (README.md:56-68 there): vo_complete
writes world.txt, map.txt, map_appearances.txt, trajectory_gt.txt,
trajectory_est_complete.txt and trajectory_est_data.txt; evaluation writes
out_performance.txt, map_corrected.txt, arrows.txt and world_pruned.txt.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import default_device
from .models import pipeline
from .models.landmark_map import compact
from .ops.camera import Camera
from .utils import evaluation as eval_mod
from .utils import io
from .utils.config import DEFAULT_CONFIG, VOConfig


def run_vo_complete(
    data_dir: str,
    out_dir: str = ".",
    config: VOConfig = DEFAULT_CONFIG,
    verbose: bool = True,
    device=None,
):
    """Full VO with appearance-based DA (vo_complete.cpp:68-186), SE(3), one
    chunk, no refinement. ``device`` defaults to the CUDA card.

    Returns (trajectory (F, 4, 4) numpy, map, per-frame outputs, seconds).
    """
    config.check_supported()
    device = torch.device(device) if device is not None else default_device()
    os.makedirs(out_dir, exist_ok=True)
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    camera = Camera.create(params.camera_matrix, rows=params.height, cols=params.width,
                           z_near=params.z_near, z_far=params.z_far, device=device)
    seq = io.load_sequence(data_dir, config.n_slots)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))
    io.write_vectors(os.path.join(out_dir, "world.txt"), world_points)
    io.save_gt_trajectory(
        os.path.join(data_dir, "trajectory.dat"), os.path.join(out_dir, "trajectory_gt.txt")
    )

    # Inputs are staged on the device before the clock starts (loading is set-up).
    pts = torch.from_numpy(seq.points).to(device)
    apps = torch.from_numpy(seq.appearances).to(device)
    mask = torch.from_numpy(seq.mask).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    no_ids = torch.full_like(mask[0], -1, dtype=torch.int32)
    pipeline.check_bootstrap(config, pipeline.FrameData(pts[0], apps[0], mask[0], no_ids),
                             pipeline.FrameData(pts[1], apps[1], mask[1], no_ids))
    trajectory, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, mask)
    trajectory = trajectory.cpu().numpy()   # waits for the device
    elapsed = time.perf_counter() - t0

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m visual_odometry_tpu_torch.apps",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=("vo_complete", "evaluation"))
    p.add_argument("data_dir")
    p.add_argument("out_dir", nargs="?", default=".")
    p.add_argument("--device", default=None,
                   help="torch device for vo_complete (default: cuda, which must exist)")
    a = p.parse_args(argv)
    if a.command == "vo_complete":
        run_vo_complete(a.data_dir, a.out_dir, device=a.device)
    else:
        run_evaluation(a.data_dir, a.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
