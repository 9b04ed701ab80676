"""Figures of the pipeline's output files (port of visual_odometry_tpu.utils.plots).

The reference draws three gnuplot figures from its ``*.txt`` outputs
(README.md:85-113 there); the file contract is the same here, so those
recipes still work, and this module renders the same three with matplotlib
(Agg), with no gnuplot needed:

  * :func:`plot_trajectories` — ground-truth against estimated trajectory
    (3-D scatter), the ``trajectories_SE3.png`` figure;
  * :func:`plot_map` — true world against the corrected map, with match
    segments and the ground-truth trajectory, the ``points_SE3.png`` figure;
  * :func:`plot_performance` — per-frame orientation error and translation
    ratio, the ``errors_SE3.png`` figure (the ratio has gaps where the robot
    stands still, README.md:113 there).

Each reads the files ``apps.run_vo_complete`` and ``apps.run_evaluation``
write and saves a PNG beside them. numpy and matplotlib only.
"""

from __future__ import annotations

import os

import numpy as np


def _load(out_dir: str, name: str) -> np.ndarray:
    return np.loadtxt(os.path.join(out_dir, name), ndmin=2, dtype=np.float64)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(out_dir: str, filename: str = "trajectories.png") -> str:
    """gt vs estimated trajectory — README.md:88-91's splot."""
    plt = _mpl()
    gt = _load(out_dir, "trajectory_gt.txt")
    est = _load(out_dir, "trajectory_est_complete.txt")
    fig = plt.figure(figsize=(7, 5.5))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(gt[:, 0], gt[:, 1], gt[:, 2], s=6, label="ground truth")
    ax.scatter(est[:, 0], est[:, 1], est[:, 2], s=6, label="estimated")
    ax.legend()
    ax.set_title("trajectories")
    path = os.path.join(out_dir, filename)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_map(out_dir: str, filename: str = "points.png") -> str:
    """world vs corrected map with correspondence segments — README.md:97-99."""
    plt = _mpl()
    world = _load(out_dir, "world_pruned.txt")
    corrected = _load(out_dir, "map_corrected.txt")
    arrows = _load(out_dir, "arrows.txt")
    gt = _load(out_dir, "trajectory_gt.txt")
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(world[:, 0], world[:, 1], world[:, 2], s=4, label="true")
    ax.scatter(corrected[:, 0], corrected[:, 1], corrected[:, 2], s=4, label="corrected")
    for row in arrows:
        ax.plot([row[0], row[3]], [row[1], row[4]], [row[2], row[5]],
                lw=0.4, color="gray", alpha=0.6)
    ax.scatter(gt[:, 0], gt[:, 1], gt[:, 2], s=10, label="gt trajectory")
    ax.legend()
    ax.set_title("map vs world")
    path = os.path.join(out_dir, filename)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_performance(out_dir: str, filename: str = "errors.png") -> str:
    """orientation error + translation ratio per frame — README.md:106-108."""
    plt = _mpl()
    perf = _load(out_dir, "out_performance.txt")
    fig, ax = plt.subplots(figsize=(6.5, 4.9))
    ax.plot(perf[:, 0], label="orientation", lw=1)
    ratio = perf[:, 1].copy()
    ratio[~np.isfinite(ratio)] = np.nan  # stationary frames: gt norm 0
    ax.plot(ratio, label="ratio", lw=1)
    ax.set_xlabel("frame")
    ax.legend()
    ax.set_title("relative-pose errors")
    path = os.path.join(out_dir, filename)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_all(out_dir: str) -> list:
    """Render every figure whose input files exist in ``out_dir``."""
    done = []
    for fn, needs in (
        (plot_trajectories, ("trajectory_gt.txt", "trajectory_est_complete.txt")),
        (plot_map, ("world_pruned.txt", "map_corrected.txt", "arrows.txt", "trajectory_gt.txt")),
        (plot_performance, ("out_performance.txt",)),
    ):
        if all(os.path.exists(os.path.join(out_dir, n)) for n in needs):
            done.append(fn(out_dir))
    return done
