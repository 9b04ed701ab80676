"""Synthetic dataset generator in the reference on-disk format
(port of visual_odometry_tpu.utils.dataset_gen).

Writes ``meas-XXXXX.dat``, ``world.dat``, ``camera.dat`` and
``trajectory.dat``: a robot driving a planar arc with the camera looking out
through the standard cam-in-robot transform, landmarks carrying unique random
appearance vectors observed verbatim.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.camera import Camera, project_points

CAM_IN_ROBOT = np.array(
    [[0, 0, 1, 0.2], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32
)
K = np.array([[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def generate_dataset(
    out_dir: str,
    num_frames: int = 60,
    num_landmarks: int = 500,
    seed: int = 0,
    odom_noise: float = 0.002,
    arc_rate: float = 0.02,
    step: float = 0.15,
) -> None:
    """Write a complete synthetic dataset to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    world = np.stack(
        [
            rng.uniform(-2.0, 12.0, num_landmarks),
            rng.uniform(-6.0, 6.0, num_landmarks),
            rng.uniform(0.2, 2.0, num_landmarks),
        ],
        axis=1,
    ).astype(np.float32)
    appearances = rng.uniform(-1.0, 1.0, (num_landmarks, 10)).astype(np.float32)

    with open(os.path.join(out_dir, "world.dat"), "w") as f:
        for i in range(num_landmarks):
            vals = " ".join(f"{v:g}" for v in [*world[i], *appearances[i]])
            f.write(f"{i} {vals}\n")

    with open(os.path.join(out_dir, "camera.dat"), "w") as f:
        f.write("camera matrix:\n")
        for r in range(3):
            f.write(" ".join(f"{v:g}" for v in K[r]) + "\n")
        f.write("cam_transform:\n")
        for r in range(4):
            f.write(" ".join(f"{v:g}" for v in CAM_IN_ROBOT[r]) + "\n")
        f.write("z_near: 0\nz_far:  5\nwidth:  640\nheight: 480\n")

    gt = np.zeros((num_frames, 3), np.float32)   # x, y, theta
    odom = np.zeros((num_frames, 3), np.float32)
    x = y = th = 0.0
    for i in range(1, num_frames):
        th += arc_rate
        x += step * np.cos(th)
        y += step * np.sin(th)
        gt[i] = (x, y, th)
        odom[i] = gt[i] + rng.normal(0, odom_noise, 3)

    with open(os.path.join(out_dir, "trajectory.dat"), "w") as f:
        for i in range(num_frames):
            f.write(
                f"{i} {odom[i,0]:g} {odom[i,1]:g} {odom[i,2]:g} "
                f"{gt[i,0]:g} {gt[i,1]:g} {gt[i,2]:g}\n"
            )

    icir = np.linalg.inv(CAM_IN_ROBOT)
    world_t = torch.from_numpy(world)
    for i in range(num_frames):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        robot = np.array(
            [[c, -s, 0, gt[i, 0]], [s, c, 0, gt[i, 1]], [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float32,
        )
        world_in_cam = icir @ np.linalg.inv(robot)
        cam = Camera.create(K, world_in_cam, rows=480, cols=640, z_near=0, z_far=5)
        uv, valid = project_points(cam, world_t)
        uv, valid = uv.numpy(), valid.numpy()
        with open(os.path.join(out_dir, f"meas-{i:05d}.dat"), "w") as f:
            f.write(f"seq: {i}\n")
            f.write(f"gt_pose: {gt[i,0]:g} {gt[i,1]:g} {gt[i,2]:g}\n")
            f.write(f"odom_pose: {odom[i,0]:g} {odom[i,1]:g} {odom[i,2]:g}\n")
            n = 0
            for j in range(num_landmarks):
                if not valid[j]:
                    continue
                vals = " ".join(f"{v:g}" for v in [uv[j, 0], uv[j, 1], *appearances[j]])
                f.write(f"point {n} {j} {vals}\n")
                n += 1

