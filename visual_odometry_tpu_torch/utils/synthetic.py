"""Synthetic scene generation (port of visual_odometry_tpu.utils.synthetic).

Inputs are drawn from an explicit ``numpy.random.Generator`` so both
packages can be fed the same numbers; geometry uses this package's
``se3``/``camera`` on CPU tensors and returns numpy arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import se3
from ..ops.camera import Camera, project_points

_K = np.array([[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def generate_appearances(rng: np.random.Generator, num_points: int, dim: int = 10) -> np.ndarray:
    """Unique random appearance descriptors (the dataset's landmark keys)."""
    return rng.uniform(-1.0, 1.0, (num_points, dim)).astype(np.float32)


def default_camera(world_in_camera=None, device="cpu") -> Camera:
    """The synthetic-test camera (initialization_test.cpp:51-57 K and sizes)."""
    return Camera.create(_K, world_in_camera, rows=480, cols=640, z_near=0, z_far=5,
                         device=device)


def deep_camera(world_in_camera=None, device="cpu") -> Camera:
    """The same K with a deep frustum (z_far=100) for tracking synthetic
    sequences: the monocular bootstrap rescales the map by 1/baseline, which
    puts triangulated depths far past z_far=5 on generic scenes."""
    return Camera.create(_K, world_in_camera, rows=480, cols=640, z_near=0, z_far=100.0,
                         device=device)


def generate_tracking_sequence(
    rng: np.random.Generator,
    num_frames: int,
    n_slots: int,
    seed_motion: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A trackable sequence: (points (F, S, 2), apps (F, S, D), masks (F, S)).

    A fixed landmark field observed by a camera on a bounded orbit with gentle
    periodic rotation, so every consecutive pair has the same real parallax
    and the field stays in view for any sequence length. Track it with
    :func:`deep_camera`.
    """
    world = np.stack(
        [
            rng.uniform(-1.5, 1.5, n_slots),
            rng.uniform(-1.2, 1.2, n_slots),
            rng.uniform(2.0, 4.0, n_slots),
        ],
        axis=1,
    ).astype(np.float32)
    apps = generate_appearances(rng, n_slots)
    world_t = torch.from_numpy(world)
    pts, masks = [], []
    for i in range(num_frames):
        ph = 2.0 * np.pi * i / 64.0
        v = seed_motion * np.float32(
            [
                0.3 * np.cos(ph),
                0.3 * np.sin(ph),
                0.1 * np.sin(2.0 * ph),
                0.02 * np.sin(ph),
                -0.02 * np.cos(ph),
                0.01 * np.sin(3.0 * ph),
            ]
        )
        pose = se3.v2t_euler(torch.from_numpy(np.asarray(v, np.float32)))
        uv, valid = project_points(default_camera(pose), world_t)
        pts.append(uv.numpy())
        masks.append(valid.numpy())
    return np.stack(pts), np.tile(apps[None], (num_frames, 1, 1)), np.stack(masks)
