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


def generate_ba_corridor(
    f: int = 512,
    l: int = 100_000,
    obs_per_lm: int = 6,
    seed: int = 0,
    noise_lm: float = 0.02,
    noise_pose: float = 0.01,
    device="cpu",
):
    """Production-scale sparse-BA corridor problem, the same draws in the same
    order as the JAX package's generator.

    Cameras advance along +z at 0.2 a frame; landmark i becomes visible around
    camera ``i * f / l`` and is observed by the next ``obs_per_lm`` cameras,
    which gives about ``l * obs_per_lm`` observations whatever ``f`` is — the
    observation structure of a forward-moving VO sequence. The returned
    problem carries landmark and pose noise, so a BA step has real correction
    work. Returns (camera_matrix (3, 3) np.float32, SparseBAProblem on
    ``device``, live observation count).
    """
    from ..parallel import sparse_ba as sba

    rng = np.random.default_rng(seed)
    world = np.stack(
        [
            rng.uniform(-2.0, 2.0, l),
            rng.uniform(-1.5, 1.5, l),
            rng.uniform(0.0, 0.2 * f, l),
        ],
        axis=1,
    ).astype(np.float32)
    vs = np.zeros((f, 6), np.float32)
    vs[:, 2] = 0.2 * np.arange(f)  # t_z
    poses = se3.v2t_euler(torch.from_numpy(-vs)).numpy()

    # Cameras look +z from z = 0.2*i: each landmark is observed from the
    # obs_per_lm cameras ~1-2.2 units before it (all depths positive).
    first = np.clip((world[:, 2] / 0.2).astype(np.int64) - obs_per_lm - 5, 0, f - obs_per_lm)
    lm_idx = np.repeat(np.arange(l, dtype=np.int64), obs_per_lm)
    frame_idx = (np.repeat(first, obs_per_lm) + np.tile(np.arange(obs_per_lm), l)).astype(np.int64)

    pw = world[lm_idx]
    rp = poses[frame_idx]
    pc = np.einsum("nij,nj->ni", rp[:, :3, :3], pw) + rp[:, :3, 3]
    depth_ok = pc[:, 2] > 0.1
    uv = pc @ _K.T
    uv = uv[:, :2] / np.maximum(uv[:, 2:], 1e-6)
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
    mask = depth_ok & in_img

    noisy_lms = world + rng.normal(0, noise_lm, world.shape).astype(np.float32)
    # One uniform(6) draw per pose after the first, in pose order.
    dv = np.stack([rng.uniform(-noise_pose, noise_pose, 6).astype(np.float32)
                   for _ in range(1, f)]) if f > 1 else np.zeros((0, 6), np.float32)
    noisy_poses = poses.copy()
    noisy_poses[1:] = se3.v2t_euler(torch.from_numpy(dv)).numpy() @ poses[1:]

    def dev(x):
        return torch.from_numpy(x).to(device)

    problem = sba.SparseBAProblem(
        poses=dev(noisy_poses),
        landmarks=dev(noisy_lms),
        frame_idx=dev(frame_idx.astype(np.int32)),
        lm_idx=dev(lm_idx.astype(np.int32)),
        uv=dev(uv.astype(np.float32)),
        obs_mask=dev(mask),
    )
    return _K.copy(), problem, int(mask.sum())
