"""The traffic generator: a cell's pool of tracking sequences, made on the
device from the run's seed.

Written after ``visual_odometry_tpu_torch/utils/synthetic.py``
``generate_tracking_sequence`` at commit 9bfc263 (a landmark field with one
uniform(-1, 1) appearance row a landmark, projected through the camera), in
plain torch and vectorised over sequences and frames, with the scene sized by
the configuration's ``scene`` group instead of one landmark a slot:

* a field of ``landmarks`` landmarks, uniform in the box ``field``
  ([[x0, x1], [y0, y1], [z0, z1]]), each with an appearance row and a
  detector response, uniform in [0, 1);
* a camera path that sweeps the field: the centre moves by ``step`` a frame
  from ``start`` and wobbles by ``wobble`` (x, y, z, then the Euler angles
  of the camera-from-world rotation Rx Ry Rz) over ``period`` frames, so
  landmarks leave the view and new ones enter all along the sequence;
* each frame's slots hold the landmarks in view (inside the camera's depth
  range and ``edge_px`` pixels or more inside the image), the
  ``features_per_frame`` strongest by response, in that order; the other
  slots are masked and hold (-1, -1) and a zero appearance row;
* every measured pixel carries Gaussian noise of ``pixel_noise`` pixels,
  clamped into the image; appearances are exact, as the upstream data's are
  (its map merges by appearance equality).

The draws come from one ``torch.Generator`` on the device seeded with the
run's seed, in a few large calls: the same seed gives the same pool on the
same kind of device. The path does not depend on the seed, so every seed
gives the same sizes and arrivals.
"""

from __future__ import annotations

import math

import torch

BLOCK_ELEMENTS = 1 << 24   # landmark projections held at once


def _euler(a: torch.Tensor) -> torch.Tensor:
    """(F, 3) angles -> Rx(a0) Ry(a1) Rz(a2) (F, 3, 3)."""
    o, z = torch.ones_like(a[:, 0]), torch.zeros_like(a[:, 0])

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    c, s = torch.cos(a), torch.sin(a)
    rx = mat([[o, z, z], [z, c[:, 0], -s[:, 0]], [z, s[:, 0], c[:, 0]]])
    ry = mat([[c[:, 1], z, s[:, 1]], [z, o, z], [-s[:, 1], z, c[:, 1]]])
    rz = mat([[c[:, 2], -s[:, 2], z], [s[:, 2], c[:, 2], z], [z, z, o]])
    return rx @ ry @ rz


def path_poses(frames: int, scene: dict, device) -> torch.Tensor:
    """(F, 4, 4) float32 camera-from-world poses of the scene's path."""
    i = torch.arange(frames, dtype=torch.float64)
    ph = 2.0 * math.pi * i / float(scene["period"])
    w = torch.tensor(scene["wobble"], dtype=torch.float64)
    shape = torch.stack([torch.sin(ph), torch.sin(2.0 * ph), torch.cos(ph),
                         torch.sin(ph), torch.cos(2.0 * ph), torch.sin(3.0 * ph)], -1) * w
    centre = (torch.tensor(scene["start"], dtype=torch.float64)
              + i[:, None] * torch.tensor(scene["step"], dtype=torch.float64) + shape[:, :3])
    r = _euler(shape[:, 3:])
    pose = torch.zeros((frames, 4, 4), dtype=torch.float64)
    pose[:, :3, :3] = r
    pose[:, :3, 3] = -(r @ centre[:, :, None])[..., 0]
    pose[:, 3, 3] = 1.0
    return pose.to(device=device, dtype=torch.float32)


def _frames(world, apps, score, noise, poses, camera: dict, scene: dict, slots: int):
    """One block of sequences: world (b, L, 3), apps (b, L, D), score (b, L),
    noise (b, F, S, 2) -> (points (b, F, S, 2), appearances (b, F, S, D), masks (b, F, S)).
    The projection runs in the dtype of ``world`` and ``poses``; the points are float32."""
    k = torch.tensor(camera["camera_matrix"], dtype=world.dtype, device=world.device)
    r, t = poses[:, :3, :3], poses[:, :3, 3]
    p = torch.einsum("fij,blj->bfli", r, world) + t[None, :, None, :]
    hom = p @ k.T
    z = p[..., 2]
    uv = hom[..., :2] / torch.where(hom[..., 2:] == 0.0, torch.ones_like(hom[..., 2:]),
                                    hom[..., 2:])
    edge = float(scene["edge_px"])
    cols, rows = float(camera["cols"]), float(camera["rows"])
    seen = ((z >= camera["z_near"]) & (z <= camera["z_far"]) & (hom[..., 2] > 0.0)
            & (uv[..., 0] >= edge) & (uv[..., 0] <= cols - 1.0 - edge)
            & (uv[..., 1] >= edge) & (uv[..., 1] <= rows - 1.0 - edge))
    key = torch.where(seen, score[:, None, :], torch.full_like(z, -1.0, dtype=score.dtype))
    top, idx = key.topk(slots, dim=-1)                               # strongest first
    live = (top >= 0.0) & (torch.arange(slots, device=world.device)
                           < int(scene["features_per_frame"]))
    picked = torch.gather(uv, 2, idx[..., None].expand(*idx.shape, 2)).float() + noise
    lim = torch.tensor([cols - 1.0, rows - 1.0], dtype=torch.float32, device=world.device)
    picked = torch.minimum(picked.clamp_min(0.0), lim)
    points = torch.where(live[..., None], picked, torch.full_like(picked, -1.0))
    b, f = idx.shape[:2]
    rows_app = torch.gather(apps[:, None].expand(b, f, *apps.shape[1:]), 2,
                            idx[..., None].expand(*idx.shape, apps.shape[-1]))
    appearances = torch.where(live[..., None], rows_app, torch.zeros_like(rows_app))
    return points, appearances, live


def make_pool(sequences: int, frames: int, slots: int, appearance_dim: int, camera: dict,
              scene: dict, seed: int, device) -> dict:
    """``sequences`` tracking sequences of ``frames`` x ``slots`` from ``seed``:
    {"points": (N, F, S, 2) float32, "appearances": (N, F, S, D) float32,
    "masks": (N, F, S) bool}, contiguous on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n, lm = sequences, int(scene["landmarks"])
    box = torch.tensor(scene["field"], dtype=torch.float32, device=device)
    world = box[:, 0] + (box[:, 1] - box[:, 0]) * torch.rand((n, lm, 3), generator=gen,
                                                            device=device)
    apps = 2.0 * torch.rand((n, lm, appearance_dim), generator=gen, device=device) - 1.0
    score = torch.rand((n, lm), generator=gen, device=device)
    noise = float(scene["pixel_noise"]) * torch.randn((n, frames, slots, 2), generator=gen,
                                                      device=device)
    poses = path_poses(frames, scene, device)
    step = max(1, BLOCK_ELEMENTS // (frames * lm))
    parts = [_frames(world[i:i + step], apps[i:i + step], score[i:i + step],
                     noise[i:i + step], poses, camera, scene, slots)
             for i in range(0, n, step)]
    points, appearances, masks = (torch.cat([p[j] for p in parts]) for j in range(3))
    return {"points": points.contiguous(), "appearances": appearances.contiguous(),
            "masks": masks.contiguous()}


def occupancy(pool: dict) -> dict:
    """What the pool's sequences hold: live slots a frame (mean, least, most)."""
    live = pool["masks"].sum(-1).double()
    return {"live_slots_mean": float(live.mean()), "live_slots_min": int(live.min()),
            "live_slots_max": int(live.max())}
