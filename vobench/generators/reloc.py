"""Traffic generator of map-scale relocalization: a prior map of a city
centre's street façades and a pool of query frames taken in its streets,
each with a pose prior, made on the device from the run's seed.

The scene group of the configuration sets:

* the streets: a grid of ``streets_per_axis`` streets along x and as many
  along z, evenly spaced over a square of side ``extent`` centred on the
  origin (the map's coordinates are centred, as a reconstruction's are once
  its centroid is taken out), each as long as the square;
* ``landmarks`` landmarks, an equal share a street, on the façade on one
  side of it: uniform along the street, in height in ``facade[0]`` and in
  depth from the street's line in ``facade[1]`` (``vobench/generator.py``'s
  hall cross-section), each with an appearance row uniform in [-1, 1) and a
  detector response uniform in [0, 1), as ``vobench/generator.py`` draws
  them;
* the map: ``mapped`` of them, chosen and ordered by a permutation drawn from
  the seed, in the first rows of a map of ``map_rows`` rows (the
  configuration's ``map_capacity``) with their points and appearance rows;
  the rows past them are dead (``valid`` False, zero points and +inf keys, as
  the program's empty map holds). The landmarks left out are those the scene
  gained since it was mapped;
* one query frame a pool item: a camera on a street drawn from the seed, at a
  place along it uniform over its length less ``street_margin`` at each
  end, facing the façade, with ``vobench/generator.py``'s wobble (``wobble``,
  the same six amplitudes) at a phase drawn from the seed; its slots hold the
  ``features_per_frame`` strongest landmarks in view (inside the camera's
  depth range and ``edge_px`` pixels or more inside the image), mapped or
  not, with ``pixel_noise`` pixels of Gaussian noise, clamped into the image,
  and each appearance row moved by Gaussian noise of ``appearance_noise`` a
  component, so that no query row equals its map row; the other slots are
  masked, hold (-1, -1) and a zero appearance row;
* a prior a query: its camera-from-world pose composed on the left with a
  rotation of up to ``prior_rotation_deg`` degrees about a uniform axis and a
  translation of up to ``prior_translation`` in a uniform direction, both
  uniform in size, so the camera's centre moves by that much.

The landmarks in view are found by projecting every landmark, in blocks of
queries, in float64 (``vobench/generator.py``'s projection). Every seed gives
the same sizes: the same map rows, the same number of query frames and slots,
the views full wherever the queries stand.
"""

from __future__ import annotations

import math

import torch

from vobench import generator

BLOCK_ELEMENTS = 1 << 22   # landmark projections held at once


def _rotations(axis_angle: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis times angle -> (N, 3, 3) by Rodrigues' formula."""
    angle = torch.linalg.vector_norm(axis_angle, dim=-1)
    k = axis_angle / angle.clamp_min(1e-30)[:, None]
    zero = torch.zeros_like(angle)
    kx = torch.stack([torch.stack([zero, -k[:, 2], k[:, 1]], -1),
                      torch.stack([k[:, 2], zero, -k[:, 0]], -1),
                      torch.stack([-k[:, 1], k[:, 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    s, c = torch.sin(angle)[:, None, None], torch.cos(angle)[:, None, None]
    return eye + s * kx + (1.0 - c) * (kx @ kx)


def _uniform_directions(n: int, gen, device) -> torch.Tensor:
    d = torch.randn((n, 3), generator=gen, device=device, dtype=torch.float64)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-30)


def streets(scene: dict, device) -> tuple:
    """The grid's streets: (R (2n, 3, 3), o (2n, 3)) float64, a street's
    world-from-local rotation and origin. Local x runs along the street, y is
    the height and z the depth towards its façade; the first n run along
    world x, the other n along world z (local x = world -z, z = world x)."""
    n, side = int(scene["streets_per_axis"]), float(scene["extent"])
    at = -0.5 * side + (torch.arange(n, dtype=torch.float64) + 0.5) * side / n
    along_x = torch.eye(3, dtype=torch.float64)
    along_z = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
                           dtype=torch.float64)
    r = torch.cat([along_x.expand(n, 3, 3), along_z.expand(n, 3, 3)])
    o = torch.zeros((2 * n, 3), dtype=torch.float64)
    o[:n, 2], o[n:, 0] = at, at
    return r.to(device), o.to(device)


def query_poses(street: torch.Tensor, u: torch.Tensor, phase: torch.Tensor,
                scene: dict) -> torch.Tensor:
    """(N, 4, 4) float64 camera-from-world poses: a camera at ``u`` along
    its ``street`` facing the façade, with the wobble of
    ``vobench/generator.py``'s path at ``phase``."""
    w = torch.tensor(scene["wobble"], dtype=torch.float64, device=u.device)
    shape = torch.stack([torch.sin(phase), torch.sin(2.0 * phase), torch.cos(phase),
                         torch.sin(phase), torch.cos(2.0 * phase), torch.sin(3.0 * phase)],
                        -1) * w
    centre = torch.stack([u, torch.zeros_like(u), torch.zeros_like(u)], -1) + shape[:, :3]
    r_cam = generator._euler(shape[:, 3:])            # camera-from-street
    r_st, o_st = (x[street] for x in streets(scene, u.device))
    r = r_cam @ r_st.transpose(1, 2)                   # camera-from-world
    world_centre = (r_st @ centre[:, :, None])[..., 0] + o_st
    pose = torch.zeros((u.shape[0], 4, 4), dtype=torch.float64, device=u.device)
    pose[:, :3, :3] = r
    pose[:, :3, 3] = -(r @ world_centre[:, :, None])[..., 0]
    pose[:, 3, 3] = 1.0
    return pose


def make_pool(sequences: int, frames: int, slots: int, appearance_dim: int, camera: dict,
              scene: dict, seed: int, device) -> dict:
    """``sequences`` query frames (``frames`` must be 1) of ``slots`` from
    ``seed``, and the map they are relocalized against: {"points": (N, 1, S,
    2) float32, "appearances": (N, 1, S, D) float32, "masks": (N, 1, S) bool,
    "map_points": (C, 3) float32, "map_appearances": (C, D) float32,
    "map_valid": (C,) bool, "priors": (N, 4, 4) float32}, on ``device``."""
    if frames != 1:
        raise ValueError(f"a relocalization query is one frame, not {frames}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n, lm = sequences, int(scene["landmarks"])
    mapped, capacity = int(scene["mapped"]), int(scene["map_rows"])
    if not 0 < mapped <= min(lm, capacity):
        raise ValueError(f"{mapped} mapped landmarks of {lm} in a map of {capacity} rows")
    side = float(scene["extent"])
    (y0, y1), (d0, d1) = scene["facade"]
    box = torch.tensor([[-0.5 * side, 0.5 * side], [y0, y1], [d0, d1]], dtype=torch.float32,
                       device=device)
    local = box[:, 0] + (box[:, 1] - box[:, 0]) * torch.rand((lm, 3), generator=gen,
                                                            device=device)
    apps = 2.0 * torch.rand((lm, appearance_dim), generator=gen, device=device) - 1.0
    score = torch.rand((lm,), generator=gen, device=device)
    chosen = torch.randperm(lm, generator=gen, device=device)[:mapped]
    r_st, o_st = streets(scene, device)
    on = torch.arange(lm, device=device) * r_st.shape[0] // lm   # an equal share a street
    # The rotations hold 0 and +-1 only: a product and sum a row (no matmul,
    # which may round through TF32) moves each coordinate exactly.
    world = ((r_st.float()[on] * local[:, None, :]).sum(-1) + o_st.float()[on]).contiguous()

    street = torch.randint(0, r_st.shape[0], (n,), generator=gen, device=device)
    reach = 0.5 * side - float(scene["street_margin"])
    u = reach * (2.0 * torch.rand((n,), generator=gen, device=device, dtype=torch.float64)
                 - 1.0)
    phase = 2.0 * math.pi * torch.rand((n,), generator=gen, device=device, dtype=torch.float64)
    noise = float(scene["pixel_noise"]) * torch.randn((n, slots, 2), generator=gen,
                                                      device=device)
    app_noise = float(scene["appearance_noise"]) * torch.randn(
        (n, slots, appearance_dim), generator=gen, device=device)
    angle = math.radians(float(scene["prior_rotation_deg"])) * torch.rand(
        (n,), generator=gen, device=device, dtype=torch.float64)
    axis = _uniform_directions(n, gen, device)
    shift = float(scene["prior_translation"]) * torch.rand(
        (n,), generator=gen, device=device, dtype=torch.float64)
    direction = _uniform_directions(n, gen, device)

    poses = query_poses(street, u, phase, scene)
    world64 = world.double()
    step = max(1, BLOCK_ELEMENTS // lm)
    parts = [generator._frames(world64[None], apps[None], score[None], noise[None, i:i + step],
                               poses[i:i + step], camera, scene, slots) for i in range(0, n, step)]
    del world64
    points, appearances, masks = (torch.cat([p[j][0] for p in parts]) for j in range(3))
    appearances = torch.where(masks[..., None], appearances + app_noise, appearances)

    perturb = torch.zeros_like(poses)
    perturb[:, :3, :3] = _rotations(axis * angle[:, None])
    perturb[:, :3, 3] = direction * shift[:, None]
    perturb[:, 3, 3] = 1.0
    priors = (perturb @ poses).float()

    map_points = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
    map_apps = torch.full((capacity, appearance_dim), float("inf"), dtype=torch.float32,
                          device=device)
    map_valid = torch.zeros((capacity,), dtype=torch.bool, device=device)
    map_points[:mapped] = world[chosen]
    map_apps[:mapped] = apps[chosen]
    map_valid[:mapped] = True
    return {"points": points[:, None].contiguous(),
            "appearances": appearances[:, None].contiguous(),
            "masks": masks[:, None].contiguous(), "map_points": map_points,
            "map_appearances": map_apps, "map_valid": map_valid, "priors": priors}


def occupancy(pool: dict) -> dict:
    """Live slots a query frame (mean, least, most), and the map's live rows
    and rows."""
    held = generator.occupancy(pool)
    held.update(map_rows_live=int(pool["map_valid"].sum()),
                map_rows=int(pool["map_valid"].shape[0]))
    return held
