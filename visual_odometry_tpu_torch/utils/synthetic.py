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


def generate_pose(rng: np.random.Generator) -> np.ndarray:
    """Random rigid transform (4, 4) float32: uniform(-1, 1) axis-angle and
    translation (``generate_isometry3f``, utils.cpp:8-20)."""
    axis = rng.uniform(-1.0, 1.0, 3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(-1.0, 1.0)
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]],
        np.float32,
    )
    r = np.eye(3, dtype=np.float32) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = r
    pose[:3, 3] = rng.uniform(-1.0, 1.0, 3)
    return pose


def generate_points3d(rng: np.random.Generator, num_points: int) -> np.ndarray:
    """Random world points (N, 3) float32: x, y ~ U(-10, 10), z ~ U(-10, 10)
    * 0.1 + 1 (``generate_points3d``, utils.cpp:22-34)."""
    p = rng.uniform(-10.0, 10.0, (num_points, 3)).astype(np.float32)
    p[:, 2] = p[:, 2] * 0.1 + 1.0
    return p


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


def two_view_scene(rng: np.random.Generator, num_points: int = 1000):
    """World points seen from two random cameras, with identity correspondences.

    Returns (world, w1, w2, p1, p2, corr_valid, x_1_in_2) as numpy arrays:
    w1/w2 the world_in_camera poses, p1/p2 the (N, 2) projections through
    :func:`default_camera` ((-1, -1) where invalid), corr_valid the
    both-views-valid mask (``computeFakeCorrespondences``), and
    x_1_in_2 = w2 @ w1^-1 the ground-truth relative pose
    (essential_picp_test.cpp:103)."""
    world = generate_points3d(rng, num_points)
    w1 = generate_pose(rng)
    w2 = generate_pose(rng)
    world_t = torch.from_numpy(world)
    p1, v1 = project_points(default_camera(w1), world_t)
    p2, v2 = project_points(default_camera(w2), world_t)
    corr_valid = v1.numpy() & v2.numpy()
    x_1_in_2 = (w2 @ np.linalg.inv(w1)).astype(np.float32)
    return world, w1, w2, p1.numpy(), p2.numpy(), corr_valid, x_1_in_2


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


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), finite inputs."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def generate_match_ties(rng: np.random.Generator, num_queries: int, num_rows: int,
                        dim: int = 10):
    """A top-1 problem built to trip a fast matcher that selects on a rounded
    gram: (queries, q_mask, db, db_mask) as numpy arrays, num_rows >= 1024.

    The rows are bfloat16-exact. Each group of four queries (one group per
    1,024 rows) aims at a row j + 256, one 256-row tile past a neighbour that
    the group plants at a lower column, by turns: row j with one component
    +0.03, row j an exact duplicate, or row j + 1 one bfloat16 ulp away in one
    component. The queries are the row scaled by 1 - 2^-10 (its bfloat16
    rounding is the row, its norm is smaller, so its gram distances to the
    row and to the neighbour are both negative: they clamp to 0 and the lower
    column wins, where an unclamped selection takes the row after a +0.03
    neighbour), the row itself, the row scaled by 1 - 2^-9, and a point far
    from every row. A tenth of the rows is masked and holds NaN or inf, eight
    other live rows hold a NaN or an inf (they never win), and a twentieth of
    the queries is masked."""
    db = _bf16_exact(rng.uniform(-1.0, 1.0, (num_rows, dim)).astype(np.float32))
    q = rng.uniform(-1.0, 1.0, (num_queries, dim)).astype(np.float32)
    db_mask = rng.uniform(size=num_rows) > 0.1
    planted = []
    for g in range(min(num_queries // 4, num_rows // 1024)):
        j = 1024 * g + int(rng.integers(0, 512))
        row = db[j + 256]
        c = g % dim
        near = j + 1 if g % 3 == 2 else j
        db[near] = row
        if g % 3 == 0:
            db[near, c] = _bf16_exact(np.float32([row[c] + np.float32(0.03)]))[0]
        elif g % 3 == 2:
            db[near, c] = (row[c:c + 1].view(np.uint32) + np.uint32(0x10000)).view(np.float32)[0]
        db_mask[[near, j + 256]] = True
        planted += [near, j + 256]
        q[4 * g] = row * np.float32(1.0 - 2.0 ** -10)
        q[4 * g + 1] = row
        q[4 * g + 2] = row * np.float32(1.0 - 2.0 ** -9)
        q[4 * g + 3] = np.float32(3.0)
    db[~db_mask] = np.nan
    db[np.flatnonzero(~db_mask)[::3]] = np.inf
    live = np.setdiff1d(np.flatnonzero(db_mask), planted)
    bad = live[rng.permutation(live.size)[:8]]
    db[bad[:4], 1] = np.nan
    db[bad[4:], 2] = np.inf
    q_mask = rng.uniform(size=num_queries) > 0.05
    return q, q_mask, db, db_mask


def exact_keys(q: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The exact matcher's unclamped key ``(|q|^2 + |k|^2) - 2 q.k`` in
    float32, each product and sum rounded in descriptor order as K7's plain
    version computes it; q and k broadcast over their leading axes."""
    with np.errstate(over="ignore", invalid="ignore"):
        qn, n, dot = q[..., 0] * q[..., 0], k[..., 0] * k[..., 0], q[..., 0] * k[..., 0]
        for i in range(1, q.shape[-1]):
            qn = qn + q[..., i] * q[..., i]
            n = n + k[..., i] * k[..., i]
            dot = dot + q[..., i] * k[..., i]
        return (qn + n) - np.float32(2.0) * dot


def _negative_pair(rng: np.random.Generator, dim: int, tries: int = 200):
    """A row r and two rows a few float32 ulps from it whose exact keys to
    the query r are both negative and differ, the less negative first; None
    if ``tries`` draws of r find none."""
    for _ in range(tries):
        r = rng.uniform(-1.0, 1.0, dim).astype(np.float32)
        cands = np.repeat(r[None], 64, axis=0)
        bits = cands.view(np.int32)
        for _ in range(2):   # two components of each candidate moved by -3..3 ulps
            steps = rng.integers(-3, 4, 64).astype(np.int32)
            bits[np.arange(64), rng.integers(0, dim, 64)] += steps
        v = exact_keys(r[None], cands)
        neg = np.unique(v[v < 0])
        if neg.size >= 2:
            return r, cands[np.flatnonzero(v == neg[-1])[0]], cands[np.flatnonzero(v == neg[0])[0]]
    return None


def generate_exact_match_ties(rng: np.random.Generator, num_queries: int, num_rows: int,
                              dim: int = 10):
    """A top-1 problem built to trip an exact matcher that rules rows out on
    a tensor-core gram of bf16 split terms (K7's exact mode):
    (queries, q_mask, db, db_mask) as numpy arrays.

    Traps, by turns, each at a free place in the database while half the
    queries last (a trap that finds no room is left out):
      - ulp pair: rows j, j + 1 equal but one component one float32 ulp apart
        (they differ only past a bf16 split's mid term); queries: both rows;
      - negative pair: rows j, j + 1 a few ulps from a row r, whose float32
        keys to the query r are both negative and differ, row j + 1's the
        more negative (the exact mode takes j + 1; a key clamped at 0, as the
        fast mode's, ties them and takes j); query: r;
      - duplicates: row j copied to j + 256 (one tile on) and to j + S (one
        split of K7's grid on, ``matcher_kernel.split_geometry``) where that
        differs and fits; queries: the row, and the row plus N(0, 1e-3);
      - tiny: rows j and j + 3 with every component of magnitude in
        [2^-133, 2^-118], bf16's subnormal edge (their squares vanish in
        float32: a tiny query's keys to every tiny row are 0, and the first
        one wins), and row j + 5, a row whose first three components are
        tiny; queries: a tiny one, and row j + 5 plus N(0, 1e-3) on its
        other components;
      - huge: row j with one component near +-1e19 (norm ~1e38, finite: every
        query's key to it is ~1e38) and row j + 1 with one near 3e19 (norm
        inf: it never wins); query: one with a component near -2e19, whose
        |q|^2 overflows (no row wins: index 0). A live query of finite norm
        near 1e38 is left out: a bound relative to |q|^2 + |k|^2 rules out
        none of its rows, so it would rescore the whole database.
    The other queries are live unplanted rows plus N(0, 1e-3). A tenth of the
    unplanted rows is masked and holds NaN or inf; eight other live rows
    hold a NaN or an inf (they never win); a twentieth of the queries is
    masked."""
    from ..ops.kernels.matcher_kernel import split_geometry

    nq, nk, d = num_queries, num_rows, dim
    _, split = split_geometry(nq, nk)
    db = rng.uniform(-1.0, 1.0, (nk, d)).astype(np.float32)
    q = np.zeros((nq, d), np.float32)
    planted = np.zeros(nk, bool)

    def tiny(shape):
        mag = np.exp2(rng.uniform(-133.0, -118.0, shape))
        return (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)

    def place(offsets):
        """A row j with j + every offset free and in range; marks them planted."""
        span = max(offsets)
        if span >= nk:
            return None
        for _ in range(64):
            j = int(rng.integers(0, nk - span))
            rows = [j + o for o in offsets]
            if not planted[rows].any():
                planted[rows] = True
                return j
        return None

    nxt, trap = 0, 0
    while nxt + 2 <= nq // 2 and trap < 5 * nq:
        kind, trap = trap % 5, trap + 1
        noise = rng.normal(0.0, 1e-3, d).astype(np.float32)
        if kind == 0:
            j = place([0, 1])
            if j is None:
                continue
            c = int(rng.integers(0, d))
            db[j + 1] = db[j]
            db[j + 1, c] = np.nextafter(db[j, c], np.float32(np.inf))
            q[nxt], q[nxt + 1] = db[j], db[j + 1]
            nxt += 2
        elif kind == 1:
            pair = _negative_pair(rng, d)
            j = None if pair is None else place([0, 1])
            if j is None:
                continue
            q[nxt], db[j], db[j + 1] = pair
            nxt += 1
        elif kind == 2:
            offsets = [0, 256] + ([split] if 256 < split < nk else [])
            j = place(offsets)
            if j is None:
                continue
            for o in offsets[1:]:
                db[j + o] = db[j]
            q[nxt], q[nxt + 1] = db[j], db[j] + noise
            nxt += 2
        elif kind == 3:
            j = place([0, 3, 5])
            if j is None:
                continue
            db[j], db[j + 3] = tiny(d), tiny(d)
            few = min(3, d - 1)
            db[j + 5, :few] = tiny(few)
            q[nxt] = tiny(d)
            q[nxt + 1] = db[j + 5] + np.where(np.arange(d) < few, 0.0, noise).astype(np.float32)
            nxt += 2
        else:
            j = place([0, 1])
            if j is None:
                continue
            c = int(rng.integers(0, d))
            db[j, c] = np.float32(rng.choice([-1.0, 1.0]) * rng.uniform(0.9e19, 1.1e19))
            db[j + 1, int(rng.integers(0, d))] = np.float32(3e19)
            q[nxt] = rng.uniform(-1.0, 1.0, d).astype(np.float32)
            q[nxt, int(rng.integers(0, d))] = np.float32(-rng.uniform(1.9e19, 2.1e19))
            nxt += 1
    free = np.flatnonzero(~planted)
    db_mask = np.ones(nk, bool)
    db_mask[free[rng.uniform(size=free.size) < 0.1]] = False
    live = np.flatnonzero(db_mask & ~planted)
    picks = live[rng.integers(0, live.size, nq - nxt)]
    q[nxt:] = db[picks] + rng.normal(0.0, 1e-3, (nq - nxt, d)).astype(np.float32)
    masked = np.flatnonzero(~db_mask)
    db[masked] = np.nan
    db[masked[::3]] = np.inf
    bad = np.setdiff1d(live, picks)
    bad = bad[rng.permutation(bad.size)[:8]]
    db[bad[:4], 0] = np.nan
    db[bad[4:], d - 1] = np.inf
    q_mask = rng.uniform(size=nq) > 0.05
    return q, q_mask, db, db_mask
