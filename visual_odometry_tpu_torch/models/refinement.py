"""Global refinement: bundle-adjust the tracked trajectory and landmark map
(port of visual_odometry_tpu.models.refinement).

The reference stops at frame-to-frame tracking: its map is the raw
last-observation position of each landmark and its trajectory accumulates
drift. This module rebuilds the full observation graph from the dataset
(landmark identity = exact appearance key, the invariant of the map merge,
PointCloud.h:56) and runs a bundle adjustment over all poses and landmarks
jointly: the dense Schur form (``parallel/bundle_adjustment``) or, at
production scale, COO observations with matrix-free Schur-CG
(``parallel/sparse_ba``, kernels K9 and K10 on the card).

Conventions: tracking produces RELATIVE poses X_f (frame f-1 expressed in
frame f, vo_complete.cpp:128). Absolute camera-from-world poses (world =
frame-0 camera) compose as A_0 = I, A_f = X_f A_{f-1}; the map lives in
frame-0 coordinates. After refinement the trajectory is folded back to
relative poses X_f = A_f A_{f-1}^-1, so every writer and the evaluator are
unchanged.

``refine_trajectory`` and ``refine_trajectory_sparse`` take numpy arrays and
return numpy arrays, as the JAX package's do; the step runs on ``device``,
which defaults to the CUDA card (``default_device()`` raises without one).
With a ``mesh`` (``parallel/mesh``) every rank calls them with the same whole
inputs: the landmarks are padded to a multiple of the ``lm`` axis and split
over it, each rank steps its block on ``mesh.device``
(``bundle_adjustment.make_sharded_ba_step`` on a batch of one sequence;
``sparse_ba.make_sharded_sparse_ba_step`` on the packed shard layout), and
every rank returns the whole result.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import default_device
from ..parallel import bundle_adjustment as ba
from ..parallel import mesh as mesh_mod
from ..parallel import sparse_ba as sba
from ..parallel.matcher import shard_rows
from .landmark_map import LandmarkMap, compact


def absolute_from_relative(relative: np.ndarray) -> np.ndarray:
    """[X_0..X_{F-1}] relative poses -> A_f (camera from frame 0), A_0 = X_0 = I,
    accumulated in float64."""
    out = np.zeros_like(relative)
    acc = np.eye(4, dtype=np.float64)
    for f in range(len(relative)):
        acc = relative[f].astype(np.float64) @ acc
        out[f] = acc
    return out.astype(np.float32)


def relative_from_absolute(absolute: np.ndarray) -> np.ndarray:
    out = np.zeros_like(absolute)
    out[0] = np.eye(4, dtype=np.float32)
    for f in range(1, len(absolute)):
        out[f] = (
            absolute[f].astype(np.float64) @ np.linalg.inv(absolute[f - 1].astype(np.float64))
        ).astype(np.float32)
    return out


def build_observations(
    seq_points: np.ndarray,       # (F, S, 2)
    seq_appearances: np.ndarray,  # (F, S, D)
    seq_mask: np.ndarray,         # (F, S)
    map_appearances: np.ndarray,  # (L, D) landmark appearance keys
) -> Tuple[np.ndarray, np.ndarray]:
    """(F, L, 2) pixel observations and the (F, L) mask via the
    exact-appearance join, on the host: a measurement observes landmark l iff
    its appearance equals the map's key exactly (the identity rule of the map
    merge and of the evaluator, evaluate.cpp:76)."""
    f, s, _ = seq_points.shape
    l = len(map_appearances)
    key_to_l = {map_appearances[j].tobytes(): j for j in range(l)}
    obs = np.zeros((f, l, 2), np.float32)
    mask = np.zeros((f, l), bool)
    for fi in range(f):
        for si in range(int(seq_mask[fi].sum())):
            j = key_to_l.get(seq_appearances[fi, si].tobytes())
            if j is not None:
                obs[fi, j] = seq_points[fi, si]
                mask[fi, j] = True
    return obs, mask


def build_observations_coo(
    seq_points: torch.Tensor,       # (F, S, 2)
    seq_appearances: torch.Tensor,  # (F, S, D)
    seq_mask: torch.Tensor,         # (F, S)
    map_appearances: torch.Tensor,  # (L, D) landmark appearance keys
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat COO observation list via a device-side exact-appearance join.

    The sparse-BA form of :func:`build_observations`: returns (frame_idx (N,),
    lm_idx (N,), uv (N, 2), mask (N,)) with N = F*S — memory O(#measurements),
    never O(F*L). Keys are the appearance rows bitcast to int32 columns (exact
    float equality is exact bit equality for keys carried verbatim). The JAX
    package sorts [map rows | measurement rows] on all key columns and
    forward-fills each run's landmark index; here ``torch.unique`` over the key
    rows groups them (as in ``landmark_map.merge_stream``) and a scatter-max
    gives each group its landmark: the largest map row holding the key, as
    the JAX scan leaves it. Dead measurement slots get a sentinel key and
    never join a landmark."""
    f, s, d = seq_appearances.shape
    l = map_appearances.shape[0]
    dev = seq_appearances.device
    apps = torch.cat([map_appearances, seq_appearances.reshape(f * s, d)], dim=0)
    keys = apps.to(torch.float32).contiguous().view(torch.int32)
    live = torch.cat([torch.ones((l,), dtype=torch.bool, device=dev), seq_mask.reshape(f * s)])
    keys = torch.where(live[:, None], keys, 2**31 - 1)
    _, group = torch.unique(keys, dim=0, return_inverse=True)
    lm_of_group = torch.full((int(group.max()) + 1 if group.numel() else 0,), -1,
                             dtype=torch.int64, device=dev)
    lm_of_group = lm_of_group.scatter_reduce(
        0, group[:l], torch.arange(l, dtype=torch.int64, device=dev), reduce="amax")
    lm_of_meas = lm_of_group[group[l:]]
    mask = (lm_of_meas >= 0) & seq_mask.reshape(f * s)
    frame_idx = torch.arange(f, dtype=torch.int32, device=dev).repeat_interleave(s)
    return (frame_idx, torch.where(mask, lm_of_meas, 0).to(torch.int32),
            seq_points.reshape(f * s, 2), mask)


def _device(mesh, device) -> torch.device:
    if mesh is not None:
        return mesh.device
    return torch.device(device) if device is not None else default_device()


def refine_trajectory(
    camera_matrix: np.ndarray,
    trajectory: np.ndarray,        # (F, 4, 4) relative poses from tracking
    map_state: LandmarkMap,
    seq_points: np.ndarray,
    seq_appearances: np.ndarray,
    seq_mask: np.ndarray,
    num_iterations: int = 15,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, "ba.BAStats"]:
    """Dense BA over the whole sequence; returns (relative trajectory, map
    points, map appearances, stats of the last step). With ``mesh`` (a (dp,
    lm) mesh whose dp axis has size 1: the batch is one sequence) the step
    runs landmark-sharded over its ``lm`` axis."""
    if mesh is not None:
        step = ba.make_sharded_ba_step(mesh, damping=damping, kernel_threshold=kernel_threshold)
        if mesh.shape["dp"] != 1:
            raise ValueError(f"a batch of one sequence does not divide the mesh's dp axis of "
                             f"size {mesh.shape['dp']}")
    device = _device(mesh, device)
    map_pts, map_apps = compact(map_state)
    obs, obs_mask = build_observations(seq_points, seq_appearances, seq_mask, map_apps)
    k = torch.as_tensor(np.asarray(camera_matrix, np.float32), device=device)
    poses = torch.from_numpy(absolute_from_relative(trajectory)).to(device)
    if mesh is None:
        problem = ba.BAProblem(
            poses=poses, landmarks=torch.from_numpy(map_pts).to(device),
            observations=torch.from_numpy(obs).to(device),
            obs_mask=torch.from_numpy(obs_mask).to(device))
        refined, stats = ba.refine(k, problem, num_iterations=num_iterations, damping=damping,
                                   kernel_threshold=kernel_threshold)
        return (relative_from_absolute(refined.poses.cpu().numpy()),
                refined.landmarks.cpu().numpy(), map_apps, stats)

    l = map_pts.shape[0]
    lms, _ = mesh_mod.pad_to_multiple(map_pts, 0, mesh.shape["lm"])
    obs, _ = mesh_mod.pad_to_multiple(obs, 1, mesh.shape["lm"])
    obs_mask, _ = mesh_mod.pad_to_multiple(obs_mask, 1, mesh.shape["lm"])

    def columns(x):   # this rank's block of the landmark columns of (F, L_pad, ...)
        return shard_rows(mesh, torch.from_numpy(x).transpose(0, 1)).transpose(0, 1)[None]

    bp = ba.BAProblem(poses=poses[None], landmarks=shard_rows(mesh, torch.from_numpy(lms))[None],
                      observations=columns(obs).contiguous(),
                      obs_mask=columns(obs_mask).contiguous())
    stats = None
    for _ in range(num_iterations):
        bp, stats = step(k, bp)
    landmarks = mesh_mod.all_gather(mesh, bp.landmarks[0], "lm")[:l]
    return (relative_from_absolute(bp.poses[0].cpu().numpy()), landmarks.cpu().numpy(), map_apps,
            stats)


def refine_trajectory_sparse(
    camera_matrix: np.ndarray,
    trajectory: np.ndarray,        # (F, 4, 4) relative poses from tracking
    map_state: LandmarkMap,
    seq_points: np.ndarray,
    seq_appearances: np.ndarray,
    seq_mask: np.ndarray,
    num_iterations: int = 15,
    damping: float = 1.0,
    kernel_threshold: float = 10000.0,
    cg_iterations: int = 64,
    cg_tolerance: float = 1e-6,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, "sba.SparseBAStats"]:
    """Production-scale refinement: the sparse twin of
    :func:`refine_trajectory`. The observation join runs on the device
    (:func:`build_observations_coo`) and the step is ``parallel.sparse_ba``,
    memory O(#observations). With ``mesh`` the step runs over its ``lm``
    axis on the packed shard layout
    (``sparse_ba.partition_observations_packed``), K9's plan made once a run
    on each rank's block."""
    device = _device(mesh, device)
    map_pts, map_apps = compact(map_state)

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    fi, li, uv, mask = build_observations_coo(
        dev(seq_points, np.float32), dev(seq_appearances, np.float32), dev(seq_mask, bool),
        dev(map_apps, np.float32))
    k, poses = dev(camera_matrix, np.float32), dev(absolute_from_relative(trajectory))
    if mesh is None:
        problem = sba.SparseBAProblem(poses=poses, landmarks=dev(map_pts), frame_idx=fi,
                                      lm_idx=li, uv=uv, obs_mask=mask)
        refined, stats = sba.refine_sparse(
            k, problem, num_iterations=num_iterations, damping=damping,
            kernel_threshold=kernel_threshold, cg_iterations=cg_iterations,
            cg_tolerance=cg_tolerance)
        return (relative_from_absolute(refined.poses.cpu().numpy()),
                refined.landmarks.cpu().numpy(), np.asarray(map_apps), stats)

    n_lm, l = mesh.shape["lm"], map_pts.shape[0]
    *shards, l_per, degree = sba.partition_observations_packed(
        n_lm, l, *(x.cpu().numpy() for x in (fi, li, uv, mask)))
    lms = np.zeros((n_lm * l_per, 3), np.float32)
    lms[:l] = map_pts
    work = sba.SparseBAProblem(poses, *(shard_rows(mesh, torch.from_numpy(x))
                                        for x in (lms, *shards)))
    step = sba.make_sharded_sparse_ba_step(
        mesh, damping=damping, kernel_threshold=kernel_threshold, cg_iterations=cg_iterations,
        cg_tolerance=cg_tolerance, lm_degree=degree)
    frames = sba.plan_frames(work)
    stats = None
    for _ in range(num_iterations):
        work, stats = step(k, work, frames)
    landmarks = mesh_mod.all_gather(mesh, work.landmarks, "lm")[:l]
    return (relative_from_absolute(work.poses.cpu().numpy()), landmarks.cpu().numpy(),
            np.asarray(map_apps), stats)
