"""Carry state across from the JAX package (or any numpy source).

There are no weights: the carried state is the camera, the config and the
tracker state. Every function takes plain numpy arrays / dicts, so callers
(the parity tests) build both packages' inputs from the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.landmark_map import LandmarkMap
from ..models.pipeline import FrameData, VOState
from ..ops.camera import Camera
from ..ops.picp import PICPStats
from .config import VOConfig

# JAX backend strings -> this package's. Pallas kernels (and their
# interpreter) map to the CUDA kernels' plain/auto counterparts: "auto"
# picks the kernel on a CUDA tensor; "xla" and the interpreter forms are the
# plain path. For scan_backend, JAX's "xla" is the frame_step scan: "step".
_BACKEND_MAP = {
    "auto": "auto",
    "pallas": "cuda",
    "pairs_pallas": "cuda",
    "fused": "cuda",
    "xla": "torch",
    "pairs_pallas_interpret": "torch",
    "fused_interpret": "torch",
}


def _t(x, dtype, device):
    # np.array copies: arrays from JAX are read-only, which torch.from_numpy refuses to share.
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def to_device(tree, device):
    """A nest of tensors (NamedTuples of them, such as a VOState or a
    FrameData) with every tensor moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(to_device(x, device) for x in tree))


def camera_from_arrays(K, rows, cols, z_near, z_far, world_in_camera=None, device="cpu") -> Camera:
    return Camera.create(np.asarray(K, np.float32), world_in_camera, rows=float(rows),
                         cols=float(cols), z_near=float(z_near), z_far=float(z_far),
                         device=device)


def config_from_dict(d: dict) -> VOConfig:
    """``config_from_dict(dataclasses.asdict(jax_cfg))``: same fields, backend
    strings mapped; unknown fields are rejected."""
    names = {f.name for f in dataclasses.fields(VOConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown VOConfig fields: {sorted(unknown)}")
    kw = dict(d)
    for key in ("matcher_backend", "scan_backend", "solver_backend"):
        if key in kw:
            if kw[key] not in _BACKEND_MAP:
                raise ValueError(f"{key}={kw[key]!r} has no counterpart in this package")
            if key == "scan_backend" and kw[key] == "xla":
                kw[key] = "step"
            else:
                kw[key] = _BACKEND_MAP[kw[key]]
    if kw.get("cam_in_robot") is not None:
        kw["cam_in_robot"] = tuple(tuple(float(x) for x in row) for row in kw["cam_in_robot"])
    return VOConfig(**kw)


def landmark_map_from_arrays(points, appearances, valid, count=None, device="cpu") -> LandmarkMap:
    valid = np.asarray(valid, bool)
    return LandmarkMap(
        points=_t(points, torch.float32, device),
        appearances=_t(appearances, torch.float32, device),
        valid=_t(valid, torch.bool, device),
        count=_t(valid.sum() if count is None else count, torch.int32, device),
    )


def frame_data_from_arrays(points, appearances, mask, ids=None, device="cpu") -> FrameData:
    mask = np.asarray(mask, bool)
    if ids is None:
        ids = np.full(mask.shape, -1, np.int32)
    return FrameData(
        points=_t(points, torch.float32, device),
        appearances=_t(appearances, torch.float32, device),
        mask=_t(mask, torch.bool, device),
        ids=_t(ids, torch.int32, device),
    )


def vo_state_from_arrays(ref: dict, point_lookup, tri_points, tri_valid, x_curr, history,
                         map_arrays: dict, device="cpu") -> VOState:
    """``ref`` holds FrameData fields, ``map_arrays`` LandmarkMap fields."""
    return VOState(
        ref=frame_data_from_arrays(**ref, device=device),
        point_lookup=_t(point_lookup, torch.int32, device),
        tri_points=_t(tri_points, torch.float32, device),
        tri_valid=_t(tri_valid, torch.bool, device),
        x_curr=_t(x_curr, torch.float32, device),
        history=_t(history, torch.float32, device),
        map=landmark_map_from_arrays(**map_arrays, device=device),
    )


def vo_state_to_arrays(state: VOState) -> dict:
    """The state as a flat dict of numpy arrays under the checkpoint's field
    names (``ref_points`` ... ``map_count``), the reverse of
    :func:`vo_state_from_flat`."""
    def n(t):
        return t.detach().cpu().numpy()

    return dict(
        ref_points=n(state.ref.points), ref_appearances=n(state.ref.appearances),
        ref_mask=n(state.ref.mask), ref_ids=n(state.ref.ids),
        point_lookup=n(state.point_lookup), tri_points=n(state.tri_points),
        tri_valid=n(state.tri_valid), x_curr=n(state.x_curr), history=n(state.history),
        map_points=n(state.map.points), map_appearances=n(state.map.appearances),
        map_valid=n(state.map.valid), map_count=n(state.map.count),
    )


def vo_state_from_flat(a: dict, device="cpu") -> VOState:
    """A state from the flat dict of :func:`vo_state_to_arrays` (or from the
    fields of a JAX ``VOState`` under the same names)."""
    return vo_state_from_arrays(
        ref=dict(points=a["ref_points"], appearances=a["ref_appearances"], mask=a["ref_mask"],
                 ids=a["ref_ids"]),
        point_lookup=a["point_lookup"], tri_points=a["tri_points"], tri_valid=a["tri_valid"],
        x_curr=a["x_curr"], history=a["history"],
        map_arrays=dict(points=a["map_points"], appearances=a["map_appearances"],
                        valid=a["map_valid"], count=a["map_count"]),
        device=device,
    )


def picp_stats_from_arrays(chi_inliers, chi_outliers, num_inliers, device="cpu") -> PICPStats:
    return PICPStats(chi_inliers=_t(chi_inliers, torch.float32, device),
                     chi_outliers=_t(chi_outliers, torch.float32, device),
                     num_inliers=_t(num_inliers, torch.int32, device))


def sparse_ba_problem_from_arrays(poses, landmarks, frame_idx, lm_idx, uv, obs_mask,
                                  device="cpu"):
    """A ``parallel.sparse_ba.SparseBAProblem`` from the numpy fields of the
    JAX package's NamedTuple of the same name (``**problem._asdict()``)."""
    from ..parallel.sparse_ba import SparseBAProblem

    return SparseBAProblem(
        poses=_t(poses, torch.float32, device), landmarks=_t(landmarks, torch.float32, device),
        frame_idx=_t(frame_idx, torch.int32, device), lm_idx=_t(lm_idx, torch.int32, device),
        uv=_t(uv, torch.float32, device), obs_mask=_t(np.asarray(obs_mask, bool), torch.bool,
                                                      device))


def ba_problem_from_arrays(poses, landmarks, observations, obs_mask, device="cpu"):
    """A ``parallel.bundle_adjustment.BAProblem`` from the numpy fields of the
    JAX package's."""
    from ..parallel.bundle_adjustment import BAProblem

    return BAProblem(
        poses=_t(poses, torch.float32, device), landmarks=_t(landmarks, torch.float32, device),
        observations=_t(observations, torch.float32, device),
        obs_mask=_t(np.asarray(obs_mask, bool), torch.bool, device))


def ba_solution_to_arrays(problem) -> dict:
    """The refined unknowns of either problem kind as numpy: poses (F, 4, 4)
    and landmarks (L, 3), what a test holds against the JAX package's step."""
    return dict(poses=problem.poses.detach().cpu().numpy(),
                landmarks=problem.landmarks.detach().cpu().numpy())


def pca_tree_from_arrays(axes, thresholds, codes, levels: int, device="cpu"):
    """An ``ops.pca_tree.PCATree`` from the numpy fields of the JAX package's
    (``**tree._asdict()``): the same split planes and leaf codes, so both
    packages' queries can run on one tree."""
    from ..ops.pca_tree import PCATree

    return PCATree(axes=_t(axes, torch.float32, device),
                   thresholds=_t(thresholds, torch.float32, device),
                   codes=_t(codes, torch.int32, device), levels=int(levels))
