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
from .config import VOConfig

# JAX backend strings -> this package's. Pallas kernels (and their
# interpreter) map to the CUDA kernels' plain/auto counterparts: "auto"
# picks the kernel on a CUDA tensor; "xla" and the interpreter forms are the
# plain path.
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
