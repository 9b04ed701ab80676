"""Pinhole camera as a NamedTuple of tensors (port of visual_odometry_tpu.ops.camera).

Validity semantics of camera.h:25-37: ``z_near <= z <= z_far`` and
``0 <= u <= cols-1``, ``0 <= v <= rows-1``; invalid points are ``(-1, -1)``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import se3


class Camera(NamedTuple):
    camera_matrix: torch.Tensor     # (3, 3) intrinsics K
    world_in_camera: torch.Tensor   # (4, 4) extrinsics
    rows: torch.Tensor              # () image height in pixels
    cols: torch.Tensor              # () image width in pixels
    z_near: torch.Tensor            # ()
    z_far: torch.Tensor             # ()

    @classmethod
    def create(
        cls,
        camera_matrix,
        world_in_camera=None,
        rows: int = 100,
        cols: int = 100,
        z_near: float = 0.0,
        z_far: float = 10.0,
        device="cpu",
    ) -> "Camera":
        """Defaults mirror the reference ctor (camera.h:17-23)."""

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32).to(device)

        if world_in_camera is None:
            world_in_camera = torch.eye(4, dtype=torch.float32)
        return cls(
            camera_matrix=f32(camera_matrix),
            world_in_camera=f32(world_in_camera),
            rows=f32(rows),
            cols=f32(cols),
            z_near=f32(z_near),
            z_far=f32(z_far),
        )

    def params(self) -> torch.Tensor:
        """``(4,)`` = [z_near, z_far, cols, rows], the frame kernel's camera row."""
        return torch.stack([self.z_near, self.z_far, self.cols, self.rows])


def project_points(camera: Camera, world_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project ``(..., N, 3)`` points -> ``((..., N, 2), (..., N) bool)``."""
    p_cam = se3.transform_points(camera.world_in_camera, world_points)
    z = p_cam[..., 2]
    depth_ok = (z <= camera.z_far) & (z >= camera.z_near)
    p_hom = p_cam @ camera.camera_matrix.T
    safe_z = torch.where(p_hom[..., 2] == 0.0, torch.ones_like(z), p_hom[..., 2])
    uv = p_hom[..., :2] / safe_z[..., None]
    in_img = (
        (uv[..., 0] >= 0.0)
        & (uv[..., 0] <= camera.cols - 1.0)
        & (uv[..., 1] >= 0.0)
        & (uv[..., 1] <= camera.rows - 1.0)
    )
    valid = depth_ok & in_img
    uv = torch.where(valid[..., None], uv, torch.full_like(uv, -1.0))
    return uv, valid
