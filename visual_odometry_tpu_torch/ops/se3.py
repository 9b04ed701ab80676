"""SE(3) on the Euler-angle chart (port of visual_odometry_tpu.ops.se3).

Poses are ``(..., 4, 4)`` float32 tensors. Gauss-Newton increments use the
reference's Euler chart ``X <- v2tEuler(dx) X`` (utils.h:73-78), not the
exponential map; the chart is load-bearing for trajectory parity.
"""

from __future__ import annotations

import torch


def _rot(s, c, o, z, rows):
    return torch.stack([torch.stack(r, -1) for r in rows(s, c, o, z)], -2)


def rotation_x(angle: torch.Tensor) -> torch.Tensor:
    s, c = torch.sin(angle), torch.cos(angle)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _rot(s, c, o, z, lambda s, c, o, z: [[o, z, z], [z, c, -s], [z, s, c]])


def rotation_y(angle: torch.Tensor) -> torch.Tensor:
    s, c = torch.sin(angle), torch.cos(angle)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _rot(s, c, o, z, lambda s, c, o, z: [[c, z, s], [z, o, z], [-s, z, c]])


def rotation_z(angle: torch.Tensor) -> torch.Tensor:
    s, c = torch.sin(angle), torch.cos(angle)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _rot(s, c, o, z, lambda s, c, o, z: [[c, -s, z], [s, c, z], [z, z, o]])


def euler_to_rotation(angles: torch.Tensor) -> torch.Tensor:
    """xyz Euler angles ``(..., 3)`` -> ``Rx(a) @ Ry(b) @ Rz(c)`` (utils.h:61-67)."""
    return (
        rotation_x(angles[..., 0]) @ rotation_y(angles[..., 1]) @ rotation_z(angles[..., 2])
    )


def pose_from_rt(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """Assemble ``(..., 4, 4)`` transforms from R ``(..., 3, 3)`` and t ``(..., 3)``."""
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype, device=rotation.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def v2t_euler(v: torch.Tensor) -> torch.Tensor:
    """6-vector ``(x y z th_x th_y th_z)`` -> ``(4, 4)`` transform (utils.h:73-78)."""
    return pose_from_rt(euler_to_rotation(v[..., 3:]), v[..., :3])


def rot(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3, :3]


def trans(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3, 3]


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse ``[R^T | -R^T t]``."""
    r_t = rot(pose).transpose(-1, -2)
    t = -(r_t @ trans(pose)[..., :, None])[..., 0]
    return pose_from_rt(r_t, t)


def transform_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a ``(..., 4, 4)`` pose to points ``(..., N, 3)``."""
    return points @ rot(pose).transpose(-1, -2) + trans(pose)[..., None, :]


def chain_products(mats: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products ``out[j] = mats[0] @ mats[1] @ ... @ mats[j]``.

    The counterpart of ``jax.lax.associative_scan(jnp.matmul, mats)``: a
    log-depth doubling scan of batched matmuls (Hillis-Steele). Pose products
    do not commute, so every step keeps the earlier factor on the left.
    """
    out = mats
    offset = 1
    while offset < out.shape[0]:
        out = torch.cat([out[:offset], out[:-offset] @ out[offset:]], dim=0)
        offset *= 2
    return out
