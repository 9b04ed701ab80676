"""SE(3) on the Euler-angle chart (port of visual_odometry_tpu.ops.se3).

Poses are ``(..., 4, 4)`` float32 tensors. Gauss-Newton increments use the
reference's Euler chart ``X <- v2tEuler(dx) X`` (utils.h:73-78), not the
exponential map; the chart is load-bearing for trajectory parity.
"""

from __future__ import annotations

import torch

from ..utils.profiling import host_wait


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
    with host_wait("se3.bottom_row"):
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype, device=rotation.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def v2t_euler(v: torch.Tensor) -> torch.Tensor:
    """6-vector ``(x y z th_x th_y th_z)`` -> ``(4, 4)`` transform (utils.h:73-78)."""
    return pose_from_rt(euler_to_rotation(v[..., 3:]), v[..., :3])


def identity_pose(dtype=torch.float32, device=None) -> torch.Tensor:
    """The (4, 4) identity transform."""
    return torch.eye(4, dtype=dtype, device=device)


def rot(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3, :3]


def trans(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3, 3]


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse ``[R^T | -R^T t]``."""
    r_t = rot(pose).transpose(-1, -2)
    t = -(r_t @ trans(pose)[..., :, None])[..., 0]
    return pose_from_rt(r_t, t)


def matmul_elementwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes, each entry ``((a_i0 b_0j + a_i1 b_1j)
    + ...)`` summed in index order by elementwise ops. Its bits do not depend
    on the batch around a matrix, as a batched matmul's may (on the card the
    kernel is chosen by the batch's size)."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k, None] * b[..., None, k, :]
    return out


def inverse_elementwise(pose: torch.Tensor) -> torch.Tensor:
    """:func:`inverse` with ``-R^T t`` summed per element in index order,
    ``-((R_0i t_0 + R_1i t_1) + R_2i t_2)``: batch-invariant (see
    :func:`matmul_elementwise`)."""
    r, t = rot(pose), trans(pose)
    r_t = r.transpose(-1, -2)
    ti = r[..., 0, :] * t[..., 0, None] + r[..., 1, :] * t[..., 1, None]
    return pose_from_rt(r_t, -(ti + r[..., 2, :] * t[..., 2, None]))


def project_se2_elementwise(pose: torch.Tensor) -> torch.Tensor:
    """:func:`project_se2` with the yaw's cosine and sine taken as
    ``(x, y) / sqrt(x^2 + y^2)`` of the rotation's first column (``(1, 0)``
    at the origin, as ``atan2(0, 0) = 0``): correctly rounded operations
    only, so batch-invariant on every device (the CPU's vector and scalar
    ``atan2`` round differently)."""
    x, y = pose[..., 0, 0], pose[..., 1, 0]
    r = torch.sqrt(x * x + y * y)
    live = r > 0.0
    safe = torch.where(live, r, torch.ones_like(r))
    c = torch.where(live, x / safe, torch.ones_like(x))
    s = torch.where(live, y / safe, torch.zeros_like(y))
    o, z = torch.ones_like(c), torch.zeros_like(c)
    rz = _rot(s, c, o, z, lambda s, c, o, z: [[c, -s, z], [s, c, z], [z, z, o]])
    return pose_from_rt(rz, torch.stack([pose[..., 0, 3], pose[..., 1, 3], z], -1))


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


def skew(v: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` -> skew-symmetric ``(..., 3, 3)`` (utils.h:96-102)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)],
        -2,
    )


def v2t_se2(v: torch.Tensor) -> torch.Tensor:
    """Planar ``(x, y, theta)`` -> ``(..., 4, 4)`` pose acting in the z = 0
    plane: translation (x, y, 0) and a pure z-rotation (the est_SE2 chart)."""
    x, y, theta = v[..., 0], v[..., 1], v[..., 2]
    t = torch.stack([x, y, torch.zeros_like(x)], -1)
    return pose_from_rt(rotation_z(theta), t)


def t2v_se2(pose: torch.Tensor) -> torch.Tensor:
    """``(..., 4, 4)`` planar pose -> ``(x, y, theta)``; inverse of :func:`v2t_se2`."""
    theta = torch.atan2(pose[..., 1, 0], pose[..., 0, 0])
    return torch.stack([pose[..., 0, 3], pose[..., 1, 3], theta], -1)


def project_se2(pose: torch.Tensor) -> torch.Tensor:
    """Nearest planar pose on the chart: keep (x, y) and the yaw angle. It
    planarizes the SE(3) two-view initialization of the SE(2) estimation."""
    return v2t_se2(t2v_se2(pose))


def planar_deviation(poses: torch.Tensor, cam_in_robot: torch.Tensor) -> float:
    """How far camera poses ``(F, 4, 4)`` lie outside the SE(2) subgroup
    conjugated by the mount: the largest z-translation or off-plane rotation
    entry of ``c X c^-1`` (0 for an exactly planar robot motion)."""
    c = cam_in_robot.to(poses)
    conj = c @ poses @ inverse(c)
    return float(torch.stack([conj[:, 2, 3].abs().max(), conj[:, 2, 0:2].abs().max(),
                              conj[:, 0:2, 2].abs().max()]).max())
