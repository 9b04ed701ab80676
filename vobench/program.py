"""What the benchmark takes from the program under test,
``visual_odometry_tpu_torch``: its configuration and camera types, built
from a configuration file, and the outputs of its entry points, gathered
into the arrays the comparison reads. The entry drivers
(``entries/<entry>.py``) call the program through this module and
``visual_odometry_tpu_torch``'s public entry points."""

from __future__ import annotations


def load_kernels() -> float:
    """Load the program's CUDA kernel library, building it first where the
    checkout has none (``build/vo_torch_kernels/``); returns the build's
    seconds, 0 when it was built already."""
    import time

    from visual_odometry_tpu_torch.ops.kernels import _lib

    t0 = time.perf_counter()
    built = _lib.library_path().exists()
    _lib.library()
    return 0.0 if built else time.perf_counter() - t0


def vo_config(config: dict):
    """The program's ``VOConfig`` with every field the configuration file states."""
    from visual_odometry_tpu_torch.utils.config import VOConfig

    return VOConfig(**config["vo_config"])


def camera(config: dict, device):
    """The tracking camera of the configuration, on ``device``."""
    from visual_odometry_tpu_torch.ops.camera import Camera

    cam = config["camera"]
    return Camera.create(cam["camera_matrix"], rows=cam["rows"], cols=cam["cols"],
                         z_near=cam["z_near"], z_far=cam["z_far"], device=device)


def collect(trajectory, landmark_map, outs) -> dict:
    """(trajectory, map, per-frame outputs) of ``run_sequences_batched``, or of
    ``run_sequence`` with a leading sequence axis added, as the comparison's
    arrays."""
    return {
        "trajectory": trajectory,
        "num_matches": outs.num_matches,
        "num_solver_corr": outs.num_solver_corr,
        "num_inliers": outs.num_inliers,
        "tri_points": outs.tri_points,
        "tri_valid": outs.tri_valid,
        "map_points": landmark_map.points,
        "map_apps": landmark_map.appearances,
        "map_valid": landmark_map.valid,
        "map_count": landmark_map.count,
    }


def add_sequence_axis(raw) -> tuple:
    """``run_sequence``'s (trajectory, map, outputs) with a leading axis of one."""
    trajectory, landmark_map, outs = raw
    return (trajectory[None], type(landmark_map)(*(x[None] for x in landmark_map)),
            type(outs)(*(x[None] for x in outs)))


def block(pool: dict, first: int, count: int) -> tuple:
    """Sequences ``first .. first + count - 1`` of the pool as (points,
    appearances, masks) views, each contiguous."""
    return tuple(pool[k][first:first + count] for k in ("points", "appearances", "masks"))
