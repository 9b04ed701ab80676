"""Dataset readers/writers for the reference's on-disk format
(port of visual_odometry_tpu.utils.io, numpy only).

Host-side numpy re-design of ``/root/reference/src/files_utils.cpp`` and the
readers in ``/root/reference/src/evaluation_utils.cpp``. Column semantics are
preserved exactly so the two frameworks are file-compatible in both
directions (a trajectory we write can be consumed by the reference
``evaluation`` binary and vice versa):

  * ``meas-XXXXX.dat`` (files_utils.cpp:58-93): 3 header lines (seq,
    gt_pose, odom_pose), then per line ``point <seq> <id> <col> <row>
    <10-dim appearance>``.
  * ``world.dat`` (files_utils.cpp:19-57, is_world=true): per line
    ``<id> <x> <y> <z> <10-dim appearance>``.
  * ``camera.dat`` (files_utils.cpp:94-134): ``camera matrix:`` + 3 rows,
    ``cam_transform:`` + 4 rows, ``z_near:/z_far:/width:/height:`` scalars.
  * ``trajectory.dat`` (evaluation_utils.cpp:3-31, files_utils.cpp:155-182):
    per line ``<id> <odom x y th> <gt x y th>``; ground truth is columns
    5-7.

On top of the raw readers this module provides the pad-to-static-shape
loaders that feed the pipeline. The tables are parsed by the C++ parser of
``native/`` (built with ``g++`` at first use) when it builds; when it does
not, one warning carries the compiler's output and ``numpy.loadtxt`` parses.
``load_sequence`` takes the choice as ``parser``: ``"auto"`` (that default),
``"native"`` (a failed build raises) or ``"numpy"``. Both parsers give
identical arrays.
"""

from __future__ import annotations

import os
import re
import warnings
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

MEAS_PATTERN = re.compile(r"^meas-\d.*\.dat$")  # vo_complete.cpp:80
APPEARANCE_DIM = 10


@dataclass(frozen=True)
class CameraParams:
    """Contents of ``camera.dat``."""

    camera_matrix: np.ndarray    # (3, 3)
    cam_in_robot: np.ndarray     # (4, 4) pose of the camera in the robot frame
    z_near: int
    z_far: int
    width: int
    height: int


@dataclass(frozen=True)
class Frame:
    """One measurement frame (unpadded)."""

    ids: np.ndarray          # (N,) int landmark ids (ground-truth DA only)
    points: np.ndarray       # (N, 2) pixel coords (col, row)
    appearances: np.ndarray  # (N, 10)


def list_measurement_files(path: str) -> List[str]:
    """Sorted measurement file names (sorted => frame order, files_utils.cpp:3-18)."""
    return sorted(f for f in os.listdir(path) if MEAS_PATTERN.search(f))


def load_measurements(file_path: str) -> Frame:
    """Parse one ``meas-XXXXX.dat``."""
    return _measurements(file_path, "auto")


def _measurements(file_path: str, parser: str) -> Frame:
    data = _parse_table(file_path, 3, 1, 14, parser)
    return Frame(
        ids=data[:, 1].astype(np.int32),
        points=data[:, 2:4].astype(np.float32),
        appearances=data[:, 4:14].astype(np.float32),
    )


def load_world(file_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse ``world.dat`` -> (ids (N,), points (N, 3), appearances (N, 10))."""
    data = _parse_table(file_path, 0, 0, 14, "auto")
    return (
        data[:, 0].astype(np.int32),
        data[:, 1:4].astype(np.float32),
        data[:, 4:14].astype(np.float32),
    )


PARSERS = ("auto", "native", "numpy")


def _native(parser: str):
    """The native parser's module if ``parser`` takes it, else None: for
    "native" it must build (NativeBuildFailure otherwise); for "auto" a failed
    build warns, with the compiler's output, and numpy parses."""
    if parser not in PARSERS:
        raise ValueError(f"parser={parser!r}; expected one of {PARSERS}")
    if parser == "numpy":
        return None
    from ..native import dataloader

    try:
        dataloader.library()
    except dataloader.NativeBuildFailure as e:
        if parser == "native":
            raise
        warnings.warn(f"the native dataset parser is unavailable, parsing with numpy: {e}",
                      RuntimeWarning, stacklevel=3)
        return None
    return dataloader


def _parse_table(file_path, skiprows, first_col, n_cols, parser):
    native = _native(parser)
    if native is not None:
        out = native.parse_table(file_path, skiprows, first_col, n_cols)
        if out is not None:
            return out
        if parser == "native":
            raise OSError(f"the native parser cannot read {file_path}")
    return np.loadtxt(
        file_path,
        skiprows=skiprows,
        usecols=range(first_col, first_col + n_cols),
        dtype=np.float64,
        ndmin=2,
    )


def load_camera_params(file_path: str) -> CameraParams:
    """Parse ``camera.dat`` (files_utils.cpp:94-134 keyword scanner)."""
    k = np.eye(3, dtype=np.float32)
    h = np.eye(4, dtype=np.float32)
    ints = {}
    with open(file_path) as f:
        lines = [ln for ln in f.read().splitlines()]
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line:
            continue
        key = line.split()[0]
        if key == "camera":
            for r in range(3):
                k[r] = np.fromstring(lines[i], sep=" ")[:3]
                i += 1
        elif key == "cam_transform:":
            for r in range(4):
                h[r] = np.fromstring(lines[i], sep=" ")[:4]
                i += 1
        elif key in ("z_near:", "z_far:", "width:", "height:"):
            ints[key[:-1]] = int(float(line.split()[1]))
    return CameraParams(
        camera_matrix=k,
        cam_in_robot=h,
        z_near=ints["z_near"],
        z_far=ints["z_far"],
        width=ints["width"],
        height=ints["height"],
    )


def load_trajectory(file_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``trajectory.dat`` -> (odom (F, 3), gt (F, 3)), each (x, y, theta)."""
    data = np.loadtxt(file_path, dtype=np.float64, ndmin=2)
    return data[:, 1:4].astype(np.float32), data[:, 4:7].astype(np.float32)


def gt_poses_se3(gt_xyt: np.ndarray) -> np.ndarray:
    """Planar gt (x, y, theta) -> (F, 4, 4) SE(3), RotationZ convention
    (evaluation_utils.cpp:22-27)."""
    f = gt_xyt.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    c, s = np.cos(gt_xyt[:, 2]), np.sin(gt_xyt[:, 2])
    poses[:, 0, 0] = c
    poses[:, 0, 1] = -s
    poses[:, 1, 0] = s
    poses[:, 1, 1] = c
    poses[:, 0, 3] = gt_xyt[:, 0]
    poses[:, 1, 3] = gt_xyt[:, 1]
    return poses


# ---------------------------------------------------------------------------
# Padded loading for the pipeline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PaddedSequence:
    """A whole sequence stacked into static-shape arrays.

    ``points[f, s]`` is measurement slot ``s`` of frame ``f``; slots past the
    frame's true count are masked out (``mask[f, s] == False``) and carry
    harmless sentinels (points 0, appearances +inf so they can never match).
    """

    points: np.ndarray        # (F, S, 2) float32
    appearances: np.ndarray   # (F, S, 10) float32
    ids: np.ndarray           # (F, S) int32, -1 on padding
    mask: np.ndarray          # (F, S) bool
    counts: np.ndarray        # (F,) int32


# Sq-distance from padding to anything real is astronomically large, while
# its square (1e30) still fits float32 — no inf/nan can leak out of the
# gram-trick distance computation.
PAD_APPEARANCE = 1e15


def pad_frames(frames: List[Frame], n_slots: Optional[int] = None) -> PaddedSequence:
    counts = np.array([len(f.points) for f in frames], np.int32)
    max_n = int(counts.max()) if len(frames) else 0
    if n_slots is None:
        n_slots = -(-max_n // 128) * 128  # round up to the f32 lane count
    if max_n > n_slots:
        raise ValueError(f"frame with {max_n} points exceeds n_slots={n_slots}")
    f = len(frames)
    points = np.zeros((f, n_slots, 2), np.float32)
    apps = np.full((f, n_slots, APPEARANCE_DIM), PAD_APPEARANCE, np.float32)
    ids = np.full((f, n_slots), -1, np.int32)
    mask = np.zeros((f, n_slots), bool)
    for i, frame in enumerate(frames):
        n = len(frame.points)
        points[i, :n] = frame.points
        apps[i, :n] = frame.appearances
        ids[i, :n] = frame.ids
        mask[i, :n] = True
    return PaddedSequence(points=points, appearances=apps, ids=ids, mask=mask, counts=counts)


def load_sequence(data_dir: str, n_slots: Optional[int] = None,
                  parser: str = "auto") -> PaddedSequence:
    """Load + pad a whole measurement sequence. The native parser reads and
    pads every frame in one call on a pool of threads; numpy reads the files
    one by one and pads them (``pad_frames``)."""
    native = _native(parser)
    if native is not None:
        out = native.load_sequence_native(data_dir, n_slots, PAD_APPEARANCE)
        if out is not None:
            points, apps, ids, mask, counts = out
            return PaddedSequence(points=points, appearances=apps, ids=ids, mask=mask,
                                  counts=counts)
        if parser == "native":
            raise ValueError(f"the native parser cannot load {data_dir}: a file it cannot "
                             f"read, no meas-*.dat, or a frame over n_slots={n_slots}")
    files = list_measurement_files(data_dir)
    frames = [_measurements(os.path.join(data_dir, f), "numpy") for f in files]
    return pad_frames(frames, n_slots)


# ---------------------------------------------------------------------------
# Writers (output-file contract of README.md:56-68)
# ---------------------------------------------------------------------------


def write_vectors(file_path: str, vectors: np.ndarray) -> None:
    """One vector per row, space separated (files_utils.h:17-28)."""
    np.savetxt(file_path, np.asarray(vectors), fmt="%g")


def robot_trajectory(poses: np.ndarray, cam_in_robot: np.ndarray) -> np.ndarray:
    """Chain relative camera poses into absolute robot poses.

    Mirrors ``save_trajectory`` (files_utils.cpp:136-153): the stored poses
    are *relative* camera transforms X_i (previous camera in current camera
    frame); absolute robot pose i is the running product
    ``H <- H * camInRobot * X_i^-1 * camInRobot^-1``.
    Returns (F, 4, 4).
    """
    h = np.eye(4, dtype=np.float64)
    cir = cam_in_robot.astype(np.float64)
    icir = np.linalg.inv(cir)
    out = np.zeros((len(poses), 4, 4), np.float32)
    for i, x in enumerate(poses):
        h = h @ cir @ np.linalg.inv(x.astype(np.float64)) @ icir
        out[i] = h
    return out


def save_trajectory(
    file_path: str,
    poses: np.ndarray,
    cam_in_robot: Optional[np.ndarray] = None,
    save_rotation: bool = False,
) -> np.ndarray:
    """Write the robot trajectory file; returns the absolute poses.

    With ``save_rotation`` each pose emits 4 lines (t row then 3 R rows),
    the ``trajectory_est_data.txt`` format that ``get_est_data``
    (evaluation_utils.cpp:32-64) reads back.
    """
    if cam_in_robot is None:
        cam_in_robot = np.eye(4, dtype=np.float32)
    absolute = robot_trajectory(poses, cam_in_robot)
    with open(file_path, "w") as f:
        for h in absolute:
            f.write("%g %g %g\n" % tuple(h[:3, 3]))
            if save_rotation:
                for r in range(3):
                    f.write("%g %g %g\n" % tuple(h[r, :3]))
    return absolute


def load_est_trajectory(file_path: str) -> np.ndarray:
    """Read back a ``save_rotation`` trajectory file (evaluation_utils.cpp:32-64)."""
    vals = np.loadtxt(file_path, dtype=np.float64, ndmin=2)
    assert vals.shape[0] % 4 == 0, "expected 4-line pose blocks"
    f = vals.shape[0] // 4
    poses = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    for i in range(f):
        poses[i, :3, 3] = vals[4 * i]
        poses[i, :3, :3] = vals[4 * i + 1 : 4 * i + 4]
    return poses


def save_gt_trajectory(trajectory_dat: str, out_path: str = "trajectory_gt.txt") -> None:
    """Extract gt (x, y, 0) from trajectory.dat (files_utils.cpp:155-182)."""
    _, gt = load_trajectory(trajectory_dat)
    pts = np.concatenate([gt[:, :2], np.zeros((len(gt), 1), np.float32)], axis=1)
    write_vectors(out_path, pts)
