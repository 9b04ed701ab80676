"""The end-to-end monocular VO pipeline, fused path
(port of visual_odometry_tpu.models.pipeline).

``run_sequence`` bootstraps on frames 0/1 (match, 8-point init, triangulate,
seed the map), then runs every tracked frame through the fused path: all
consecutive-pair matches at once (K1), the world-join candidate chains (K2),
the lane-aligned pixel and appearance gathers (K3), and the whole frame loop
in one launch (K4). The landmark map never feeds back into tracking, so it
is folded once at the end from the stream of per-frame triangulations.

Data-flow invariants of the reference (vo_complete.cpp): poses are "previous
camera in current camera"; triangulation happens in the previous frame's
coordinates; map points are kept in frame-0 camera coordinates.

Backends follow ``VOConfig.matcher_backend`` (K1) and ``scan_backend``
(K2-K4): ``auto`` launches the kernels for CUDA tensors and runs their plain
PyTorch versions for CPU tensors.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import epipolar, matching, se3, triangulation
from ..ops.camera import Camera
from ..ops.kernels import frame_kernel, gather_kernel
from ..utils.config import VOConfig
from . import landmark_map
from .landmark_map import LandmarkMap


class FrameData(NamedTuple):
    """One padded measurement frame (or a stack of them along dim 0)."""

    points: torch.Tensor       # (S, 2)
    appearances: torch.Tensor  # (S, D)
    mask: torch.Tensor         # (S,) bool
    ids: torch.Tensor          # (S,) int32 ground-truth landmark ids (-1 on padding)


class VOState(NamedTuple):
    """Tracker state after a frame: what a resumed run would carry."""

    ref: FrameData
    point_lookup: torch.Tensor  # (S,) int32 ref meas idx -> triangulated slot | -1
    tri_points: torch.Tensor    # (S, 3) previous-frame coords
    tri_valid: torch.Tensor     # (S,) bool
    x_curr: torch.Tensor        # (4, 4) pose of frame k-1 in frame k
    history: torch.Tensor       # (4, 4) frame k-1 coords -> frame 0 coords
    map: LandmarkMap


class FrameOutput(NamedTuple):
    pose: torch.Tensor             # (F, 4, 4) relative poses
    num_matches: torch.Tensor      # (F,) int32 image-image correspondences
    num_solver_corr: torch.Tensor  # (F,) int32 correspondences seen by PICP
    num_inliers: torch.Tensor      # (F,) int32 inliers at the last GN round
    chi_inliers: torch.Tensor      # (F,) float32
    tri_points: torch.Tensor       # (F, S, 3) triangulation, prev-frame coords
    tri_apps: torch.Tensor         # (F, S, D) triangulated appearances
    tri_valid: torch.Tensor        # (F, S) bool
    join_overflow: torch.Tensor    # (F,) int32 lanes past the join-chain depth


class InitTriangulation(NamedTuple):
    """The bootstrap's triangulated observations (head of the map stream)."""

    points: torch.Tensor  # (S, 3) frame-0 camera coords
    apps: torch.Tensor    # (S, D)
    valid: torch.Tensor   # (S,) bool


class BootstrapError(RuntimeError):
    """The two-view bootstrap cannot produce a usable initialization (< 8
    correspondences: the reference aborts, epipolar_utils.cpp:104-108)."""


class FusedJoinDepthError(RuntimeError):
    """A tracked frame has a measurement targeted by more than
    ``VOConfig.fused_join_depth`` same-frame correspondences; past that
    multiplicity the precomputed join chains cannot guarantee the reference's
    first-successfully-triangulated join (vo_complete.cpp:55-63). Raise
    ``fused_join_depth`` to at least the reported multiplicity."""


class BootstrapDiagnostics(NamedTuple):
    num_correspondences: torch.Tensor  # () int32 valid matches
    degeneracy_score: torch.Tensor     # () median homography transfer residual


# Median transfer residual below which a pair is homography-explained.
DEGENERACY_THRESHOLD = 1e-4


def _match(config: VOConfig, ref: FrameData, cur: FrameData) -> matching.Correspondences:
    return matching.match_appearances(
        ref.appearances, ref.mask, cur.appearances, cur.mask,
        config.match_radius, backend=config.matcher_backend,
    )


def _lookup_from_corr(corr: matching.Correspondences, tri_ok, n_slots: int) -> torch.Tensor:
    """(meas idx in frame 2) -> correspondence slot, first-wins (vo_complete.cpp:55-63)."""
    dev = corr.idx2.device
    big = n_slots + 1
    slots = torch.arange(n_slots, dtype=torch.int64, device=dev)
    live = corr.valid & tri_ok
    lut = torch.full((n_slots,), big, dtype=torch.int64, device=dev)
    lut = lut.scatter_reduce(0, corr.idx2.long()[live], slots[live], reduce="amin")
    return torch.where(lut <= n_slots, lut, -1).to(torch.int32)


def check_join_overflow(outs: FrameOutput) -> None:
    """Raise :class:`FusedJoinDepthError` if any frame overflowed the chains."""
    per_frame = outs.join_overflow.cpu().numpy().reshape(-1)
    total = int(per_frame.sum())
    if total:
        frames = np.nonzero(per_frame)[0][:8].tolist()
        raise FusedJoinDepthError(
            f"{total} correspondence lanes across frames {frames}... exceeded the "
            f"world-join chain depth (worst frame: {int(per_frame.max())} lanes); "
            "first-wins join semantics (vo_complete.cpp:55-63) are not guaranteed "
            "past it. Raise VOConfig.fused_join_depth."
        )


def bootstrap_diagnostics(config: VOConfig, frame0: FrameData,
                          frame1: FrameData) -> BootstrapDiagnostics:
    """Match the bootstrap pair and score its two-view conditioning."""
    corr = _match(config, frame0, frame1)
    res, ok = epipolar.homography_transfer_residuals(
        corr.idx1, corr.idx2, corr.valid,
        frame0.points, frame1.points, frame0.mask, frame1.mask,
    )
    cnt = int(ok.sum())
    med = torch.sort(torch.where(ok, res, float("inf"))).values[max(cnt - 1, 0) // 2]
    return BootstrapDiagnostics(
        num_correspondences=corr.valid.sum().to(torch.int32),
        degeneracy_score=med if cnt > 0 else torch.tensor(float("nan")),
    )


def check_bootstrap(
    config: VOConfig,
    frame0: FrameData,
    frame1: FrameData,
    min_correspondences: int = 8,
    degeneracy_threshold: float = DEGENERACY_THRESHOLD,
) -> BootstrapDiagnostics:
    """Raise :class:`BootstrapError` on < ``min_correspondences`` matches and
    warn on a homography-explained (degenerate) bootstrap pair."""
    d = bootstrap_diagnostics(config, frame0, frame1)
    n = int(d.num_correspondences)
    if n < min_correspondences:
        raise BootstrapError(
            f"two-view bootstrap needs >= {min_correspondences} correspondences, got {n} "
            "(reference aborts here, epipolar_utils.cpp:104-108)"
        )
    score = float(d.degeneracy_score)
    if math.isnan(score):
        warnings.warn(
            "too few correspondences survived the homography fit to assess bootstrap "
            "degeneracy (no transfer residuals measured)", RuntimeWarning, stacklevel=2,
        )
    elif score < degeneracy_threshold:
        warnings.warn(
            f"bootstrap pair is homography-explained (median transfer residual {score:.2e} "
            f"< {degeneracy_threshold:.0e}): pure rotation / stationary / planar-only motion "
            "makes the 8-point translation and the monocular scale degenerate",
            RuntimeWarning, stacklevel=2,
        )
    return d


def initialize(
    camera: Camera,
    config: VOConfig,
    frame0: FrameData,
    frame1: FrameData,
    corr: "matching.Correspondences | None" = None,
) -> Tuple[VOState, torch.Tensor]:
    """Two-frame bootstrap (vo_complete.cpp:95-148): match, 8-point init,
    triangulate, seed the map. Returns (state, x_init = frame 0 in frame 1)."""
    s = config.n_slots
    if corr is None:
        corr = _match(config, frame0, frame1)
    x_init = epipolar.estimate_transform(
        camera.camera_matrix, corr.idx1, corr.idx2, corr.valid,
        frame0.points, frame1.points, frame0.mask, frame1.mask,
    )
    tri, ok = triangulation.triangulate_correspondences(
        camera.camera_matrix, x_init, corr.idx1, corr.idx2, corr.valid,
        frame0.points, frame1.points,
    )
    # Triangulated appearances come from the SECOND frame (utils.cpp:127).
    tri_apps = frame1.appearances[corr.idx2.long()]
    map_state = LandmarkMap.empty(
        config.map_capacity, frame0.appearances.shape[-1], tri.dtype, tri.device
    )
    map_state = landmark_map.update(map_state, tri, tri_apps, ok)
    state = VOState(
        ref=frame1,
        point_lookup=_lookup_from_corr(corr, ok, s),
        tri_points=tri,
        tri_valid=ok,
        x_curr=x_init,
        history=se3.inverse(x_init),
        map=map_state,
    )
    return state, x_init


def _batched_match(config: VOConfig, frames: FrameData,
                   prev: FrameData) -> matching.Correspondences:
    """All consecutive-pair correspondences at once (matching is pose-independent)."""
    return matching.match_appearances_batch(
        prev.appearances, prev.mask, frames.appearances, frames.mask,
        radius=config.match_radius, backend=config.matcher_backend,
    )


def _run_fused(camera: Camera, config: VOConfig, x_curr, tri_points, tri_valid,
               cand: frame_kernel.JoinCandidates, prev: FrameData, cur: FrameData,
               corr_all: matching.Correspondences) -> FrameOutput:
    """The whole frame loop as one K4 launch, with the pose-independent
    gathers (K3) batched over frames around it."""
    backend = config.scan_backend
    safe1 = torch.where(corr_all.valid, corr_all.idx1, 0)
    safe2 = torch.where(corr_all.valid, corr_all.idx2, 0)
    px1, py1, px2, py2 = gather_kernel.take_lanes(
        [prev.points[..., 0], prev.points[..., 1], cur.points[..., 0], cur.points[..., 1]],
        [safe1, safe1, safe2, safe2], backend=backend,
    )
    prev_al = torch.stack([px1, py1], dim=-1)
    cur_al = torch.stack([px2, py2], dim=-1)
    poses, tri_all, tri_ok_all, solver_stats = frame_kernel.track_frames(
        camera.camera_matrix, camera.params(), x_curr,
        tri_points.contiguous(), tri_valid.contiguous(), cand,
        prev_al, cur_al, corr_all.valid.contiguous(),
        config.gn_iterations, config.kernel_threshold, config.damping,
        config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
        keep_outliers=config.keep_outliers, warm_start=config.warm_start,
        min_num_inliers=config.min_num_inliers, min_iterations=config.gn_min_iterations,
        backend=backend,
    )
    d_app = cur.appearances.shape[-1]
    tri_apps_all = torch.stack(
        gather_kernel.take_lanes(
            [cur.appearances[..., j] for j in range(d_app)], [safe2] * d_app, backend=backend
        ),
        dim=-1,
    )
    return FrameOutput(
        pose=poses,
        num_matches=corr_all.valid.sum(dim=1).to(torch.int32),
        num_solver_corr=solver_stats[:, 3].to(torch.int32),
        num_inliers=solver_stats[:, 2].to(torch.int32),
        chi_inliers=solver_stats[:, 0],
        tri_points=tri_all,
        tri_apps=tri_apps_all,
        tri_valid=tri_ok_all,
        join_overflow=cand.overflow.sum(dim=1).to(torch.int32),
    )


def _track(camera: Camera, config: VOConfig, points, appearances, masks, ids):
    """Bootstrap + track all frames; no map fold. Returns (x_init, per-frame
    outputs for frames 2.., the bootstrap triangulation)."""
    f0 = FrameData(points[0], appearances[0], masks[0], ids[0])
    f1 = FrameData(points[1], appearances[1], masks[1], ids[1])
    corr01 = _match(config, f0, f1)
    state, x_init = initialize(camera, config, f0, f1, corr=corr01)
    # The map was empty, so its first n_slots rows ARE the bootstrap
    # observations in frame-0 coords, compacted in incoming order.
    s = config.n_slots
    init_tri = InitTriangulation(
        points=state.map.points[:s], apps=state.map.appearances[:s], valid=state.map.valid[:s]
    )

    rest = FrameData(points[2:], appearances[2:], masks[2:], ids[2:])
    prev = FrameData(points[1:-1], appearances[1:-1], masks[1:-1], ids[1:-1])
    corr_all = _batched_match(config, rest, prev)
    # Step i's world join looks up step i-1's correspondence targets (the
    # bootstrap pair's for the first tracked frame).
    src_idx2 = torch.cat([corr01.idx2[None], corr_all.idx2[:-1]], dim=0).contiguous()
    src_valid = torch.cat([corr01.valid[None], corr_all.valid[:-1]], dim=0).contiguous()
    cand = frame_kernel.join_candidates(
        src_idx2, src_valid, corr_all.idx1.contiguous(), corr_all.valid.contiguous(),
        config.fused_join_depth, backend=config.scan_backend,
    )
    outs = _run_fused(camera, config, state.x_curr, state.tri_points, state.tri_valid,
                      cand, prev, rest, corr_all)
    return x_init, outs, init_tri


def _run(camera: Camera, config: VOConfig, points, appearances, masks, ids):
    config.check_supported()
    if points.shape[1] != config.n_slots:
        raise ValueError(f"frames have {points.shape[1]} slots, config.n_slots={config.n_slots}")
    if points.shape[0] < 3:
        raise ValueError("a sequence needs at least 3 frames (bootstrap pair + one tracked)")
    x_init, outs, init_tri = _track(camera, config, points, appearances, masks, ids)

    # Map fold (vo_complete.cpp:175-176): chains[j] maps frame j+1 coords to
    # frame 0, the running product of inverse relative poses.
    inv_poses = se3.inverse(outs.pose)
    chains = se3.chain_products(torch.cat([se3.inverse(x_init)[None], inv_poses[:-1]], dim=0))
    tri_world = se3.transform_points(chains, outs.tri_points)
    d = appearances.shape[-1]
    final_map = landmark_map.merge_stream(
        torch.cat([init_tri.points, tri_world.reshape(-1, 3)]),
        torch.cat([init_tri.apps, outs.tri_apps.reshape(-1, d)]),
        torch.cat([init_tri.valid, outs.tri_valid.reshape(-1)]),
        config.map_capacity,
    )
    eye = torch.eye(4, dtype=points.dtype, device=points.device)
    trajectory = torch.cat([eye[None], x_init[None], outs.pose], dim=0)
    return trajectory, final_map, outs


def run_sequence(
    camera: Camera,
    config: VOConfig,
    points: torch.Tensor,       # (F, S, 2)
    appearances: torch.Tensor,  # (F, S, D)
    masks: torch.Tensor,        # (F, S) bool
    validate: bool = True,
) -> Tuple[torch.Tensor, LandmarkMap, FrameOutput]:
    """The vo_complete pipeline over a stacked sequence on the tensors' device.

    Returns (trajectory (F, 4, 4) of relative poses — identity, the epipolar
    init, then one PICP pose per tracked frame — the final map in frame-0
    camera coordinates, and per-frame diagnostics). ``validate`` raises
    :class:`FusedJoinDepthError` when a frame overflowed the join chains.
    """
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    out = _run(camera, config, points, appearances, masks, ids)
    if validate:
        check_join_overflow(out[2])
    return out
