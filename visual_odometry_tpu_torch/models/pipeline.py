"""The end-to-end monocular VO pipeline (port of visual_odometry_tpu.models.pipeline).

``run_sequence`` bootstraps on frames 0/1 (match, 8-point init, triangulate,
seed the map), then runs every tracked frame through the fused path: all
consecutive-pair matches at once (K1), the world-join candidate chains (K2),
the lane-aligned pixel and appearance gathers (K3), and the whole frame loop
in one launch (K4, or K5 with ``VOConfig.planar``). The landmark map never
feeds back into tracking, so it is folded once at the end from the stream of
per-frame triangulations. ``scan_backend="step"`` runs the same frames as a
Python loop over :func:`frame_step` instead, each frame solved through
``ops/picp.solve`` (K6 on the card) or ``ops/picp_se2.solve_se2``.

``continue_sequence`` resumes from a carried :class:`VOState` (what
``utils/checkpoint`` saves), ``run_sequence_known_da`` associates by
ground-truth landmark id, and ``relocalize_frame`` matches one frame against
the whole map (K7) and solves its pose (K6).

Data-flow invariants of the reference (vo_complete.cpp): poses are "previous
camera in current camera"; triangulation happens in the previous frame's
coordinates; map points are kept in frame-0 camera coordinates.

Backends follow ``VOConfig.matcher_backend`` (K1, K7), ``scan_backend``
(K2-K5) and ``solver_backend`` (K6): ``auto`` launches the kernels for CUDA
tensors and runs their plain PyTorch versions for CPU tensors.

The steps of ``run_sequence``, ``continue_sequence`` and ``relocalize_frame``
run inside ``utils.profiling.stage`` blocks: ``vo/<stage>`` ranges in a
``torch.profiler`` trace. Each call of the fused path that makes the host
wait for the card is a ``utils.profiling.host_wait`` block: counted, and a
``wait/<stage>.<site>`` range inside its stage's.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import epipolar, matching, picp, picp_se2, se3, triangulation
from ..ops.camera import Camera
from ..ops.kernels import epipolar_kernel, frame_kernel, gather_kernel
from ..utils.config import VOConfig
from ..utils.profiling import host_wait, stage
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
    gn_rounds: torch.Tensor        # (F,) int32 GN rounds the frame's solve ran


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


def match_by_ids(ids1, mask1, ids2, mask2) -> matching.Correspondences:
    """Ground-truth data association by landmark id
    (``extract_correspondences_images``, vo_daKnown.cpp:19-33): a pair
    (ref idx, curr idx) for every id present in both frames, in
    reference-index order. Ids are unique per frame, so the first equal
    column is the only one. Takes (S,) rows or (B, S) stacks."""
    s = ids1.shape[-1]
    eq = (ids1[..., :, None] == ids2[..., None, :]) & mask1[..., :, None] & mask2[..., None, :]
    slots = torch.arange(s, dtype=torch.int32, device=ids1.device).expand(ids1.shape)
    return matching.Correspondences(
        idx1=slots, idx2=eq.to(torch.int8).argmax(dim=-1).to(torch.int32), valid=eq.any(dim=-1)
    )


def _match(config: VOConfig, use_known_da: bool, ref: FrameData,
           cur: FrameData) -> matching.Correspondences:
    if use_known_da:
        return match_by_ids(ref.ids, ref.mask, cur.ids, cur.mask)
    return matching.match_appearances(
        ref.appearances, ref.mask, cur.appearances, cur.mask,
        config.match_radius, backend=config.matcher_backend,
    )


def check_join_overflow(outs: FrameOutput) -> None:
    """Raise :class:`FusedJoinDepthError` if any frame overflowed the chains."""
    with stage("overflow_check"), host_wait("overflow_check.fetch"):
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


def bootstrap_diagnostics(config: VOConfig, frame0: FrameData, frame1: FrameData,
                          use_known_da: bool = False) -> BootstrapDiagnostics:
    """Match the bootstrap pair and score its two-view conditioning."""
    corr = _match(config, use_known_da, frame0, frame1)
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
    use_known_da: bool = False,
    min_correspondences: int = 8,
    degeneracy_threshold: float = DEGENERACY_THRESHOLD,
) -> BootstrapDiagnostics:
    """Raise :class:`BootstrapError` on < ``min_correspondences`` matches and
    warn on a homography-explained (degenerate) bootstrap pair."""
    return judge_bootstrap(bootstrap_diagnostics(config, frame0, frame1, use_known_da),
                           min_correspondences, degeneracy_threshold)


def judge_bootstrap(d: BootstrapDiagnostics, min_correspondences: int = 8,
                    degeneracy_threshold: float = DEGENERACY_THRESHOLD) -> BootstrapDiagnostics:
    """:func:`check_bootstrap` on diagnostics already taken."""
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
            "degeneracy (no transfer residuals measured)", RuntimeWarning, stacklevel=3,
        )
    elif score < degeneracy_threshold:
        warnings.warn(
            f"bootstrap pair is homography-explained (median transfer residual {score:.2e} "
            f"< {degeneracy_threshold:.0e}): pure rotation / stationary / planar-only motion "
            "makes the 8-point translation and the monocular scale degenerate",
            RuntimeWarning, stacklevel=3,
        )
    return d


def initialize(
    camera: Camera,
    config: VOConfig,
    frame0: FrameData,
    frame1: FrameData,
    use_known_da: bool = False,
    corr: "matching.Correspondences | None" = None,
) -> Tuple[VOState, torch.Tensor]:
    """Two-frame bootstrap (vo_complete.cpp:95-148): match, 8-point init,
    triangulate, seed the map. Returns (state, x_init = frame 0 in frame 1).
    The batch of one of :func:`initialize_batched`: the same bits."""
    if corr is None:
        corr = _match(config, use_known_da, frame0, frame1)
    one = lambda t: type(t)(*(x[None] for x in t))   # noqa: E731
    state, x = _bootstrap(camera, config, one(frame0), one(frame1), one(corr))
    return _index_state(state, 0), x[0]


def initialize_batched(
    camera: Camera,
    config: VOConfig,
    frame0: FrameData,
    frame1: FrameData,
    use_known_da: bool = False,
    corr: "matching.Correspondences | None" = None,
) -> Tuple[VOState, torch.Tensor]:
    """:func:`initialize` over a leading batch axis of B frame pairs (the
    counterpart of the JAX package's ``jax.vmap(pipeline.initialize)``):
    one pair match, then on the card one launch of P1's bootstrap instance
    for the whole batch (pose, triangulation, seeded maps, lookups and
    histories; no host sync). Returns (state with a leading batch axis on
    every tensor, x_init (B, 4, 4)). A pair's result has the bits it has
    alone: P1 is batch-invariant by construction, and its plain version
    writes every product and sum per element in a fixed order (no batched
    matmul, no reduction across the batch)."""
    if corr is None:
        corr = _batched_match(config, use_known_da, frame1, frame0)
    return _bootstrap(camera, config, frame0, frame1, corr)


def _bootstrap(camera: Camera, config: VOConfig, frame0: FrameData, frame1: FrameData,
               corr: matching.Correspondences) -> Tuple[VOState, torch.Tensor]:
    """The bootstrap after the match on (B, ...) stacks
    (``epipolar_kernel.bootstrap_batched``)."""
    mount = None
    if config.planar:
        # Planarize the two-view init so the whole trajectory stays in the
        # conjugated SE(2) subgroup the solver moves in (ops/picp_se2).
        mount = config.planar_mount()
        mount = np.eye(4, dtype=np.float32) if mount is None else mount
    boot = epipolar_kernel.bootstrap_batched(
        camera.camera_matrix, corr.idx1, corr.idx2, corr.valid, frame0.points, frame1.points,
        frame0.mask, frame1.mask, frame1.appearances, config.map_capacity, mount)
    state = VOState(ref=frame1, point_lookup=boot.point_lookup, tri_points=boot.tri_points,
                    tri_valid=boot.tri_valid, x_curr=boot.x_init, history=boot.history,
                    map=boot.map)
    return state, boot.x_init


def _index_state(state: VOState, i: int) -> VOState:
    """Element ``i`` of a batched :class:`VOState`."""
    return VOState(*(type(x)(*(y[i] for y in x)) if isinstance(x, tuple) else x[i]
                     for x in state))


def frame_step(
    camera: Camera,
    config: VOConfig,
    state: VOState,
    frame: FrameData,
    use_known_da: bool = False,
    corr: "matching.Correspondences | None" = None,
    merge_map: bool = True,
) -> Tuple[VOState, FrameOutput]:
    """Track one new frame (the body of vo_complete.cpp:150-179). ``corr``
    supplies precomputed (ref, frame) correspondences; ``merge_map=False``
    skips the landmark-map merge for callers that fold the whole stream once.
    The returned :class:`FrameOutput` holds one frame (no leading dim)."""
    s = config.n_slots
    if corr is None:
        corr = _match(config, use_known_da, state.ref, frame)

    # Join image-image matches with the previous triangulation through the
    # lookup (the O(N*M) scan of vo_complete.cpp:52-66).
    safe1 = torch.where(corr.valid, corr.idx1, 0).long()
    world_slot = torch.where(corr.valid, state.point_lookup[safe1], -1)
    has_world = corr.valid & (world_slot >= 0)
    safe_slot = torch.where(has_world, world_slot, 0).long()
    solver_weight = (has_world & state.tri_valid[safe_slot]).to(frame.points.dtype)

    # Model points: previous triangulation moved into the previous camera's
    # frame (vo_complete.cpp:159: X_curr * triangulated).
    world_points = se3.transform_points(state.x_curr, state.tri_points)[safe_slot]
    measured = frame.points[torch.where(corr.valid, corr.idx2, 0).long()]

    # Solver start: identity each frame (vo_complete.cpp:161), or the previous
    # relative pose as a constant-velocity warm start.
    start = state.x_curr if config.warm_start else torch.eye(
        4, dtype=world_points.dtype, device=world_points.device)
    knobs = dict(kernel_threshold=config.kernel_threshold, damping=config.damping,
                 keep_outliers=config.keep_outliers, tolerance=config.gn_tolerance,
                 min_num_inliers=config.min_num_inliers,
                 min_iterations=config.gn_min_iterations)
    solver_cam = picp.with_pose(camera, start)
    rounds = []
    if config.planar:
        solved_cam, stats = picp_se2.solve_se2(
            solver_cam, world_points, measured, solver_weight, config.gn_iterations,
            cam_in_robot=config.planar_mount(), rounds_out=rounds, **knobs)
    else:
        solved_cam, stats = picp.solve(
            solver_cam, world_points, measured, solver_weight, config.gn_iterations,
            backend=config.solver_backend, rounds_out=rounds, **knobs)
    pose = solved_cam.world_in_camera  # frame k-1 expressed in frame k

    # Re-triangulate the pair (prev, curr) in prev-frame coords.
    tri, ok = triangulation.triangulate_correspondences(
        camera.camera_matrix, pose, corr.idx1, corr.idx2, corr.valid,
        state.ref.points, frame.points,
    )
    tri_apps = frame.appearances[corr.idx2.long()]
    if merge_map:
        # Map merge in frame-0 coords (vo_complete.cpp:175).
        new_map = landmark_map.update(
            state.map, se3.transform_points(state.history, tri), tri_apps, ok)
    else:
        new_map = state.map

    new_state = VOState(
        ref=frame,
        point_lookup=matching.lookup_from_corr(corr, ok, s),
        tri_points=tri,
        tri_valid=ok,
        x_curr=pose,
        history=state.history @ se3.inverse(pose),
        map=new_map,
    )
    out = FrameOutput(
        pose=pose,
        num_matches=corr.valid.sum().to(torch.int32),
        num_solver_corr=solver_weight.sum().to(torch.int32),
        num_inliers=stats.num_inliers,
        chi_inliers=stats.chi_inliers,
        tri_points=tri,
        tri_apps=tri_apps,
        tri_valid=ok,
        join_overflow=torch.zeros((), dtype=torch.int32, device=pose.device),
        gn_rounds=torch.as_tensor(rounds[0], dtype=torch.int32, device=pose.device),
    )
    return new_state, out


def _step_loop(camera: Camera, config: VOConfig, state: VOState, frames: FrameData,
               corr_all: matching.Correspondences, use_known_da: bool,
               merge_map: bool) -> Tuple[VOState, FrameOutput]:
    """The frame loop as :func:`frame_step` calls (``scan_backend="step"``)."""
    outs = []
    for i in range(frames.points.shape[0]):
        state, out = frame_step(
            camera, config, state, FrameData(*(x[i] for x in frames)), use_known_da,
            corr=matching.Correspondences(*(x[i] for x in corr_all)), merge_map=merge_map,
        )
        outs.append(out)
    return state, FrameOutput(*(torch.stack(x) for x in zip(*outs)))


def _batched_match(config: VOConfig, use_known_da: bool, frames: FrameData,
                   prev: FrameData) -> matching.Correspondences:
    """All consecutive-pair correspondences at once (matching is pose-independent)."""
    if use_known_da:
        return match_by_ids(prev.ids, prev.mask, frames.ids, frames.mask)
    return matching.match_appearances_batch(
        prev.appearances, prev.mask, frames.appearances, frames.mask,
        radius=config.match_radius, backend=config.matcher_backend,
    )


def _run_fused(camera: Camera, config: VOConfig, x_curr, tri_points, tri_valid,
               cand: frame_kernel.JoinCandidates, prev: FrameData, cur: FrameData,
               corr_all: matching.Correspondences) -> FrameOutput:
    """The whole frame loop as one K4 (planar: K5) launch, with the
    pose-independent gathers (K3) batched over frames around it."""
    backend = config.scan_backend
    safe1 = torch.where(corr_all.valid, corr_all.idx1, 0)
    safe2 = torch.where(corr_all.valid, corr_all.idx2, 0)
    with stage("pixel_gathers"):
        prev_al = gather_kernel.gather_rows(prev.points, safe1, backend=backend)
        cur_al = gather_kernel.gather_rows(cur.points, safe2, backend=backend)
    rounds = []
    with stage("frame_loop"):
        poses, tri_all, tri_ok_all, solver_stats = frame_kernel.track_frames(
            camera.camera_matrix, camera.params(), x_curr,
            tri_points.contiguous(), tri_valid.contiguous(), cand,
            prev_al, cur_al, corr_all.valid.contiguous(),
            config.gn_iterations, config.kernel_threshold, config.damping,
            config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
            keep_outliers=config.keep_outliers, warm_start=config.warm_start,
            min_num_inliers=config.min_num_inliers, min_iterations=config.gn_min_iterations,
            backend=backend, planar=config.planar, cam_in_robot=config.planar_mount(),
            rounds_out=rounds,
        )
    with stage("appearance_gathers"):
        tri_apps_all = gather_kernel.gather_rows(cur.appearances, safe2, backend=backend)
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
        gn_rounds=rounds[0],
    )


def _track(camera: Camera, config: VOConfig, points, appearances, masks, ids,
           use_known_da: bool = False):
    """Bootstrap + track all frames; no map fold. Returns (x_init, per-frame
    outputs for frames 2.., the bootstrap triangulation)."""
    f0 = FrameData(points[0], appearances[0], masks[0], ids[0])
    f1 = FrameData(points[1], appearances[1], masks[1], ids[1])
    with stage("bootstrap_match"):
        corr01 = _match(config, use_known_da, f0, f1)
    with stage("bootstrap_init"):
        state, x_init = initialize(camera, config, f0, f1, use_known_da, corr=corr01)
    # The map was empty, so its first n_slots rows ARE the bootstrap
    # observations in frame-0 coords, compacted in incoming order.
    s = config.n_slots
    init_tri = InitTriangulation(
        points=state.map.points[:s], apps=state.map.appearances[:s], valid=state.map.valid[:s]
    )

    rest = FrameData(points[2:], appearances[2:], masks[2:], ids[2:])
    prev = FrameData(points[1:-1], appearances[1:-1], masks[1:-1], ids[1:-1])
    with stage("batched_match"):
        corr_all = _batched_match(config, use_known_da, rest, prev)
    if config.scan_backend == "step":
        with stage("frame_step_loop"):
            _, outs = _step_loop(camera, config, state, rest, corr_all, use_known_da,
                                 merge_map=False)
        return x_init, outs, init_tri
    # Step i's world join looks up step i-1's correspondence targets (the
    # bootstrap pair's for the first tracked frame).
    with stage("join_chains"):
        src_idx2 = torch.cat([corr01.idx2[None], corr_all.idx2[:-1]], dim=0).contiguous()
        src_valid = torch.cat([corr01.valid[None], corr_all.valid[:-1]], dim=0).contiguous()
        cand = frame_kernel.join_candidates(
            src_idx2, src_valid, corr_all.idx1.contiguous(), corr_all.valid.contiguous(),
            config.fused_join_depth, backend=config.scan_backend,
        )
    outs = _run_fused(camera, config, state.x_curr, state.tri_points, state.tri_valid,
                      cand, prev, rest, corr_all)
    return x_init, outs, init_tri


def _run(camera: Camera, config: VOConfig, points, appearances, masks, ids,
         use_known_da: bool = False):
    if points.shape[1] != config.n_slots:
        raise ValueError(f"frames have {points.shape[1]} slots, config.n_slots={config.n_slots}")
    if points.shape[0] < 3:
        raise ValueError("a sequence needs at least 3 frames (bootstrap pair + one tracked)")
    x_init, outs, init_tri = _track(camera, config, points, appearances, masks, ids,
                                    use_known_da)

    with stage("chains_and_transform"):
        tri_world = _tri_in_frame0(x_init, outs)
    with stage("map_fold"):
        final_map = _fold_map(config, init_tri, tri_world, outs)
    eye = torch.eye(4, dtype=points.dtype, device=points.device)
    trajectory = torch.cat([eye[None], x_init[None], outs.pose], dim=0)
    return trajectory, final_map, outs


def _tri_in_frame0(x_init: torch.Tensor, outs: FrameOutput) -> torch.Tensor:
    """One sequence's triangulations in frame-0 coordinates
    (vo_complete.cpp:175-176): chains[j] maps frame j+1 coords to frame 0,
    the running product of inverse relative poses."""
    inv_poses = se3.inverse(outs.pose)
    chains = se3.chain_products(torch.cat([se3.inverse(x_init)[None], inv_poses[:-1]], dim=0))
    return se3.transform_points(chains, outs.tri_points)


def _fold_map(config: VOConfig, init_tri, tri_world: torch.Tensor, outs: FrameOutput):
    """One sequence's map: the bootstrap triangulation, then every tracked
    frame's, folded in insertion order. With a leading sequence axis on every
    argument, each sequence's map in one ``merge_stream`` call."""
    d = outs.tri_apps.shape[-1]
    lead = init_tri.valid.shape[:-1]
    return landmark_map.merge_stream(
        tri_world.reshape(lead + (-1, 3)), outs.tri_apps.reshape(lead + (-1, d)),
        outs.tri_valid.reshape(lead + (-1,)), config.map_capacity,
        head=(init_tri.points, init_tri.apps, init_tri.valid),
    )


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


def continue_sequence(
    camera: Camera,
    config: VOConfig,
    state: VOState,
    points: torch.Tensor,       # (F', S, 2) frames to process
    appearances: torch.Tensor,
    masks: torch.Tensor,
    ids: torch.Tensor,
    use_known_da: bool = False,
) -> Tuple[VOState, FrameOutput]:
    """Resume tracking from a carried state (what ``utils/checkpoint`` saves).

    Tracking the same frames in one call, or in several with the carried
    state in between, gives the same result: the state is the whole pipeline
    state. Under ``scan_backend`` ``auto|cuda|torch`` the resumed frames run
    through the same one-launch fused path as ``run_sequence``: the first
    resumed frame's join chain comes straight from the carried
    ``point_lookup`` (which already folds first-wins and triangulation
    validity, so one exact candidate per lane reproduces the lookup join),
    later frames use the precomputed chains, and the per-frame map merges
    collapse into one ``merge_stream`` pass headed by the carried map's
    entries. Split against one shot: poses, map layout and the carried lookup
    are equal; map positions agree to ~1e-5, because a split re-associates
    the float32 frame-0 chain products at the boundary. ``"step"`` loops over
    :func:`frame_step` with the per-frame map merge.
    """
    if points.shape[0] < 1:
        raise ValueError("continue_sequence needs at least one frame")
    frames = FrameData(points, appearances, masks, ids)
    # Previous-frame stack: the carried reference frame, then frames 0..F'-2.
    prev = FrameData(*(torch.cat([r[None], xs[:-1]], dim=0) for r, xs in zip(state.ref, frames)))
    with stage("batched_match"):
        corr_all = _batched_match(config, use_known_da, frames, prev)
    if config.scan_backend == "step":
        with stage("frame_step_loop"):
            return _step_loop(camera, config, state, frames, corr_all, use_known_da,
                              merge_map=True)

    s, depth = config.n_slots, config.fused_join_depth
    dev = points.device
    with stage("join_chains"):
        # First resumed frame: the carried lookup IS the join (slot of the first
        # successfully triangulated first-wins source, or -1).
        valid_0 = corr_all.valid[0]
        slot0 = state.point_lookup[torch.where(valid_0, corr_all.idx1[0], 0).long()]
        has0 = valid_0 & (slot0 >= 0)
        idx0 = torch.zeros((1, depth, s), dtype=torch.int32, device=dev)
        idx0[0, 0] = torch.where(has0, slot0, 0)
        ok0 = torch.zeros((1, depth, s), dtype=torch.bool, device=dev)
        ok0[0, 0] = has0
        cand = frame_kernel.JoinCandidates(
            idx=idx0, ok=ok0, overflow=torch.zeros((1, s), dtype=torch.bool, device=dev))
        if points.shape[0] > 1:
            rest = frame_kernel.join_candidates(
                corr_all.idx2[:-1].contiguous(), corr_all.valid[:-1].contiguous(),
                corr_all.idx1[1:].contiguous(), corr_all.valid[1:].contiguous(),
                depth, backend=config.scan_backend,
            )
            cand = frame_kernel.JoinCandidates(
                *(torch.cat([a, b], dim=0) for a, b in zip(cand, rest)))
    outs = _run_fused(camera, config, state.x_curr, state.tri_points, state.tri_valid,
                      cand, prev, frames, corr_all)

    # Fold the map once: the carried entries head the stream (slot order =
    # insertion order), then every resumed frame's triangulation in frame-0
    # coords. chains[j] maps tracked frame j's previous-frame coords to frame 0.
    with stage("chains_and_transform"):
        inv_poses = se3.inverse(outs.pose)
        chains = se3.chain_products(torch.cat([state.history[None], inv_poses[:-1]], dim=0))
        tri_world = se3.transform_points(chains, outs.tri_points)
    d = appearances.shape[-1]
    with stage("map_fold"):
        new_map = landmark_map.merge_stream(
            tri_world.reshape(-1, 3), outs.tri_apps.reshape(-1, d), outs.tri_valid.reshape(-1),
            config.map_capacity,
            head=(state.map.points, state.map.appearances, state.map.valid),
        )
    corr_last = matching.Correspondences(*(x[-1] for x in corr_all))
    new_state = VOState(
        ref=FrameData(*(x[-1] for x in frames)),
        point_lookup=matching.lookup_from_corr(corr_last, outs.tri_valid[-1], s),
        tri_points=outs.tri_points[-1],
        tri_valid=outs.tri_valid[-1],
        x_curr=outs.pose[-1],
        history=chains[-1] @ inv_poses[-1],
        map=new_map,
    )
    return new_state, outs


def relocalize_frame(
    camera: Camera,
    config: VOConfig,
    map_state: LandmarkMap,
    frame: FrameData,
    x_init: torch.Tensor,
) -> Tuple[torch.Tensor, "picp.PICPStats", torch.Tensor]:
    """Map-scale re-localization: one frame queried against the whole map.

    The database is the landmark map (``map_capacity`` rows, matched by kernel
    K7 on the card in ``config.matcher_precision``), the queries are one
    frame's descriptors, and the matches feed the PICP solve (K6) for the
    camera-from-map pose; best-match semantics as in frame-to-frame
    association (exact nearest within the strict radius). ``x_init`` is the
    pose prior the solve starts from. Returns (camera-from-map pose (4, 4),
    solver stats, number of matches)."""
    with stage("map_match"):
        dist, idx = matching.best_match(
            frame.appearances, frame.mask, map_state.appearances, map_state.valid,
            backend=config.matcher_backend, precision=config.matcher_precision,
        )
    with stage("radius_and_gather"):
        r2 = torch.tensor(config.match_radius, dtype=dist.dtype) ** 2   # squared in float32
        valid = frame.mask & (dist < r2.to(dist.device))
        world = map_state.points[torch.where(valid, idx, 0).long()]
    with stage("solve"):
        solved, stats = picp.solve(
            picp.with_pose(camera, x_init), world, frame.points, valid.to(frame.points.dtype),
            config.gn_iterations, kernel_threshold=config.kernel_threshold,
            damping=config.damping, keep_outliers=config.keep_outliers,
            tolerance=config.gn_tolerance, backend=config.solver_backend,
            min_num_inliers=config.min_num_inliers, min_iterations=config.gn_min_iterations,
        )
    return solved.world_in_camera, stats, valid.sum().to(torch.int32)


def run_sequence_known_da(
    camera: Camera,
    config: VOConfig,
    points: torch.Tensor,
    appearances: torch.Tensor,
    masks: torch.Tensor,
    ids: torch.Tensor,
    validate: bool = True,
) -> Tuple[torch.Tensor, LandmarkMap, FrameOutput]:
    """The vo_daKnown pipeline: data association by ground-truth landmark id."""
    out = _run(camera, config, points, appearances, masks, ids, True)
    if validate:
        check_join_overflow(out[2])
    return out
