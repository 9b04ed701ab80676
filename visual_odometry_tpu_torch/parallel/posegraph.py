"""Sequence-parallel tracking: chunked VO and pose-graph scale stitching
(port of visual_odometry_tpu.parallel.posegraph).

The frame loop of one sequence is serial with a carried pose
(vo_complete.cpp:150-179). To spread ONE long sequence over the card:

  1. split the F-frame sequence into C overlapping chunks;
  2. track every chunk on its own, each re-running the two-view bootstrap
     (vo_complete.cpp:95-148) on its own first frame pair. On CUDA tensors
     the chunks are the sequences of ``multiseq._track_batched``: the
     bootstrap pairs in one K1 launch and the init per chunk, then K1 over
     the chunks' flattened consecutive pairs, one K2, three K3 and ONE K8
     launch, a CTA (or a cluster of 4 at 1,024 slots) a chunk. Otherwise
     (CPU tensors or ``scan_backend="step"``) a loop of ``pipeline._track``
     over the chunks, the counterpart of the JAX ``vmap``;
  3. stitch the per-chunk relative-pose streams back into one trajectory.

Monocular VO is scale-free: each chunk's bootstrap fixes an arbitrary scale,
so consecutive chunks agree on rotations over their overlap but differ by
one scalar. Each boundary's scale is the masked median of the norm ratios of
the overlap's shared triangulations (the pose translation ratios as a
fallback), chained cumulatively; each chunk's exclusive pose range is
spliced in, and chunks >= 1 lose their bootstrap poses. The landmark map is
folded as the serial pipeline folds it: every chunk's triangulations,
rescaled into the global scale and moved into frame-0 coordinates by the
stitched chains, go through ONE ``merge_stream`` pass in observation order.

The bootstrap scores match at radius 0.1 whatever ``config.match_radius``
is, as the JAX module's do; they route the pair matcher by the config's
``matcher_backend``. When the config's radius is 0.1 too, their pass also
gives chunk 0's bootstrap check, which then launches no matcher of its own;
otherwise the check matches its pair at the config's radius. The chain
products are ``se3.chain_products`` (JAX: ``associative_scan``).

Sequence parallelism over a ``mesh`` (``parallel/mesh``): every rank makes
the same plan (the bootstrap scores included), tracks its block of C/n
chunks as above, and all-gathers the chunks' bootstrap poses, per-frame
outputs and bootstrap triangulations in chunk order; every rank then stitches
and folds the same map. Tracking moves nothing between ranks.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import landmark_map, pipeline, refinement
from ..models.landmark_map import LandmarkMap
from ..ops import epipolar, matching, se3
from ..ops.camera import Camera
from ..utils.config import VOConfig
from ..utils.profiling import stage
from . import mesh as mesh_mod
from . import multiseq

_EPS = 1e-8
# Overlap poses whose translation norm is below this fraction of the
# overlap's largest norm carry no usable scale information (pure-rotation /
# stationary frames: the norms are solver noise, their ratio is garbage).
_MOTION_FRACTION = 0.2
# Absolute translation-norm floor for a pose to count as "moving" in the
# scale-ratio fallback: converged-GN noise on stationary frames is ~1e-7.
_MIN_MOTION = 1e-4
# The radius the bootstrap scores match at, whatever the config's (JAX:
# bootstrap_scores' default).
SCORE_RADIUS = 0.1


class StitchError(RuntimeError):
    """A chunk boundary's monocular stitch scale is unobservable: its overlap
    yields zero usable scale samples (neither shared valid triangulations nor
    moving poses). The chunked analogue of the serial bootstrap's hard
    failure (pipeline.BootstrapError, epipolar_utils.cpp:104-108)."""


class PoseGraphDiagnostics(NamedTuple):
    scales: torch.Tensor           # (C,) cumulative per-chunk scale (chunk 0 = 1)
    rot_consistency: torch.Tensor  # (C-1,) mean trace(I - Ra^T Rb) over each overlap
    num_ratio_obs: torch.Tensor    # (C-1,) int32 usable ratio samples per boundary
    join_overflow: torch.Tensor    # () int32 world-join depth overflows over all
    #   chunks and frames; run_sequence_chunked raises on nonzero.


def plan_chunks(
    num_frames: int,
    num_chunks: int,
    overlap: int,
    scores: Optional[np.ndarray] = None,
    slack: int = 0,
) -> Tuple[Tuple[int, ...], int]:
    """Static chunking plan: (chunk start frames, chunk length).

    Chunks are stride-spaced with the LAST chunk end-aligned, so every
    frame is covered and consecutive chunks share >= ``overlap`` frames.
    ``overlap`` must be >= 3: each boundary needs at least one shared
    PICP-tracked relative pose (local pose index >= 2 in both chunks) for
    the scale estimate.

    With ``scores`` (one two-view bootstrap-conditioning score per
    consecutive frame pair, see :func:`bootstrap_scores`) and ``slack`` > 0,
    every chunk is lengthened by ``slack`` frames and its start slides
    EARLIER by up to ``slack`` to the best-scoring bootstrap pair in its
    window (the last chunk only later). Sliding back only grows the
    overlaps, so coverage and the >= overlap guarantee are preserved; no
    chunk is forced to bootstrap inside a pure-rotation / stationary
    segment, where the 8-point translation is degenerate.
    """
    if num_chunks < 1:
        raise ValueError("num_chunks must be >= 1")
    if num_chunks == 1:
        return (0,), num_frames
    if overlap < 3:
        raise ValueError("overlap must be >= 3 (need shared PICP poses)")
    slack = max(int(slack), 0)
    stride = -(-(num_frames - overlap) // num_chunks)  # ceil
    chunk_len = stride + overlap + slack
    if chunk_len < 4 or chunk_len > num_frames:
        raise ValueError(
            f"cannot split {num_frames} frames into {num_chunks} chunks "
            f"with overlap {overlap} + slack {slack} (chunk_len={chunk_len})"
        )
    nominal = [c * stride for c in range(num_chunks - 1)]
    nominal.append(num_frames - chunk_len)
    starts = []
    for c, nom in enumerate(nominal):
        nom = max(nom, 0)
        if scores is None or slack == 0 or c == 0:
            # chunk 0 anchors the global frame at frame 0.
            starts.append(nom)
            continue
        if c == num_chunks - 1:
            # The last chunk may only slide LATER: sliding earlier would
            # leave the final frames uncovered. Past-the-end frames are the
            # clamped gather's repeated last frame (inert).
            window = range(nom, min(nom + slack, num_frames - 4) + 1)
        else:
            window = range(max(nom - slack, 0), nom + 1)
        starts.append(max(window, key=lambda s: float(scores[s])))
    if any(b <= a for a, b in zip(starts, starts[1:])):
        raise ValueError("chunk starts not increasing; use fewer chunks")
    return tuple(starts), chunk_len


def _pair_conditioning(points, appearances, masks, match_radius: float, backend: str):
    """For each consecutive frame pair: (valid matches, median homography
    transfer residual (1.0 when none), residual count), from one pair-matcher
    pass (K1 on CUDA tensors) and one batched homography fit."""
    corr = matching.match_appearances_batch(
        appearances[:-1], masks[:-1], appearances[1:], masks[1:], match_radius, backend)
    res, ok = epipolar.homography_transfer_residuals(
        corr.idx1, corr.idx2, corr.valid, points[:-1], points[1:], masks[:-1], masks[1:])
    med, cnt = _masked_median(res, ok)
    return corr.valid.sum(dim=-1).to(torch.int32), med, cnt


def bootstrap_scores(
    points: torch.Tensor,        # (F, S, 2)
    appearances: torch.Tensor,   # (F, S, D)
    masks: torch.Tensor,         # (F, S)
    match_radius: float = SCORE_RADIUS,
    backend: str = "auto",
) -> torch.Tensor:
    """Two-view bootstrap-conditioning score per consecutive frame pair (F-1,).

    Masked median homography transfer residual
    (ops/epipolar.homography_transfer_residuals) over the pair's appearance
    matches: ~0 for pure-rotation / stationary pairs (degenerate monocular
    bootstrap), large when there is real parallax. Pairs with < 8 usable
    residuals score 0 (the 8-point algorithm needs them,
    epipolar_utils.cpp:104-108). ``backend`` routes the pair matcher (K1).
    """
    return _scores(_pair_conditioning(points, appearances, masks, match_radius, backend))


def _scores(pairs) -> torch.Tensor:
    """:func:`bootstrap_scores` from :func:`_pair_conditioning`'s result."""
    _, med, cnt = pairs
    return torch.where(cnt >= 8, med, torch.zeros_like(med))


def _masked_median(values: torch.Tensor, valid: torch.Tensor):
    """(lower median over the valid entries of the last axis | 1.0 if none,
    int32 count): the entry at (count - 1) // 2 of an inf-filled sort."""
    cnt = valid.sum(dim=-1, dtype=torch.int32)
    sorted_vals = torch.sort(torch.where(valid, values, float("inf")), dim=-1).values
    idx = (cnt - 1).clamp(min=0) // 2
    med = sorted_vals.gather(-1, idx.long()[..., None])[..., 0]
    return torch.where(cnt > 0, med, torch.ones_like(med)), cnt


def _scale_translations(poses: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Scale the translation part of a (..., 4, 4) pose stack by scalar s."""
    out = poses.clone()
    out[..., :3, 3] = poses[..., :3, 3] * s
    return out


def _track_and_stitch(
    camera: Camera,
    config: VOConfig,
    cpoints: torch.Tensor,   # (C, L, S, 2) chunked frames
    capps: torch.Tensor,     # (C, L, S, D)
    cmasks: torch.Tensor,    # (C, L, S)
    cids: torch.Tensor,      # (C, L, S)
    starts: Tuple[int, ...],
    chunk_len: int,
    num_frames: int,
    use_known_da: bool,
    batched: bool,
    mesh=None,
    sp_axis: str = "dp",
) -> Tuple[torch.Tensor, LandmarkMap, PoseGraphDiagnostics]:
    """Track the C >= 2 chunks (``batched``: one ``multiseq._track_batched``
    program, else a loop of ``pipeline._track``; with ``mesh``, this rank's
    block of them, then gathered), stitch their scales and fold one map."""
    c, length = len(starts), chunk_len
    d = capps.shape[-1]

    # --- 1. track every chunk independently ---
    chunks = (cpoints, capps, cmasks, cids)
    if mesh is not None:
        i, rows = mesh.axis_index(sp_axis), c // mesh.shape[sp_axis]
        chunks = tuple(x[i * rows:(i + 1) * rows] for x in chunks)
    if batched:
        x_init_c, outs_c, init_tri = multiseq._track_batched(camera, config, *chunks,
                                                             use_known_da)
    else:
        runs = [pipeline._track(camera, config, *(x[i] for x in chunks), use_known_da)
                for i in range(chunks[0].shape[0])]
        x_init_c = torch.stack([r[0] for r in runs])
        outs_c = multiseq._stack([r[1] for r in runs])
        init_tri = multiseq._stack([r[2] for r in runs])
    if mesh is not None:
        x_init_c = mesh_mod.all_gather(mesh, x_init_c, sp_axis)
        outs_c = mesh_mod.all_gather_tuple(mesh, outs_c, sp_axis)
        init_tri = mesh_mod.all_gather_tuple(mesh, init_tri, sp_axis)

    with stage("stitch"):
        # Per-chunk LOCAL relative-pose trajectories, entries 0..L-1: entry 0
        # identity, entry 1 the chunk's bootstrap, then PICP poses.
        eye = torch.eye(4, dtype=cpoints.dtype, device=cpoints.device).expand(c, 1, 4, 4)
        trajs = torch.cat([eye, x_init_c[:, None], outs_c.pose], dim=1)

        # --- 2. chain the per-boundary scales ---
        # Over the overlap both chunks triangulate the SAME measurement pairs
        # (correspondences depend only on the frame data), each in the
        # previous frame's coordinates at its chunk's bootstrap scale, so a
        # shared landmark's norm ratio IS the boundary's scale ratio. The
        # pose-translation ratio is the fallback (stationary overlaps).
        scales = [torch.ones((), dtype=cpoints.dtype, device=cpoints.device)]
        rot_errs, counts = [], []
        for ci in range(1, c):
            ov_lo = starts[ci] + 2                             # first shared PICP entry
            ov_hi = min(starts[ci - 1] + length, num_frames)   # one past the overlap
            ja, n_ov = ov_lo - starts[ci - 1] - 2, ov_hi - ov_lo
            tri_a = outs_c.tri_points[ci - 1, ja:ja + n_ov]
            tri_b = outs_c.tri_points[ci, :n_ov]
            ok_a = outs_c.tri_valid[ci - 1, ja:ja + n_ov]
            ok_b = outs_c.tri_valid[ci, :n_ov]
            lna = torch.linalg.norm(tri_a, dim=-1).reshape(-1)
            lnb = torch.linalg.norm(tri_b, dim=-1).reshape(-1)
            lok = (ok_a & ok_b).reshape(-1) & (lnb > _EPS)
            lm_ratio, lm_cnt = _masked_median(lna / lnb.clamp(min=_EPS), lok)

            a = trajs[ci - 1, ov_lo - starts[ci - 1]:ov_hi - starts[ci - 1]]
            b = trajs[ci, 2:ov_hi - starts[ci]]
            na = torch.linalg.norm(a[:, :3, 3], dim=-1)
            nb = torch.linalg.norm(b[:, :3, 3], dim=-1)
            # Gate relative to the overlap's real motion, with an absolute
            # floor: on a stationary overlap max(norm) is solver noise.
            pok = ((na > (_MOTION_FRACTION * na.max()).clamp(min=_MIN_MOTION))
                   & (nb > (_MOTION_FRACTION * nb.max()).clamp(min=_MIN_MOTION)))
            p_ratio, p_cnt = _masked_median(na / nb.clamp(min=_EPS), pok)

            use_lm = lm_cnt >= 8
            scales.append(scales[-1] * torch.where(use_lm, lm_ratio, p_ratio))
            # Rotations are scale-free: their overlap disagreement is the
            # stitching-quality diagnostic (the e_theta form of evaluate.cpp:34).
            rtr = torch.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
            rot_errs.append(torch.mean(3.0 - rtr.diagonal(dim1=-2, dim2=-1).sum(-1)))
            counts.append(torch.where(use_lm, lm_cnt, p_cnt))

        # --- 3. splice the global relative-pose trajectory ---
        # Chunk ci owns global entries [e_ci, e_{ci+1}), e_0 = 0 and e_ci =
        # starts[ci-1] + L: its own entries start at local index >= 2, so the
        # bootstrap poses of chunks >= 1 are never used.
        pieces = []
        for ci in range(c):
            lo = 0 if ci == 0 else min(starts[ci - 1] + length, num_frames)
            hi = num_frames if ci == c - 1 else min(starts[ci] + length, num_frames)
            pieces.append(_scale_translations(trajs[ci, lo - starts[ci]:hi - starts[ci]],
                                              scales[ci]))
        trajectory = torch.cat(pieces, dim=0)

    # --- 4. fold ONE global landmark map from all chunks' observations ---
    with stage("map_fold"):
        # chains[j] maps frame-j camera coords to frame-0 coords (globally
        # scaled): the serial pipeline's ``history`` chain.
        chains = torch.cat([eye[0], se3.chain_products(se3.inverse(trajectory[1:]))], dim=0)
        stream_pts = [init_tri.points[0]]   # chunk 0's bootstrap, frame-0 coords
        stream_apps = [init_tri.apps[0]]
        stream_mask = [init_tri.valid[0]]
        for ci in range(c):
            # The tracked frames the chunk is responsible for: global frames
            # [max(e_ci, starts[ci]+2), e_{ci+1}); output j tracks global
            # frame starts[ci] + 2 + j and triangulates in the PREVIOUS
            # frame's coordinates at the chunk's local scale.
            lo = max(0 if ci == 0 else min(starts[ci - 1] + length, num_frames),
                     starts[ci] + 2)
            hi = num_frames if ci == c - 1 else min(starts[ci] + length, num_frames)
            j0, j1 = lo - starts[ci] - 2, hi - starts[ci] - 2
            tri = outs_c.tri_points[ci, j0:j1]
            tri_world = se3.transform_points(chains[lo - 1:hi - 1], tri * scales[ci])
            stream_pts.append(tri_world.reshape(-1, 3))
            stream_apps.append(outs_c.tri_apps[ci, j0:j1].reshape(-1, d))
            stream_mask.append(outs_c.tri_valid[ci, j0:j1].reshape(-1))
        final_map = landmark_map.merge_stream(
            torch.cat(stream_pts), torch.cat(stream_apps), torch.cat(stream_mask),
            config.map_capacity)

    diags = PoseGraphDiagnostics(
        scales=torch.stack(scales),
        rot_consistency=torch.stack(rot_errs),
        num_ratio_obs=torch.stack(counts).to(torch.int32),
        join_overflow=outs_c.join_overflow.sum().to(torch.int32),
    )
    return trajectory, final_map, diags


def _chunk(frames: torch.Tensor, starts: Tuple[int, ...], chunk_len: int) -> torch.Tensor:
    """(F, ...) -> (C, L, ...). Clamped gather: a slack-extended chunk may run
    past the end of the sequence; the repeated last frame has zero parallax,
    so its poses and triangulations are inert and the splice drops them."""
    idx = np.minimum(np.add.outer(np.asarray(starts), np.arange(chunk_len)), frames.shape[0] - 1)
    return frames[torch.from_numpy(idx).to(frames.device)]


def refine_stitched(
    camera: Camera,
    config: VOConfig,
    trajectory: torch.Tensor,
    map_state: LandmarkMap,
    points: torch.Tensor,
    appearances: torch.Tensor,
    masks: torch.Tensor,
    num_iterations: int = 5,
    mesh=None,
) -> Tuple[torch.Tensor, LandmarkMap]:
    """Bundle-adjustment relaxation of a stitched chunked trajectory: every
    chunk's poses are re-coupled through the shared landmarks, so the
    boundary seams and the per-boundary scale noise relax away. Honors
    ``config.refine_backend`` as ``apps.run_vo_complete`` does ("dense":
    ``refinement.refine_trajectory``, "sparse": ``refine_trajectory_sparse``)
    and runs on the tensors' device. With a ``mesh`` that has an ``lm`` axis
    the refinement runs sharded over it; a mesh without one (the ('dp',)
    sequence-parallel mesh) refines on each rank's device alone, as the JAX
    package does. Returns (relative trajectory (F, 4, 4), map of
    ``config.map_capacity``)."""
    refine_fn = (refinement.refine_trajectory_sparse if config.refine_backend == "sparse"
                 else refinement.refine_trajectory)
    dev = points.device
    ba_mesh = mesh if mesh is not None and "lm" in mesh.axis_names else None
    rel, map_pts, map_apps, _ = refine_fn(
        camera.camera_matrix.cpu().numpy(), trajectory.cpu().numpy(), map_state,
        points.cpu().numpy(), appearances.cpu().numpy(), masks.cpu().numpy(),
        num_iterations=num_iterations, damping=config.refine_damping,
        kernel_threshold=config.kernel_threshold, mesh=ba_mesh, device=dev)
    n = len(map_pts)
    refined = LandmarkMap.empty(config.map_capacity, map_apps.shape[-1], points.dtype, dev)
    refined.points[:n] = torch.from_numpy(np.asarray(map_pts)).to(dev, points.dtype)
    refined.appearances[:n] = torch.from_numpy(np.asarray(map_apps)).to(dev, points.dtype)
    refined.valid[:n] = True
    refined = refined._replace(count=torch.tensor(n, dtype=torch.int32, device=dev))
    return torch.from_numpy(rel).to(dev, points.dtype), refined


def _auto_slack(scores: np.ndarray, num_frames: int, num_chunks: int) -> int:
    """A chunk's start window must be able to escape any degenerate
    (stationary / pure-rotation) segment: the slack is the longest
    below-threshold score run plus 2, floored at 8."""
    good = scores[scores > 0]
    thr = 0.4 * (np.median(good) if good.size else 0.0)
    bad = (scores < thr).astype(np.int64)
    run = max((len(list(g)) for k, g in itertools.groupby(bad) if k), default=0)
    return max(8, min(run + 2, max(num_frames // max(num_chunks, 1) - 2, 4)))


def _plan(config: VOConfig, points, appearances, masks, ids, use_known_da: bool,
          num_chunks: int, overlap: int, slack: Optional[int]):
    """run_sequence_chunked's plan: (chunk starts, chunk length, chunk 0's
    ``pipeline.BootstrapDiagnostics``). Scores the bootstrap pairs unless
    ``slack`` is 0; ``slack=None`` sizes the slack from the scores."""
    f = points.shape[0]
    pairs = scores = None
    if slack is None or slack > 0:
        with stage("bootstrap_scores"):
            pairs = _pair_conditioning(points, appearances, masks, SCORE_RADIUS,
                                       config.matcher_backend)
            scores = _scores(pairs).cpu().numpy()
    if slack is None:
        slack = _auto_slack(scores, f, num_chunks)
    starts, chunk_len = plan_chunks(f, num_chunks, overlap, scores, slack)
    s0 = starts[0]
    if pairs is not None and not use_known_da and config.match_radius == SCORE_RADIUS:
        # The scores' pass matched chunk 0's pair as check_bootstrap would.
        num, med, cnt = (x[s0] for x in pairs)
        diag0 = pipeline.BootstrapDiagnostics(
            num_correspondences=num, degeneracy_score=torch.where(cnt > 0, med, float("nan")))
    else:
        diag0 = pipeline.bootstrap_diagnostics(
            config, pipeline.FrameData(points[s0], appearances[s0], masks[s0], ids[s0]),
            pipeline.FrameData(points[s0 + 1], appearances[s0 + 1], masks[s0 + 1], ids[s0 + 1]),
            use_known_da)
    return starts, chunk_len, diag0


def run_sequence_chunked(
    camera: Camera,
    config: VOConfig,
    points: torch.Tensor,        # (F, S, 2)
    appearances: torch.Tensor,   # (F, S, D)
    masks: torch.Tensor,         # (F, S)
    num_chunks: int,
    overlap: int = 10,
    slack: Optional[int] = None,
    ids: Optional[torch.Tensor] = None,
    mesh=None,
    sp_axis: str = "dp",
    refine_iterations: int = 0,
) -> Tuple[torch.Tensor, LandmarkMap, PoseGraphDiagnostics]:
    """vo_complete over ONE sequence, tracked as ``num_chunks`` chunks.

    Same output contract as ``pipeline.run_sequence`` (relative-pose
    trajectory (F, 4, 4), landmark map in frame-0 coordinates) up to the
    monocular gauge: the global scale is chunk 0's bootstrap scale and each
    boundary's scale alignment is statistical. Chunk starts slide within
    ``slack`` frames (default: sized to the longest run of poorly scored
    pairs, at least 8) to the best-conditioned bootstrap pair by
    :func:`bootstrap_scores`. ``ids`` associates by landmark id instead of
    appearance. ``refine_iterations`` > 0 follows the stitch with
    :func:`refine_stitched`. CUDA tensors track the chunks as one batched
    program (K1-K3 over the flattened chunks, one K8 launch); CPU tensors and
    ``scan_backend="step"`` as a loop of the single-sequence tracker. Raises ``pipeline.BootstrapError``
    when chunk 0's bootstrap pair has < 8 matches,
    ``pipeline.FusedJoinDepthError`` on a world-join overflow and
    :class:`StitchError` on a boundary with no scale observation. With
    ``mesh`` every rank passes the whole sequence, the ``sp_axis`` size must
    divide ``num_chunks``, each rank tracks its block of the chunks on
    ``mesh.device`` and every rank returns the whole result; a single chunk
    runs the serial pipeline on every rank, as in the JAX package.
    """
    if mesh is not None:
        n = mesh.shape[sp_axis]
        if num_chunks > 1 and num_chunks % n:
            raise ValueError(f"the mesh axis {sp_axis!r} of size {n} does not divide "
                             f"{num_chunks} chunks")
        points, appearances, masks = (x.to(mesh.device) for x in (points, appearances, masks))
        ids = None if ids is None else ids.to(mesh.device)
    f = points.shape[0]
    use_known_da = ids is not None
    if ids is None:
        ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    if num_chunks == 1:
        # Exactly the serial pipeline.
        trajectory, final_map, outs = pipeline._run(
            camera, config, points, appearances, masks, ids, use_known_da)
        diags = PoseGraphDiagnostics(
            scales=torch.ones((1,), dtype=points.dtype, device=points.device),
            rot_consistency=torch.zeros((0,), dtype=points.dtype, device=points.device),
            num_ratio_obs=torch.zeros((0,), dtype=torch.int32, device=points.device),
            join_overflow=outs.join_overflow.sum().to(torch.int32),
        )
        pipeline.check_join_overflow(outs)
    else:
        if points.shape[1] != config.n_slots:
            raise ValueError(f"frames have {points.shape[1]} slots, "
                             f"config.n_slots={config.n_slots}")
        starts, chunk_len, diag0 = _plan(config, points, appearances, masks, ids,
                                         use_known_da, num_chunks, overlap, slack)
        # Chunk 0's bootstrap anchors the whole trajectory at frame 0: the
        # serial path's < 8-correspondence hard error (epipolar_utils.cpp:
        # 104-108) holds for it. Later chunks' bootstraps only seed their
        # local tracking and are discarded by the splice.
        pipeline.judge_bootstrap(diag0)

        chunked = [_chunk(x, starts, chunk_len) for x in (points, appearances, masks, ids)]
        batched = points.is_cuda and config.scan_backend != "step"
        trajectory, final_map, diags = _track_and_stitch(
            camera, config, *chunked, starts, chunk_len, f, use_known_da, batched, mesh, sp_axis)
        with stage("overflow_check"):
            overflow, ratio_obs = int(diags.join_overflow), diags.num_ratio_obs.cpu().numpy()
        if overflow:
            raise pipeline.FusedJoinDepthError(
                f"{overflow} correspondence lanes exceeded the world-join chain depth across "
                "the chunks; raise VOConfig.fused_join_depth.")
        if (ratio_obs == 0).any():
            raise StitchError(
                f"chunk boundaries {np.nonzero(ratio_obs == 0)[0].tolist()} produced zero "
                "scale observations (no shared valid triangulations in the overlap and no "
                "moving overlap poses); the monocular stitch scale is undefined: increase "
                "chunk_overlap or reduce num_chunks")
    if refine_iterations > 0:
        trajectory, final_map = refine_stitched(
            camera, config, trajectory, final_map, points, appearances, masks,
            num_iterations=refine_iterations, mesh=mesh)
    return trajectory, final_map, diags
