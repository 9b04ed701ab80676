"""Batched serving: many independent sequences tracked in one program
(port of visual_odometry_tpu.parallel.multiseq).

The frame loop of one sequence is serial, so tracking throughput scales over
independent sequences. Two forms:

* ``backend="cuda"``: the batch-aware program of the JAX package's
  ``_run_serving``. The bootstrap is one pair match over the batch and one
  ``pipeline.initialize_batched`` (one launch of the eight-point kernel P1
  for all pairs, ``ops/kernels/epipolar_kernel``); the pose-independent
  stages see the batch flattened into their frame axis — one K1 launch over
  the ``B*(F-2)`` consecutive pairs, one K2 over ``B*(F-2)`` frames, K3 once
  for each side's pixels and once for the appearances, reading the batch's
  frame slices in place — and the frame loops run as
  one K8 launch, one CTA per sequence
  (``ops/kernels/frame_kernel.track_frames_batched``). The chain products
  run along the frame axis and one ``merge_stream`` call folds every
  sequence's map (the JAX package's ``jax.vmap(fold)``). The tracking half,
  ``_track_batched``, also tracks the chunks of ``parallel/posegraph``.
* ``backend="torch"``: the counterpart of the JAX ``vmap`` form, a loop of
  ``pipeline._run`` over the sequences under the config's own backends.

``auto`` picks ``cuda`` for CUDA tensors and ``torch`` for CPU tensors. Per
sequence both forms give what ``pipeline.run_sequence`` gives.

With a ``mesh`` (``parallel/mesh``) the batch is split over its ``dp_axis``:
every rank runs the form above on its B/n sequences and all-gathers the
results in sequence order, so every rank returns the whole batch. Tracking
moves nothing between ranks.

Not carried over from the TPU design: ``inner_batch``, ``_serving_inner`` and
the sublane grouping (on this card a sequence is a CTA, and the CTAs run side
by side on the SMs), and ``interpret``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models import pipeline
from ..models.landmark_map import LandmarkMap
from ..ops import se3
from ..ops.camera import Camera
from ..ops.kernels import _lib, frame_kernel, gather_kernel
from ..utils.config import VOConfig
from ..utils.profiling import stage
from . import mesh as mesh_mod


def _stack(items):
    """A list of equal NamedTuples of tensors -> one with a leading batch axis."""
    return type(items[0])(*(torch.stack(x) for x in zip(*items)))


def _track_batched(camera: Camera, config: VOConfig, points, appearances, masks, ids,
                   use_known_da: bool = False):
    """``pipeline._track`` over a batch of sequences (B, F, S, ...), every
    stage batch-aware: the bootstrap pairs in one match and one batched
    init (one P1 launch), then K1 over the ``B*(F-2)`` flattened consecutive pairs, K2
    over their frames, three K3 gathers and one K8 launch. Returns what
    ``pipeline._track`` returns, each with a leading batch axis: (x_init
    (B, 4, 4), FrameOutput (B, F-2, ...), InitTriangulation (B, S, ...)).
    ``use_known_da`` associates by the ``ids`` (``pipeline.match_by_ids``)."""
    n, f, s, _ = points.shape
    backend = config.scan_backend
    frames_all = pipeline.FrameData(points, appearances, masks, ids)
    f0 = pipeline.FrameData(*(x[:, 0] for x in frames_all))
    f1 = pipeline.FrameData(*(x[:, 1] for x in frames_all))

    # Two-frame bootstrap: one pair match and one batched init (one P1 launch).
    with stage("bootstrap_match"):
        corr01 = pipeline._batched_match(config, use_known_da, f1, f0)
    with stage("bootstrap_init"):
        state, x_init = pipeline.initialize_batched(camera, config, f0, f1, corr=corr01)
        x_curr, tri_points, tri_valid = state.x_curr, state.tri_points, state.tri_valid
        # The maps were empty: their first n_slots rows are the bootstrap observations.
        init_tri = pipeline.InitTriangulation(
            points=state.map.points[:, :s], apps=state.map.appearances[:, :s],
            valid=state.map.valid[:, :s])

    def flat(x):
        return x.reshape((n * (f - 2),) + x.shape[2:])

    # Consecutive-pair matching of all sequences in one launch.
    rest = pipeline.FrameData(*(x[:, 2:] for x in frames_all))
    prev = pipeline.FrameData(*(x[:, 1:-1] for x in frames_all))
    with stage("batched_match"):
        corr_all = pipeline._batched_match(
            config, use_known_da, pipeline.FrameData(*(flat(x) for x in rest)),
            pipeline.FrameData(*(flat(x) for x in prev)))

    # World-join candidate chains, one launch over B*(F-2) frames.
    with stage("join_chains"):
        idx2_nf = corr_all.idx2.reshape(n, f - 2, s)
        valid_nf = corr_all.valid.reshape(n, f - 2, s)
        src_idx2 = flat(torch.cat([corr01.idx2[:, None], idx2_nf[:, :-1]], dim=1)).contiguous()
        src_valid = flat(torch.cat([corr01.valid[:, None], valid_nf[:, :-1]], dim=1)).contiguous()
        cand_flat = frame_kernel.join_candidates(
            src_idx2, src_valid, corr_all.idx1.contiguous(), corr_all.valid.contiguous(),
            config.fused_join_depth, backend=backend)
        cand = frame_kernel.JoinCandidates(
            idx=cand_flat.idx.reshape(n, f - 2, -1, s), ok=cand_flat.ok.reshape(n, f - 2, -1, s),
            overflow=cand_flat.overflow.reshape(n, f - 2, s))

    # Lane-aligned pixel rows, a gather launch each; the (n, f - 2) frame
    # slices of the batch are read in place.
    safe1 = torch.where(corr_all.valid, corr_all.idx1, 0).reshape(n, f - 2, s)
    safe2 = torch.where(corr_all.valid, corr_all.idx2, 0).reshape(n, f - 2, s)
    with stage("pixel_gathers"):
        prev_al = gather_kernel.gather_rows(prev.points, safe1, backend=backend)
        cur_al = gather_kernel.gather_rows(rest.points, safe2, backend=backend)

    rounds = []
    with stage("frame_loop"):
        poses, tri_all, tri_ok_all, solver_stats = frame_kernel.track_frames_batched(
            camera.camera_matrix, camera.params(), x_curr, tri_points.contiguous(),
            tri_valid.contiguous(), cand, prev_al, cur_al, valid_nf.contiguous(),
            config.gn_iterations, config.kernel_threshold, config.damping,
            config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
            keep_outliers=config.keep_outliers, warm_start=config.warm_start,
            min_num_inliers=config.min_num_inliers, min_iterations=config.gn_min_iterations,
            backend=backend, planar=config.planar, cam_in_robot=config.planar_mount(),
            rounds_out=rounds)
    with stage("appearance_gathers"):
        tri_apps_all = gather_kernel.gather_rows(rest.appearances, safe2, backend=backend)

    outs = pipeline.FrameOutput(
        pose=poses,
        num_matches=valid_nf.sum(dim=-1).to(torch.int32),
        num_solver_corr=solver_stats[..., 3].to(torch.int32),
        num_inliers=solver_stats[..., 2].to(torch.int32),
        chi_inliers=solver_stats[..., 0],
        tri_points=tri_all,
        tri_apps=tri_apps_all,
        tri_valid=tri_ok_all,
        join_overflow=cand.overflow.sum(dim=-1).to(torch.int32),
        gn_rounds=rounds[0],
    )
    return x_init, outs, init_tri


def _run_serving(camera: Camera, config: VOConfig, points, appearances, masks
                 ) -> Tuple[torch.Tensor, LandmarkMap, pipeline.FrameOutput]:
    """The batched tracking program, every stage batch-aware; mirrors
    ``pipeline._run`` stage by stage with a leading sequence axis."""
    n = points.shape[0]
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    x_init, outs, init_tri = _track_batched(camera, config, points, appearances, masks, ids)

    # The frame -> frame-0 chains of all sequences in one scan (the products
    # run along the frame axis, each sequence on its own), then one map fold
    # over the batch (pipeline._run's tail). A matmul batched over the
    # sequences may round differently from run_sequence's over one: map
    # positions agree to the last bits, not bit for bit. The inverses are
    # written per element (se3.inverse_elementwise): the card's batched
    # matrix-vector product rounds by a kernel chosen for the batch's size,
    # and a sequence's map must not depend on the batch it was served in
    # (dp serving's blocks equal one batch).
    with stage("chains_and_transform"):
        forward = torch.cat([x_init[:, None], outs.pose[:, :-1]], dim=1)
        heads = se3.inverse_elementwise(forward)
        chains = se3.chain_products(heads.transpose(0, 1)).transpose(0, 1)
        tri_world = se3.transform_points(chains, outs.tri_points)
    with stage("map_fold"):
        maps = pipeline._fold_map(config, init_tri, tri_world, outs)
    eye = torch.eye(4, dtype=points.dtype, device=points.device).expand(n, 1, 4, 4)
    trajectory = torch.cat([eye, x_init[:, None], outs.pose], dim=1)
    return trajectory, maps, outs


def run_sequences_batched(
    camera: Camera,
    config: VOConfig,
    points: torch.Tensor,        # (B, F, S, 2)
    appearances: torch.Tensor,   # (B, F, S, D)
    masks: torch.Tensor,         # (B, F, S) bool
    mesh=None,
    dp_axis: str = "dp",
    validate: bool = True,
    backend: str = "auto",
) -> Tuple[torch.Tensor, LandmarkMap, pipeline.FrameOutput]:
    """Track B sequences at once on the tensors' device; returns stacked
    (trajectories (B, F, 4, 4), maps, per-frame outputs), each with a leading
    sequence axis, per sequence what ``pipeline.run_sequence`` returns.

    ``backend`` picks the batching form (module docstring): ``cuda`` the
    batch-aware program with kernels K1-K3 over the flattened batch and K8,
    ``torch`` a loop of the single-sequence program, ``auto`` = ``cuda`` for
    CUDA tensors. ``validate`` runs the world-join exactness guard on the
    result (``pipeline.check_join_overflow``, a host fetch). One camera and
    one config serve the whole batch. With ``mesh`` every rank passes the
    whole batch, the ``dp_axis`` size must divide B, each rank tracks its
    block of B/n sequences on ``mesh.device`` and every rank returns the
    whole batch's result, gathered there.
    """
    if points.shape[2] != config.n_slots:
        raise ValueError(f"frames have {points.shape[2]} slots, config.n_slots={config.n_slots}")
    if points.shape[1] < 3:
        raise ValueError("a sequence needs at least 3 frames (bootstrap pair + one tracked)")
    if mesh is not None:
        n = mesh.shape[dp_axis]
        b = points.shape[0]
        if b % n:
            raise ValueError(f"the mesh axis {dp_axis!r} of size {n} does not divide {b} "
                             "sequences")
        i, rows = mesh.axis_index(dp_axis), b // n
        block = (x[i * rows:(i + 1) * rows].to(mesh.device)
                 for x in (points, appearances, masks))
        out = run_sequences_batched(camera, config, *block, validate=False, backend=backend)
        out = (mesh_mod.all_gather(mesh, out[0], dp_axis),
               *(mesh_mod.all_gather_tuple(mesh, t, dp_axis) for t in out[1:]))
    elif _lib.use_kernel(backend, points):
        if config.scan_backend == "step":
            raise ValueError("the batched program has no frame_step form: scan_backend='step' "
                             "needs backend='torch'")
        out = _run_serving(camera, config, points, appearances, masks)
    else:
        ids = torch.full(masks.shape[1:], -1, dtype=torch.int32, device=masks.device)
        runs = [pipeline._run(camera, config, points[i], appearances[i], masks[i], ids)
                for i in range(points.shape[0])]
        out = (torch.stack([r[0] for r in runs]), _stack([r[1] for r in runs]),
               _stack([r[2] for r in runs]))
    if validate:
        pipeline.check_join_overflow(out[2])
    return out
