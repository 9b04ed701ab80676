"""Batched serving: many independent sequences tracked in one program
(port of visual_odometry_tpu.parallel.multiseq).

The frame loop of one sequence is serial, so tracking throughput scales over
independent sequences. Two forms:

* ``backend="cuda"``: the batch-aware program of the JAX package's
  ``_run_serving``. The bootstrap runs per sequence (one pair match over the
  batch, then ``pipeline.initialize`` on each pair); the pose-independent
  stages see the batch flattened into their frame axis — one K1 launch over
  the ``B*(F-2)`` consecutive pairs, one K2 over ``B*(F-2)`` frames, K3 once
  for the pixels and once for the appearances — and the frame loops run as
  one K8 launch, one CTA per sequence
  (``ops/kernels/frame_kernel.track_frames_batched``). The chain products and
  the ``merge_stream`` fold then run per sequence.
* ``backend="torch"``: the counterpart of the JAX ``vmap`` form, a loop of
  ``pipeline._run`` over the sequences under the config's own backends.

``auto`` picks ``cuda`` for CUDA tensors and ``torch`` for CPU tensors. Per
sequence both forms give what ``pipeline.run_sequence`` gives.

Not carried over from the TPU design: ``inner_batch``, ``_serving_inner`` and
the sublane grouping (on this card a sequence is a CTA, and the CTAs run side
by side on the SMs), and ``interpret``. ``mesh``/``dp_axis`` stay in the
signature; sharding the batch over several cards is not ported and a mesh
raises ``NotImplementedError``.
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


def _stack(items):
    """A list of equal NamedTuples of tensors -> one with a leading batch axis."""
    return type(items[0])(*(torch.stack(x) for x in zip(*items)))


def _run_serving(camera: Camera, config: VOConfig, points, appearances, masks
                 ) -> Tuple[torch.Tensor, LandmarkMap, pipeline.FrameOutput]:
    """The batched tracking program, every stage batch-aware; mirrors
    ``pipeline._run`` stage by stage with a leading sequence axis."""
    n, f, s, _ = points.shape
    d = appearances.shape[-1]
    backend = config.scan_backend
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    frames_all = pipeline.FrameData(points, appearances, masks, ids)
    f0 = pipeline.FrameData(*(x[:, 0] for x in frames_all))
    f1 = pipeline.FrameData(*(x[:, 1] for x in frames_all))

    # Two-frame bootstrap: one pair match over the batch, then the init per sequence.
    with stage("bootstrap_match"):
        corr01 = pipeline._batched_match(config, False, f1, f0)
    with stage("bootstrap_init"):
        states, x_inits = [], []
        for i in range(n):
            state, x_init = pipeline.initialize(
                camera, config, pipeline.FrameData(*(x[i] for x in f0)),
                pipeline.FrameData(*(x[i] for x in f1)),
                corr=type(corr01)(*(x[i] for x in corr01)))
            states.append(state)
            x_inits.append(x_init)
        x_init = torch.stack(x_inits)
        x_curr = torch.stack([st.x_curr for st in states])
        tri_points = torch.stack([st.tri_points for st in states])
        tri_valid = torch.stack([st.tri_valid for st in states])
        # The maps were empty: their first n_slots rows are the bootstrap observations.
        init_tri = pipeline.InitTriangulation(
            points=torch.stack([st.map.points[:s] for st in states]),
            apps=torch.stack([st.map.appearances[:s] for st in states]),
            valid=torch.stack([st.map.valid[:s] for st in states]))

    def flat(x):
        return x.reshape((n * (f - 2),) + x.shape[2:])

    # Consecutive-pair matching of all sequences in one launch.
    rest = pipeline.FrameData(*(x[:, 2:] for x in frames_all))
    prev = pipeline.FrameData(*(x[:, 1:-1] for x in frames_all))
    with stage("batched_match"):
        corr_all = pipeline._batched_match(
            config, False, pipeline.FrameData(*(flat(x) for x in rest)),
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

    # Lane-aligned pixel rows, one gather launch.
    safe1 = torch.where(corr_all.valid, corr_all.idx1, 0)
    safe2 = torch.where(corr_all.valid, corr_all.idx2, 0)
    with stage("pixel_gathers"):
        prev_pts, cur_pts = flat(prev.points), flat(rest.points)
        px1, py1, px2, py2 = gather_kernel.take_lanes(
            [prev_pts[..., 0], prev_pts[..., 1], cur_pts[..., 0], cur_pts[..., 1]],
            [safe1, safe1, safe2, safe2], backend=backend)
        prev_al = torch.stack([px1, py1], dim=-1).reshape(n, f - 2, s, 2)
        cur_al = torch.stack([px2, py2], dim=-1).reshape(n, f - 2, s, 2)

    with stage("frame_loop"):
        poses, tri_all, tri_ok_all, solver_stats = frame_kernel.track_frames_batched(
            camera.camera_matrix, camera.params(), x_curr, tri_points.contiguous(),
            tri_valid.contiguous(), cand, prev_al, cur_al, valid_nf.contiguous(),
            config.gn_iterations, config.kernel_threshold, config.damping,
            config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
            keep_outliers=config.keep_outliers, warm_start=config.warm_start,
            min_num_inliers=config.min_num_inliers, min_iterations=config.gn_min_iterations,
            backend=backend, planar=config.planar, cam_in_robot=config.planar_mount())
    with stage("appearance_gathers"):
        rest_apps = flat(rest.appearances)
        tri_apps_all = torch.stack(
            gather_kernel.take_lanes([rest_apps[..., j] for j in range(d)], [safe2] * d,
                                     backend=backend),
            dim=-1).reshape(n, f - 2, s, d)

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
    )

    # The frame -> frame-0 chains of all sequences in one scan (the products
    # run along the frame axis, each sequence on its own), then one map fold
    # per sequence (pipeline._run's tail). A matmul batched over the sequences
    # may round differently from run_sequence's over one: map positions agree
    # to the last bits, not bit for bit.
    with stage("chains_and_transform"):
        inv_poses = se3.inverse(poses)
        heads = torch.cat([se3.inverse(x_init)[:, None], inv_poses[:, :-1]], dim=1)
        chains = se3.chain_products(heads.transpose(0, 1)).transpose(0, 1)
        tri_world = se3.transform_points(chains, tri_all)
    with stage("map_fold"):
        maps = [pipeline._fold_map(config, type(init_tri)(*(x[i] for x in init_tri)),
                                   tri_world[i], type(outs)(*(x[i] for x in outs)))
                for i in range(n)]
    eye = torch.eye(4, dtype=points.dtype, device=points.device).expand(n, 1, 4, 4)
    trajectory = torch.cat([eye, x_init[:, None], poses], dim=1)
    return trajectory, _stack(maps), outs


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
    one config serve the whole batch. A ``mesh`` raises
    ``NotImplementedError``: multi-device serving is ROADMAP.md item 12.
    """
    if mesh is not None:
        raise NotImplementedError(
            f"run_sequences_batched over a mesh (axis {dp_axis!r}: the batch sharded over "
            "several cards) is not ported yet: ROADMAP.md queue 1 item 12")
    config.check_supported()
    if points.shape[2] != config.n_slots:
        raise ValueError(f"frames have {points.shape[2]} slots, config.n_slots={config.n_slots}")
    if points.shape[1] < 3:
        raise ValueError("a sequence needs at least 3 frames (bootstrap pair + one tracked)")
    if _lib.use_kernel(backend, points):
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
