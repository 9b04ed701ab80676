#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (visual_odometry_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. environment: torch, CUDA, the card, nvcc, nvidia-smi name and power limit;
  2. build: compile csrc/*.cu with nvcc into build/vo_torch_kernels/;
  3. each kernel against its plain PyTorch version on the card, with
     CUDA-event times and its bound on this card: K1 pair matcher, K2 join
     candidates, K3 lane gather, K4 fused frame loop and K5 its planar form on
     the main path's own inputs (S = 1024 slots x 512 frames; the plain K4/K5
     are Python loops: K4 is compared over the first 256 tracked frames, K5
     over the first 128; path B holds K4 to the plain run at full depth), K6 standalone solves (SE(3) and planar) at N = 1024 and 8192,
     K7 map-scale matcher (exact and fast) at Q = 1024, K = 2^20 with masked
     rows holding NaN; K5's inputs are path D's; K8 batched frame loop at
     N = 64 sequences x 128 slots x 126 tracked frames, SE(3) and planar, per
     sequence against K4/K5 launched alone and its first sequence against
     the plain version over all 126 frames; K9 segment sum and K10 table gather at the sparse-BA
     corridor's shapes (N ~ 6e5, T = 512, R = 36 / 6 and 12 / 6) beside
     index_add_ and index_select; K11 linearization at N = 1024 and 8192;
  4. path A: the reference-format applications — generate_dataset (40 frames,
     400 landmarks), apps.run_vo_complete, run_vo_se2, run_vo_da_known and
     run_relocalize (both matcher precisions) on cuda, apps.run_evaluation —
     held to the accuracy bounds of tests/test_dataset_gen.py, the planar
     subgroup bound and the relocalization bounds of tests/test_relocalize.py;
  5. path B: pipeline.run_sequence at 1024 slots x 512 frames, held against
     the same run through the plain versions, and its frames/s;
  6. path C: map-scale relocalization, pipeline.relocalize_frame of 1024
     queries against a map of 2^20 landmarks in both matcher precisions, and
     the standalone planar solve at N = 8192;
  7. path D: the planar estimation group at 1024 slots x 512 frames, on path
     B's landmark field and orbit seen by a planar robot;
  8. resume: path B's inputs split at frame 256 through continue_sequence with
     a checkpoint round trip, held against one shot;
  9. step form: the first 18 frames of path B through scan_backend="step"
     (one K6 launch a tracked frame), held against the fused launch.
  10. path E: serving, parallel.multiseq.run_sequences_batched over 64
     sequences x 128 frames x 128 slots (landmark fields 100-163, none left
     out; K1-K3 once a stage over the flattened batch, K8 once), each sequence
     held against its own run_sequence and to a full set of inliers in every
     frame, and a planar batch of 8;
  11. path F: refinement — (1) path A's dataset through run_vo_complete with
     refine_iterations=5, sparse and dense, and run_evaluation; (2) sparse
     bundle adjustment at 512 poses x 100,000 landmarks, 3 LM steps of 64 CG
     iterations, packed and unpacked, with the K9/K10 launch counts reckoned
     from the code path;
  12. path G: K11 through its public entry point at N = 8192 beside
     ops.picp.linearize.
``python3 chip_smoke.py --stages`` instead runs the entry points of paths B, C,
D and E and one sparse-BA step of path F(2) in each layout inside ``profiling.stage_times`` and prints the time of each step the
pipeline itself marks (ended by a sync, median of 5), then each path's kernel
times and device-busy share under torch.profiler, and no result line.

The launch counters are zeroed right before each path and read right after;
every kernel of a path must have launched in it. The last lines are the
card's name and power limit, the kernel table ({"kernels": [...]}) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
_CSRC = "visual_odometry_tpu_torch/csrc/"
_PALLAS = "visual_odometry_tpu/ops/pallas/"
KERNELS = {
    # launch-counter name: (source, TPU kernel it replaces, the path that holds its `launches`)
    "match_pairs": (_CSRC + "match_pairs.cu", _PALLAS + "matcher_kernel.py:302", "B"),
    "join_candidates": (_CSRC + "join_candidates.cu", _PALLAS + "frame_kernel.py:134", "B"),
    "gather_rows": (_CSRC + "gather_rows.cu", _PALLAS + "gather_kernel.py:45", "B"),
    "track_frames": (_CSRC + "track_frames.cu", _PALLAS + "frame_kernel.py:952", "B"),
    "track_frames_planar": (_CSRC + "track_frames.cu", _PALLAS + "picp_kernel.py:617", "D"),
    "picp_solve": (_CSRC + "picp_solve.cu", _PALLAS + "picp_kernel.py:965", "C"),
    "picp_solve_se2": (_CSRC + "picp_solve.cu", _PALLAS + "picp_kernel.py:1065", "C"),
    "best_match": (_CSRC + "best_match.cu", _PALLAS + "matcher_kernel.py:136", "C"),
    "best_match_fast": (_CSRC + "best_match.cu", _PALLAS + "matcher_kernel.py:136", "C"),
    "track_frames_batched": (_CSRC + "track_frames.cu", _PALLAS + "frame_kernel.py:780", "E"),
    "track_frames_batched_planar": (_CSRC + "track_frames.cu", _PALLAS + "picp_kernel.py:776",
                                    "E"),
    "segment_sum": (_CSRC + "segment_sum.cu", _PALLAS + "segsum_kernel.py:54", "F"),
    "take_table": (_CSRC + "take_table.cu", _PALLAS + "gather_kernel.py:129", "F"),
    "picp_linearize": (_CSRC + "picp_linearize.cu", _PALLAS + "picp_kernel.py:141", "G"),
}
MAIN_PATH = ("match_pairs", "join_candidates", "gather_rows", "track_frames")
# Path A's applications run K1-K7 except the standalone planar solve.
PATH_A = MAIN_PATH + ("track_frames_planar", "picp_solve", "best_match", "best_match_fast")
K4_POSE_TOL = 2e-3   # the repo's fused-vs-scan trajectory tolerance (tests/test_pipeline.py:331)
K1_DIST_RTOL = 1e-5
GN_POSE_TOL = 1e-5   # K5/K6 against their plain versions (bitwise expected)
PLANAR_DEV_TOL = 1e-4
K4_PLAIN_FRAMES, K5_PLAIN_FRAMES = 256, 128
K9_RTOL, K9_ATOL = 2e-5, 1e-4    # another order of the float32 sum (tests/test_pallas_kernels.py:266)
K11_RTOL = 1e-5                  # of the system's largest entry (bitwise expected)
SERVE_B, SERVE_FRAMES, SERVE_SLOTS = 64, 128, 128
BA_POSES, BA_LANDMARKS, BA_STEPS, BA_CG = 512, 100_000, 3, 64
MOUNT_V = (0.05, -0.1, 0.02, 0.01, -0.02, 0.015)   # a non-identity camera mount, Euler chart

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# float32 outside the tensor cores, bfloat16 in them.
PEAK_BYTES_S, PEAK_FP32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# Float operations of one lane in one GN round (projection, robust kernel,
# Jacobian, the 30 or 12 products and their share of the block sum) and in one
# frame's join and triangulation, counted from csrc/gn_loop.cuh and
# csrc/track_frames.cu.
ROUND_FLOPS = {False: 240, True: 180}
FRAME_FLOPS = 130


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_call(fn, device):
    """(fn(), its time in ms): CUDA events on a card, the host clock on the CPU."""
    from visual_odometry_tpu_torch.utils.timing import cuda_timed

    return cuda_timed(fn, device)


def time_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Median time of fn() in ms over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed_call(fn, device)[1] for _ in range(reps))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, peak_ops: float = PEAK_FP32):
    """(least time in ms the card could take, "bytes" | "operations")."""
    t_bytes, t_ops = 1e3 * bytes_moved / PEAK_BYTES_S, 1e3 * ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def path_b_inputs(frames: int, slots: int, device):
    """The full-width tracking sequence of benchmarks/bench_scale.py:76-79."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    pts, apps, masks = synthetic.generate_tracking_sequence(np.random.default_rng(0), frames, slots)
    return tuple(torch.from_numpy(x).to(device) for x in (pts, apps, masks))


def mount_matrix(device):
    import torch

    from visual_odometry_tpu_torch.ops import se3

    return se3.v2t_euler(torch.tensor(MOUNT_V)).to(device)


def path_d_inputs(frames: int, slots: int, device, seed: int = 0):
    """Path B's landmark field and orbit seen by a planar robot: the camera
    pose of frame i is ``c^-1 T(x, y, theta) c`` with the mount c, so the
    motion lies in the subgroup the planar solver moves in. (Path B's own
    6-DoF motion is no planar workload: a planar model fitted to it shrinks
    the monocular scale frame by frame until the poses overflow, in the JAX
    package as here.)"""
    import torch

    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.camera import project_points
    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    world = torch.from_numpy(np.stack([rng.uniform(-1.5, 1.5, slots),
                                       rng.uniform(-1.2, 1.2, slots),
                                       rng.uniform(2.0, 4.0, slots)], axis=1).astype(np.float32))
    apps = torch.from_numpy(synthetic.generate_appearances(rng, slots))
    mount = mount_matrix("cpu")
    ph = 2.0 * np.pi * torch.arange(frames, dtype=torch.float32) / 64.0
    robot = se3.v2t_se2(torch.stack([0.3 * torch.cos(ph), 0.3 * torch.sin(ph),
                                     0.02 * torch.sin(ph)], dim=-1))
    poses = se3.inverse(mount) @ robot @ mount
    pts, masks = zip(*(project_points(synthetic.default_camera(p), world) for p in poses))
    return (torch.stack(pts).to(device), apps[None].expand(frames, -1, -1).contiguous().to(device),
            torch.stack(masks).to(device))


def kernel_inputs(camera, config, pts, apps, masks):
    """Each kernel's inputs as the main path builds them (plain versions)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    plain = config.replace(matcher_backend="torch", scan_backend="torch")
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    f0 = pipeline.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps[1], masks[1], ids[1])
    corr01 = pipeline._match(plain, False, f0, f1)
    rest = pipeline.FrameData(pts[2:], apps[2:], masks[2:], ids[2:])
    prev = pipeline.FrameData(pts[1:-1], apps[1:-1], masks[1:-1], ids[1:-1])
    corr = pipeline._batched_match(plain, False, rest, prev)
    src_idx2 = torch.cat([corr01.idx2[None], corr.idx2[:-1]]).contiguous()
    src_valid = torch.cat([corr01.valid[None], corr.valid[:-1]]).contiguous()
    join_args = (src_idx2, src_valid, corr.idx1.contiguous(), corr.valid.contiguous(),
                 config.fused_join_depth)
    cand = frame_kernel.join_candidates(*join_args, backend="torch")
    safe1 = torch.where(corr.valid, corr.idx1, 0)
    safe2 = torch.where(corr.valid, corr.idx2, 0)
    pix_src = torch.stack([prev.points[..., 0], prev.points[..., 1],
                           rest.points[..., 0], rest.points[..., 1]], dim=1).contiguous()
    pix_idx = torch.stack([safe1, safe1, safe2, safe2], dim=1).contiguous()
    app_src = rest.appearances.transpose(1, 2).contiguous()
    app_idx = safe2[:, None, :].expand(app_src.shape).contiguous()
    pix = torch.gather(pix_src, 2, pix_idx.long())

    # K4's arguments, or K5's for a planar config (planarized bootstrap).
    state, _ = pipeline.initialize(camera, plain, f0, f1, corr=corr01)
    frame_args = (
        frame_kernel.pack_params(
            camera.camera_matrix, camera.params(), state.x_curr, config.kernel_threshold,
            config.damping, config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
            config.keep_outliers, config.warm_start, config.min_num_inliers, config.planar,
            config.planar_mount(),
        ),
        state.tri_points.contiguous(), state.tri_valid.contiguous(), cand,
        pix[:, 0:2].transpose(1, 2).contiguous(), pix[:, 2:4].transpose(1, 2).contiguous(),
        corr.valid.contiguous(), config.gn_iterations, config.gn_min_iterations, config.planar,
    )
    k1_batch = (prev.appearances.contiguous(), prev.mask.contiguous(),
                rest.appearances.contiguous(), rest.mask.contiguous())
    k1_pair = tuple(x[:1] for x in (apps, masks)) + tuple(x[1:2] for x in (apps, masks))
    return {
        "match_pairs": k1_batch,
        "match_pairs_b1": k1_pair,
        "join_candidates": join_args,
        "gather_rows": (pix_src, pix_idx),
        "gather_rows_apps": (app_src, app_idx),
        "track_frames": frame_args,
    }


def head_frames(args, frames: int):
    """A frame kernel's arguments cut to the first ``frames`` tracked frames."""
    from visual_odometry_tpu_torch.ops.kernels.frame_kernel import JoinCandidates

    params, tri, tri_ok, cand, prev_al, cur_al, valid = args[:7]
    cand = JoinCandidates(*(x[:frames].contiguous() for x in cand))
    return (params, tri, tri_ok, cand, prev_al[:frames].contiguous(),
            cur_al[:frames].contiguous(), valid[:frames].contiguous()) + tuple(args[7:])


def compare_frame_kernel(name, args, plain_frames, device, table, track):
    """K4 / K5: the kernel against its plain version over the first
    ``plain_frames`` frames (the plain version is a Python loop with a host
    sync per GN round), its time at the main path's full depth, and its bound
    from the GN rounds the plain version counted."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    planar = bool(args[-1])
    plain_frames = min(plain_frames, args[3].idx.shape[0])
    short = head_frames(args, plain_frames)
    kp = track(*short)[0]
    rounds = []
    pp, plain_ms = timed_call(
        lambda: frame_kernel.track_frames_plain(*short, rounds_out=rounds)[0], device)
    label = "K5" if planar else "K4"
    require(bool(torch.isfinite(kp).all()), f"{label}: non-finite poses")
    err = float((kp - pp).abs().max())
    tol = GN_POSE_TOL if planar else K4_POSE_TOL
    require(err <= tol, f"{label}: poses differ by {err} > {tol}")
    ms = time_ms(lambda: track(*args), device, 3)
    ms_short = time_ms(lambda: track(*short), device, 3)

    cand = args[3]
    f, depth, s = cand.idx.shape
    # The kernel does not report its round count; the plain version's mean
    # over the compared frames stands for the whole depth.
    rounds_per_frame = sum(rounds) / len(rounds)
    moved = nbytes(args[0], args[1], args[2], cand.idx, cand.ok, args[4], args[5], args[6])
    moved += f * (64 + s * 13 + 16)                      # poses, triangulation, stats out
    ops = f * s * (rounds_per_frame * ROUND_FLOPS[planar] + FRAME_FLOPS)
    bound_ms, bound_by = bound(moved, ops)
    table[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None, plain_frames=plain_frames,
                       ms_at_plain_frames=ms_short, gn_rounds_per_frame=rounds_per_frame,
                       us_per_gn_round=1e3 * ms_short / sum(rounds))


def compare_kernels(inputs, device, kernel_fns, reps: int = 10):
    """K1-K4: run each kernel and its plain version on the same inputs; returns
    {name: row fields} and raises on disagreement."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel, gather_kernel, matcher_kernel

    out = {}

    def k1_check(args, label):
        kd1, ki1, kd2, ki2 = kernel_fns["match_pairs"](*args)
        pd1, pi1, pd2, pi2 = matcher_kernel.match_pairs_plain(*args)
        sync(device)
        require(torch.equal(ki1, pi1) and torch.equal(ki2, pi2), f"K1 {label}: indices differ")
        err = 0.0
        for kd, pd in ((kd1, pd1), (kd2, pd2)):
            live = pd < 1e38
            diff = (kd - pd).abs()
            require(bool((diff <= K1_DIST_RTOL * pd.abs().clamp_min(1.0)).all()),
                    f"K1 {label}: distances differ beyond {K1_DIST_RTOL} relative")
            err = max(err, float(diff[live].max()) if bool(live.any()) else 0.0)
        return err

    a = inputs["match_pairs"]
    err = max(k1_check(a, "B=510"), k1_check(inputs["match_pairs_b1"], "B=1"))
    b, n, d = a[0].shape
    bound_ms, bound_by = bound(nbytes(*a) + 4 * b * n * 4, b * n * n * (2 * d + 3))
    out["match_pairs"] = dict(
        max_abs_err=err, ms=time_ms(lambda: kernel_fns["match_pairs"](*a), device, reps),
        plain_ms=time_ms(lambda: matcher_kernel.match_pairs_plain(*a), device, 3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    a = inputs["join_candidates"]
    kc = kernel_fns["join_candidates"](*a)
    pc = frame_kernel.join_candidates_plain(*a)
    require(all(torch.equal(x, y) for x, y in zip(kc, pc)), "K2: join candidates differ")
    f, s = a[0].shape
    bound_ms, bound_by = bound(nbytes(*a[:4]) + nbytes(*kc), f * s * s)   # one compare a pair
    out["join_candidates"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: kernel_fns["join_candidates"](*a), device, reps),
        plain_ms=time_ms(lambda: frame_kernel.join_candidates_plain(*a), device, 3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    for key in ("gather_rows", "gather_rows_apps"):
        a = inputs[key]
        require(torch.equal(kernel_fns["gather_rows"](*a), gather_kernel.gather_rows_plain(*a)),
                f"K3 {key}: gathers differ")
    a = inputs["gather_rows_apps"]
    idx64 = a[1].long()
    bound_ms, bound_by = bound(2 * nbytes(a[0]) + nbytes(a[1]), 0.0)
    out["gather_rows"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: kernel_fns["gather_rows"](*a), device, reps),
        plain_ms=time_ms(lambda: gather_kernel.gather_rows_plain(*a), device, reps),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(lambda: torch.gather(a[0], 2, idx64), device, reps))

    compare_frame_kernel("track_frames", inputs["track_frames"], K4_PLAIN_FRAMES, device, out,
                         kernel_fns["track_frames"])
    return out


def solve_problem(n: int, planar: bool, device, seed: int = 0):
    """A standalone PICP problem: N model points seen under a ground-truth pose
    (planar: a conjugated SE(2) motion), with pixel noise and dead slots."""
    import torch

    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.camera import project_points
    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    world = torch.from_numpy(np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                                       rng.uniform(2.0, 4.0, n)], 1).astype(np.float32))
    mount = mount_matrix("cpu")
    if planar:
        gt = se3.inverse(mount) @ se3.v2t_se2(torch.tensor([0.1, -0.05, 0.04])) @ mount
    else:
        gt = se3.v2t_euler(torch.tensor([0.1, -0.05, 0.02, 0.01, 0.02, -0.03]))
    uv, ok = project_points(synthetic.default_camera(gt), world)
    uv = uv + torch.from_numpy(rng.normal(0, 0.3, (n, 2)).astype(np.float32))
    w = ok.float()
    w[::9] = 0.0
    world = torch.where(w[:, None] > 0, world, 1.0)   # dead slots sanitized, as picp.solve does
    cam = synthetic.default_camera(device=device)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    if planar:
        head += (mount.to(device),)
    return head + (world.to(device), uv.to(device), w.to(device), 30, 1e4, 1.0, 1e-12), gt


def compare_solves(device, table, backend: str = "cuda", reps: int = 10):
    """K6: both standalone solves against their plain versions at N = 1024 and
    N = 8192 (more points than the block has threads)."""
    from visual_odometry_tpu_torch.ops.kernels import picp_kernel

    for planar, name in ((False, "picp_solve"), (True, "picp_solve_se2")):
        fn = picp_kernel.solve_se2_fused if planar else picp_kernel.solve_fused
        plain = picp_kernel.solve_se2_fused_plain if planar else picp_kernel.solve_fused_plain
        row = dict(max_abs_err=0.0, library_ms=None)
        for n in (1024, 8192):
            args, gt = solve_problem(n, planar, device)
            pose, stats = fn(*args, backend=backend)
            rounds = []
            (pose_p, stats_p), plain_ms = timed_call(lambda: plain(*args, rounds_out=rounds),
                                                     device)
            err = float((pose - pose_p).abs().max())
            require(err <= GN_POSE_TOL, f"K6 {name} N={n}: poses differ by {err}")
            require(int(stats.num_inliers) == int(stats_p.num_inliers),
                    f"K6 {name} N={n}: inlier counts differ")
            require(float((pose.cpu() - gt).abs().max()) < 5e-3,
                    f"K6 {name} N={n}: the solve missed the ground-truth pose")
            ms = time_ms(lambda: fn(*args, backend=backend), device, reps)
            launch_ms = None
            if backend == "cuda":   # the launch alone, the parameter row packed beforehand
                head, tail = (args[:3], args[4:]) if planar else (args[:3], args[3:])
                params = picp_kernel.pack_params(
                    head[0], head[2], head[1], tail[4], tail[5], tail[6], False, False, 0.0,
                    planar, args[3] if planar else None, k_inverse=False)
                packed = (params, *tail[:3], tail[3], 1, planar)
                launch_ms = time_ms(lambda: picp_kernel._solve_cuda(*packed), device, reps)
            moved = n * 6 * 4 + (64 if planar else 40) * 4 + 19 * 4
            bound_ms, bound_by = bound(moved, rounds[0] * n * ROUND_FLOPS[planar])
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row[f"n{n}"] = dict(ms=ms, launch_ms=launch_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, gn_rounds=rounds[0])
        # The row's times are those of the shape its path runs: path C solves
        # 1024 matches in SE(3); the standalone planar solve takes N = 8192.
        row.update(row["n8192" if planar else "n1024"])
        table[name] = row


def match_problem(nq: int, nk: int, device, seed: int = 0):
    """Queries near database rows; a tenth of the rows and a twentieth of the
    queries masked, NaN written into the masked rows."""
    import torch

    rng = np.random.default_rng(seed)
    db = rng.uniform(-1.0, 1.0, (nk, 10)).astype(np.float32)
    pick = rng.permutation(nk)[:nq]
    q = (db[pick] + rng.normal(0, 1e-3, (nq, 10))).astype(np.float32)
    db_mask = rng.uniform(size=nk) > 0.1
    q_mask = rng.uniform(size=nq) > 0.05
    db[~db_mask] = np.nan
    return tuple(torch.from_numpy(x).to(device) for x in (q, q_mask, db, db_mask)), pick


def compare_matchers(device, table, backend: str = "cuda", nq: int = 1024, nk: int = 1 << 20,
                     reps: int = 10):
    """K7: exact and fast against the plain version at map scale."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import matcher_kernel

    args, pick = match_problem(nq, nk, device)
    q, q_mask, db, db_mask = args
    d = q.shape[1]
    moved = nbytes(q, q_mask, db, db_mask) + nq * 8
    for fast, name in ((False, "best_match"), (True, "best_match_fast")):
        dist, idx = matcher_kernel.best_match(*args, backend=backend, fast=fast)
        (dist_p, idx_p), plain_ms = timed_call(
            lambda: matcher_kernel.best_match_plain(*args, fast=fast), device)
        require(torch.equal(idx, idx_p), f"K7 {name}: indices differ from the plain version")
        live = q_mask & (dist_p < 1e38)
        err = float((dist - dist_p)[live].abs().max())
        require(torch.equal(dist, dist_p), f"K7 {name}: distances differ by {err}")
        require(bool(db_mask[idx[q_mask].long()].all()), f"K7 {name}: a masked row won")
        require(bool((dist[~q_mask] > 1e38).all()), f"K7 {name}: a masked query got a distance")
        own = torch.from_numpy(pick).to(device)
        want = q_mask & db_mask[own]
        require(bool((idx[want] == own[want]).all()), f"K7 {name}: a query missed its own row")
        if fast:   # the bfloat16 gram at the tensor cores' rate, the selection in float32
            t_ops = 1e3 * (nq * nk * 2 * d / PEAK_BF16 + nq * nk * 3 / PEAK_FP32)
            bound_ms, bound_by = max((1e3 * moved / PEAK_BYTES_S, "bytes"), (t_ops, "operations"))
        else:
            bound_ms, bound_by = bound(moved, nq * nk * (2 * d + 3))
        table[name] = dict(
            max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            ms=time_ms(lambda: matcher_kernel.best_match(*args, backend=backend, fast=fast),
                       device, reps),
            # No single PyTorch call computes a top-1 over K = 2^20 rows without the
            # (Q, K) distance matrix in device memory.
            library_ms=None)


def serving_inputs(count: int, frames: int, slots: int, config, device):
    """``count`` stacked sequences (points, appearances, masks) of path E's
    kind, landmark fields 100 .. 100 + count - 1, none left out:
    ``generate_tracking_sequence(default_rng(seed), frames, slots)`` or, for a
    planar config, path D's kind of motion over landmark field ``seed``."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    seqs = []
    for seed in range(100, 100 + count):
        if config.planar:
            seqs.append(path_d_inputs(frames, slots, device, seed=seed))
        else:
            seqs.append(tuple(
                torch.from_numpy(x).to(device) for x in
                synthetic.generate_tracking_sequence(np.random.default_rng(seed), frames, slots)))
    return tuple(torch.stack([q[k] for q in seqs]).contiguous() for k in range(3))


def require_tracked(outs, traj, slots: int, label: str):
    """Every sequence of a serving batch tracked: finite poses and, the data
    being exact, every slot an inlier in every frame."""
    import torch

    require(bool(torch.isfinite(traj).all()), f"{label}: non-finite poses")
    least = outs.num_inliers.reshape(outs.num_inliers.shape[0], -1).min(dim=1).values
    lost = [[100 + i, int(v)] for i, v in enumerate(least.tolist()) if v < slots]
    require(not lost, f"{label}: fields that lost inliers [field, least of {slots}]: {lost}")


def compare_serving(camera, config, seqs, device, table, rounds_frames: int = 14, reps: int = 3):
    """K8 (SE(3), or planar for a planar config): one launch over all the
    sequences against K4/K5 launched alone on each (every output of every
    sequence), its time beside one single launch's, and the first sequence of
    that launch against the plain version over all its frames."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    planar = config.planar
    name = "track_frames_batched_planar" if planar else "track_frames_batched"
    count = seqs[0].shape[0]
    singles = [kernel_inputs(camera, config, *(x[i] for x in seqs))["track_frames"]
               for i in range(count)]

    def batched(rows):
        stack = lambda k: torch.stack([a[k] for a in rows]).contiguous()   # noqa: E731
        cand = frame_kernel.JoinCandidates(
            *(torch.stack([a[3][q] for a in rows]).contiguous() for q in range(3)))
        pose0 = torch.stack([a[0][28:40] for a in rows]).contiguous()
        return (rows[0][0], pose0, stack(1), stack(2), cand, stack(4), stack(5), stack(6),
                config.gn_iterations, config.gn_min_iterations, planar)

    args = batched(singles)
    out = frame_kernel.track_frames_batched_cuda(*args)
    require(all(bool(torch.isfinite(x.float()).all()) for x in out), f"{name}: non-finite output")
    least = out[3][..., 2].min(dim=1).values
    lost = [[100 + i, int(v)] for i, v in enumerate(least.tolist()) if v < seqs[0].shape[2]]
    require(not lost, f"{name}: fields that lost inliers [field, least]: {lost}")
    err_single = 0.0
    for i, a in enumerate(singles):
        alone = frame_kernel.track_frames_cuda(*a)
        err_single = max(err_single, max(float((o[i].float() - x.float()).abs().max())
                                         for o, x in zip(out, alone)))
    require(err_single == 0.0,
            f"{name}: a sequence differs from its single launch by {err_single}")

    first = batched(singles[:1])
    ref, plain_ms = timed_call(lambda: frame_kernel.track_frames_batched_plain(*first), device)
    err = float((out[0][:1] - ref[0]).abs().max())
    tol = GN_POSE_TOL if planar else K4_POSE_TOL
    require(err <= tol, f"{name}: poses differ from the plain version by {err} > {tol}")
    require(torch.equal(out[2][:1], ref[2]), f"{name}: triangulation validity differs from plain")

    ms = time_ms(lambda: frame_kernel.track_frames_batched_cuda(*args), device, reps)
    single_ms = time_ms(lambda: frame_kernel.track_frames_cuda(*singles[0]), device, reps)
    rounds = []
    frame_kernel.track_frames_plain(*head_frames(singles[0], rounds_frames), rounds_out=rounds)
    rounds_per_frame = sum(rounds) / len(rounds)
    n, f, depth, s = args[4].idx.shape
    moved = nbytes(args[0], args[1], args[2], args[3], args[4].idx, args[4].ok, args[5], args[6],
                   args[7]) + n * f * (64 + s * 13 + 16)
    ops = n * f * s * (rounds_per_frame * ROUND_FLOPS[planar] + FRAME_FLOPS)
    bound_ms, bound_by = bound(moved, ops)
    table[name] = dict(
        max_abs_err=err_single, max_abs_err_vs_plain=err, ms=ms, plain_ms=plain_ms,
        plain_shape=[1, f, s], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, sequences=n, frames=f, slots=s, single_launch_ms=single_ms,
        ms_over_single_launch=ms / single_ms,
        gn_rounds_per_frame_first_sequence_head=rounds_per_frame)


def corridor(device):
    """Path F(2)'s problem: ``generate_ba_corridor(f=512, l=100_000)``, the
    production point of benchmarks/bench_sparse_ba.py:38-47."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    k, problem, n_live = synthetic.generate_ba_corridor(f=BA_POSES, l=BA_LANDMARKS, device=device)
    return torch.from_numpy(k).to(device), problem, n_live


def compare_sparse_ba_kernels(problem, device, table, reps: int = 10):
    """K9 and K10 at the shapes a sparse-BA step gives them: the corridor's
    own frame ids (masked observations dropped through id T) and pose rows;
    K9 at R = 36 and 6 with random rows beside ``index_add_``, K10 at R = 12
    (the pose rows) and 6 beside ``index_select``."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import gather_kernel, segsum_kernel

    f = problem.poses.shape[0]
    n = problem.uv.shape[0]
    rng = np.random.default_rng(0)
    seg = torch.where(problem.obs_mask, problem.frame_idx, f).contiguous()
    seg64 = seg.long()
    row = dict(max_abs_err=0.0)
    for r in (36, 6):
        vals = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32)).to(device)
        got = segsum_kernel.segment_sum_small_cuda(vals, seg, f)
        ref = segsum_kernel.segment_sum_small_plain(vals, seg, f)
        again = segsum_kernel.segment_sum_small_cuda(vals, seg, f)
        err = float((got - ref).abs().max())
        require(bool(torch.isclose(got, ref, rtol=K9_RTOL, atol=K9_ATOL).all()),
                f"K9 R={r}: sums differ from the plain version by {err}")
        bound_ms, bound_by = bound(nbytes(vals, seg) + f * r * 4, n * r)

        def library():
            return torch.zeros((f + 1, r), device=device).index_add_(0, seg64, vals)

        row[f"r{r}"] = dict(
            ms=time_ms(lambda: segsum_kernel.segment_sum_small_cuda(vals, seg, f), device, reps),
            plain_ms=time_ms(lambda: segsum_kernel.segment_sum_small_plain(vals, seg, f), device,
                             reps),
            library_ms=time_ms(library, device, reps), bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=err, run_to_run_max_abs_diff=float((got - again).abs().max()))
        row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update({k: v for k, v in row["r36"].items() if k != "max_abs_err"})
    row.update(rows=n, segments=f)
    table["segment_sum"] = row

    idx = torch.where(problem.obs_mask, problem.frame_idx, 0).contiguous()
    idx64 = idx.long()
    pose_rows = problem.poses[:, :3, :4].reshape(f, 12).T.contiguous()
    row = dict(max_abs_err=0.0)
    for r in (12, 6):
        tab = pose_rows[:r].contiguous()
        got = gather_kernel.take_table_cuda(tab, idx)
        require(torch.equal(got, gather_kernel.take_table_plain(tab, idx)),
                f"K10 R={r}: the gather differs from the plain version")
        bound_ms, bound_by = bound(nbytes(tab, idx, got), 0.0)
        row[f"r{r}"] = dict(
            ms=time_ms(lambda: gather_kernel.take_table_cuda(tab, idx), device, reps),
            plain_ms=time_ms(lambda: gather_kernel.take_table_plain(tab, idx), device, reps),
            library_ms=time_ms(lambda: torch.index_select(tab, 1, idx64), device, reps),
            bound_ms=bound_ms, bound_by=bound_by)
    edge = torch.tensor([-7, 0, f - 1, f, 2**30], dtype=torch.int32, device=device)
    require(torch.equal(gather_kernel.take_table_cuda(pose_rows, edge),
                        gather_kernel.take_table_plain(pose_rows, edge)),
            "K10: out-of-range indices are not clipped like the plain version's")
    row.update(row["r12"])
    row.update(columns=n, table_columns=f)
    table["take_table"] = row


def linearize_problem(n: int, device, seed: int = 0):
    """The workload of benchmarks/bench_picp.py: uniform points, the default
    camera at the identity, uniform measurements, every weight 1."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    world = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(1, 4, n)],
                     axis=1).astype(np.float32)
    meas = rng.uniform(0, 480, (n, 2)).astype(np.float32)
    cam = synthetic.default_camera(device=device)
    return cam, tuple(torch.from_numpy(x).to(device)
                      for x in (world, meas, np.ones(n, np.float32)))


def compare_linearize(device, table, reps: int = 10):
    """K11 against its plain version at N = 1024 and N = 8192, robust kernel
    thresholds that keep and that split the points, ``keep_outliers`` both ways."""
    from visual_odometry_tpu_torch.ops.kernels import picp_kernel

    row = dict(max_abs_err=0.0, library_ms=None)
    for n in (1024, 8192):
        cam, pts = linearize_problem(n, device)
        head = (cam.camera_matrix, cam.world_in_camera, cam.params())
        err = 0.0
        for kt, keep in ((1e4, False), (2e3, True)):
            h, b, st = picp_kernel.linearize(*head, *pts, kt, keep, backend="cuda")
            hp, bp, stp = picp_kernel.linearize_plain(*head, *pts, kt, keep)
            scale = float(hp.abs().max())
            err = max(err, float((h - hp).abs().max()) / scale,
                      float((b - bp).abs().max()) / max(float(bp.abs().max()), 1.0))
            require(err <= K11_RTOL, f"K11 N={n}: H or b differs from the plain version by {err}")
            require(int(st.num_inliers) == int(stp.num_inliers) and 0 < int(st.num_inliers) < n,
                    f"K11 N={n}: inlier counts differ or the threshold split nothing")
        params = picp_kernel.pack_params(*head[:1], head[2], head[1], 1e4, 0.0, 0.0, False, False,
                                         0.0, k_inverse=False)
        bound_ms, bound_by = bound(n * 6 * 4 + 40 * 4 + 45 * 4, n * ROUND_FLOPS[False])
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row[f"n{n}"] = dict(
            ms=time_ms(lambda: picp_kernel.linearize(*head, *pts, 1e4, backend="cuda"), device,
                       reps),
            launch_ms=time_ms(lambda: picp_kernel._linearize_cuda(params, *pts), device, reps),
            plain_ms=time_ms(lambda: picp_kernel.linearize_plain(*head, *pts, 1e4), device, 3),
            bound_ms=bound_ms, bound_by=bound_by)
    row.update(row["n8192"])
    table["picp_linearize"] = row


def read_launches(names, label: str, must: bool = True):
    from visual_odometry_tpu_torch.ops.kernels import _lib

    launches = dict(_lib.launches)
    if must:
        require(all(launches[n] > 0 for n in names), f"{label}: a kernel never ran: {launches}")
    return launches


def check_accuracy(res, label: str):
    finite = np.isfinite(res.orientation_errors)
    e_theta = float(np.abs(res.orientation_errors[finite]).mean())
    require(e_theta < 1e-4, f"{label}: mean |e_theta| {e_theta} >= 1e-4")
    require(res.rmse_position < 0.2, f"{label}: rmse_position {res.rmse_position} >= 0.2")
    require(res.n_map_matched > 100, f"{label}: only {res.n_map_matched} map landmarks matched")
    return {"e_theta_mean": e_theta, "rmse_position": res.rmse_position,
            "rmse_map": res.rmse_map, "n_map_matched": res.n_map_matched}


def run_path_a(work_dir: str, device, require_launches: bool = True):
    """The reference-format applications on a generated dataset."""
    import torch

    from visual_odometry_tpu_torch import apps
    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.utils import dataset_gen, io
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG

    data = os.path.join(work_dir, "data")
    outs = {n: os.path.join(work_dir, n) for n in ("complete", "se2", "daknown", "reloc")}
    dataset_gen.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    report = {}
    _lib.reset_launches()
    apps.run_vo_complete(data, outs["complete"], device=device, verbose=True)
    sync(device)
    read_launches(MAIN_PATH, "path A vo_complete", require_launches)
    report["vo_complete"] = check_accuracy(apps.run_evaluation(data, outs["complete"]), "path A")

    traj_se2 = apps.run_vo_se2(data, outs["se2"], device=device, verbose=True)[0]
    report["vo_se2"] = check_accuracy(apps.run_evaluation(data, outs["se2"]), "path A vo_se2")
    mount = torch.from_numpy(io.load_camera_params(os.path.join(data, "camera.dat")).cam_in_robot)
    dev_se2 = se3.planar_deviation(torch.from_numpy(traj_se2), mount)
    report["vo_se2"]["planar_subgroup_dev"] = dev_se2
    require(dev_se2 < PLANAR_DEV_TOL, f"path A vo_se2: planar deviation {dev_se2}")

    traj_known = apps.run_vo_da_known(data, outs["daknown"], device=device, verbose=True)[0]
    require(bool(np.isfinite(traj_known).all()), "path A vo_daknown: non-finite poses")
    require(os.path.getsize(os.path.join(outs["daknown"], "time_known.txt")) > 0,
            "path A vo_daknown: time_known.txt is empty")

    for precision in ("highest", "fast"):
        rows = apps.run_relocalize(data, outs["reloc"], every=10, device=device,
                                   config=DEFAULT_CONFIG.replace(matcher_precision=precision))
        require(len(rows) == 3, f"path A relocalize: {len(rows)} rows")
        for f, err_t, err_r, n_matches, n_inliers in rows:   # tests/test_relocalize.py:91-92
            require(err_t < 0.05 and err_r < 1e-3,
                    f"path A relocalize ({precision}) frame {f}: {err_t}, {err_r}")
        report["relocalize_" + precision] = [list(r) for r in rows]
    sync(device)
    launches = read_launches(PATH_A, "path A", require_launches)
    report["launches"] = launches
    print(json.dumps({"path_a": report}))
    return launches


def run_path_b(camera, config, pts, apps, masks, device, require_launches: bool = True,
               reps: int = 3):
    """Full-width tracking through the kernels, held against the plain versions."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import _lib

    _lib.reset_launches()
    traj, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, masks)
    sync(device)
    launches = read_launches(MAIN_PATH, "path B", require_launches)
    require(bool(torch.isfinite(traj).all()), "path B: non-finite poses")
    plain = config.replace(matcher_backend="torch", scan_backend="torch")
    traj_p, map_p, _ = pipeline.run_sequence(camera, plain, pts, apps, masks)
    err = float((traj - traj_p).abs().max())
    require(err <= K4_POSE_TOL, f"path B: kernel and plain trajectories differ by {err}")
    require(int(map_state.count) == int(map_p.count), "path B: map sizes differ")

    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        traj, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, masks)
        sync(device)
        seconds.append(time.perf_counter() - t0)
    frames = pts.shape[0]
    fps = frames / statistics.median(seconds)
    print(json.dumps({"path_b": {"frames": frames, "slots": pts.shape[1],
                                 "traj_max_abs_err_vs_plain": err,
                                 "map_landmarks": int(map_state.count),
                                 "inliers_mean": float(outs.num_inliers.float().mean()),
                                 "seconds": seconds, "launches": launches}}))
    print(f"path B frames/s: {fps:.1f} ({frames} frames x {pts.shape[1]} slots, median of {reps})")
    return launches, err, fps


def path_c_inputs(device, map_rows: int, queries: int):
    """The relocalization workload of benchmarks/bench_reloc.py:43-69: a map of
    ``map_rows`` landmarks, one frame of ``queries`` drawn from it and projected
    through the default camera, identity prior. Returns (camera, map, frame,
    prior, each query's own map row)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.models.landmark_map import LandmarkMap
    from visual_odometry_tpu_torch.ops.camera import project_points
    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(0)
    world = np.stack([rng.uniform(-2.5, 2.5, map_rows), rng.uniform(-2.0, 2.0, map_rows),
                      rng.uniform(2.0, 6.0, map_rows)], axis=1).astype(np.float32)
    keys = rng.uniform(-1.0, 1.0, (map_rows, 10)).astype(np.float32)
    own = torch.from_numpy(rng.integers(0, map_rows, queries)).to(device)
    map_state = LandmarkMap(
        points=torch.from_numpy(world).to(device), appearances=torch.from_numpy(keys).to(device),
        valid=torch.ones(map_rows, dtype=torch.bool, device=device),
        count=torch.tensor(map_rows, dtype=torch.int32, device=device))
    camera = synthetic.default_camera(device=device)
    uv, valid = project_points(camera, map_state.points[own])
    frame = pipeline.FrameData(uv, map_state.appearances[own].contiguous(), valid,
                               torch.full((queries,), -1, dtype=torch.int32, device=device))
    return camera, map_state, frame, torch.eye(4, device=device), own


def run_path_c(device, map_rows: int = 1 << 20, queries: int = 1024,
               require_launches: bool = True, reps: int = 3):
    """Map-scale relocalization (the workload of benchmarks/bench_reloc.py):
    one frame of queries drawn from the map and projected through the default
    camera, identity prior, both matcher precisions; then the standalone planar
    solve at N = 8 x queries through its public entry point."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops import matching
    from visual_odometry_tpu_torch.ops.kernels import _lib, picp_kernel
    from visual_odometry_tpu_torch.utils.config import VOConfig

    camera, map_state, frame, x0, own = path_c_inputs(device, map_rows, queries)
    valid = frame.mask

    def config(precision):
        return VOConfig(n_slots=queries, map_capacity=map_rows, gn_iterations=30,
                        matcher_precision=precision)

    report, launches = {}, {}
    for precision in ("highest", "fast"):
        _lib.reset_launches()
        pose, stats, n_matches = pipeline.relocalize_frame(camera, config(precision), map_state,
                                                           frame, x0)
        sync(device)
        key = "best_match_fast" if precision == "fast" else "best_match"
        ran = dict(_lib.launches)
        if require_launches:
            require(ran[key] == 1 and ran["picp_solve"] == 1,
                    f"path C ({precision}): K7 and K6 must launch once each: {ran}")
        launches[key] = ran[key]
        launches["picp_solve"] = launches.get("picp_solve", 0) + ran["picp_solve"]
        _, idx = matching.best_match(frame.appearances, frame.mask, map_state.appearances,
                                     map_state.valid, precision=precision)
        require(bool((idx[valid] == own[valid]).all()),
                f"path C ({precision}): a query missed its own map row")
        require(int(n_matches) == int(valid.sum()), f"path C ({precision}): match count")
        err = float((pose - x0).abs().max())
        require(bool(torch.isfinite(pose).all()) and err < 1e-3,
                f"path C ({precision}): pose is {err} from identity")
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pipeline.relocalize_frame(camera, config(precision), map_state, frame, x0)
            sync(device)
            seconds.append(time.perf_counter() - t0)
        report[precision] = {"pose_err": err, "matches": int(n_matches),
                             "inliers": int(stats.num_inliers), "seconds": seconds,
                             "queries_per_s": queries / statistics.median(seconds)}

    # The planar standalone solve has no caller in the pipeline (as in the JAX
    # package): it is driven here through its public entry point.
    args, gt = solve_problem(8 * queries, True, device, seed=1)
    _lib.reset_launches()
    pose, stats = picp_kernel.solve_se2_fused(*args)
    sync(device)
    launches["picp_solve_se2"] = _lib.launches["picp_solve_se2"]
    if require_launches:
        require(launches["picp_solve_se2"] == 1, "path C: the planar solve did not launch")
    err = float((pose.cpu() - gt).abs().max())
    require(err < 5e-3, f"path C planar solve: {err} from the ground-truth pose")
    report["solve_se2"] = {"n": 8 * queries, "pose_err": err, "inliers": int(stats.num_inliers)}
    launches = {k: launches.get(k, 0) for k in KERNELS}
    report["launches"] = launches
    print(json.dumps({"path_c": report}))
    for precision in ("highest", "fast"):
        print(f"path C queries/s ({precision}): {report[precision]['queries_per_s']:.0f} "
              f"({queries} queries x {map_rows} map rows, median of {reps})")
    return launches


def run_path_d(camera, planar, pts, apps, masks, device, require_launches: bool = True,
               reps: int = 3):
    """The planar estimation group at full width (path_d_inputs), kernels only."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.kernels import _lib

    mount = torch.from_numpy(planar.planar_mount())
    _lib.reset_launches()
    traj, map_state, outs = pipeline.run_sequence(camera, planar, pts, apps, masks)
    sync(device)
    launches = read_launches(("match_pairs", "join_candidates", "gather_rows",
                              "track_frames_planar"), "path D", require_launches)
    if require_launches:
        require(launches["track_frames_planar"] == 1 and launches["track_frames"] == 0,
                f"path D: K5 must launch once and K4 not at all: {launches}")
    require(bool(torch.isfinite(traj).all()), "path D: non-finite poses")
    dev = se3.planar_deviation(traj.cpu(), mount)
    require(dev < PLANAR_DEV_TOL, f"path D: planar-subgroup deviation {dev}")
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipeline.run_sequence(camera, planar, pts, apps, masks)
        sync(device)
        seconds.append(time.perf_counter() - t0)
    frames = pts.shape[0]
    print(json.dumps({"path_d": {"frames": frames, "slots": pts.shape[1],
                                 "planar_subgroup_dev": dev,
                                 "map_landmarks": int(map_state.count),
                                 "inliers_mean": float(outs.num_inliers.float().mean()),
                                 "seconds": seconds, "launches": launches}}))
    print(f"path D frames/s: {frames / statistics.median(seconds):.1f} "
          f"({frames} frames x {pts.shape[1]} slots, planar, median of {reps})")
    return launches


def run_resume(camera, config, pts, apps, masks, device, work_dir: str, split: int = 256,
               require_launches: bool = True):
    """initialize on frames 0/1, then continue_sequence once over the rest
    against twice over two halves with a checkpoint round trip between them
    (tests/test_checkpoint.py:80-131)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.utils import checkpoint

    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    f0 = pipeline.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps[1], masks[1], ids[1])
    state0, x_init = pipeline.initialize(camera, config, f0, f1)

    def cont(state, lo, hi):
        return pipeline.continue_sequence(camera, config, state, pts[lo:hi], apps[lo:hi],
                                          masks[lo:hi], ids[lo:hi])

    _lib.reset_launches()
    full_state, full = cont(state0, 2, None)
    state_a, out_a = cont(state0, 2, split)
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "state.npz")
    traj_a = torch.cat([torch.eye(4, device=device)[None], x_init[None], out_a.pose])
    checkpoint.save_state(path, state_a, traj_a.cpu().numpy())
    state_l, traj_l = checkpoint.load_state(path, device=device)
    require(np.array_equal(traj_l, traj_a.cpu().numpy()), "resume: the trajectory changed on disk")
    state_b, out_b = cont(state_l, split, None)
    sync(device)
    launches = read_launches(MAIN_PATH, "resume", require_launches)

    pose_err = float((full.pose - torch.cat([out_a.pose, out_b.pose])).abs().max())
    require(pose_err <= K4_POSE_TOL, f"resume: split and one-shot poses differ by {pose_err}")
    require(torch.equal(full_state.map.valid, state_b.map.valid)
            and torch.equal(full_state.map.appearances, state_b.map.appearances),
            "resume: map layouts differ")
    require(torch.equal(full_state.point_lookup, state_b.point_lookup),
            "resume: carried lookups differ")
    map_err = float((full_state.map.points - state_b.map.points).abs().max())
    require(map_err <= 1e-4, f"resume: map positions differ by {map_err}")   # test_checkpoint.py:118
    print(json.dumps({"resume": {"split": split, "pose_max_abs_err": pose_err,
                                 "map_pos_max_abs_err": map_err,
                                 "map_landmarks": int(state_b.map.count), "launches": launches}}))
    return launches


def run_step_form(camera, config, pts, apps, masks, device, frames: int = 18,
                  require_launches: bool = True):
    """``scan_backend="step"`` at full width over the head of path B's inputs:
    the frame_step loop solves each tracked frame through one K6 launch and is
    held against the fused K4 launch on the same frames."""
    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import _lib

    head = (pts[:frames], apps[:frames], masks[:frames])
    traj_f, map_f, _ = pipeline.run_sequence(camera, config, *head)
    _lib.reset_launches()
    t0 = time.perf_counter()
    traj_s, map_s, _ = pipeline.run_sequence(camera, config.replace(scan_backend="step"), *head)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(_lib.launches)
    if require_launches:
        require(launches["picp_solve"] == frames - 2 and launches["track_frames"] == 0,
                f"step form: K6 must launch once a tracked frame and K4 not at all: {launches}")
    err = float((traj_s - traj_f).abs().max())
    require(err <= K4_POSE_TOL, f"step form: step and fused trajectories differ by {err}")
    require(int(map_s.count) == int(map_f.count), "step form: map sizes differ")
    print(json.dumps({"step_form": {"frames": frames, "slots": pts.shape[1],
                                    "traj_max_abs_err_vs_fused": err, "seconds": seconds,
                                    "launches": launches}}))
    return launches


def run_path_e(camera, serving, device, require_launches: bool = True, reps: int = 3,
               planar_count: int = 8):
    """Serving at full width: 64 sequences x 128 frames x 128 slots (the shape
    benchmarks/bench_pipeline.py serves, from synthetic data) through
    run_sequences_batched, each sequence held against its own run_sequence;
    then a planar batch of 8 on path D's kind of motion. ``serving`` maps
    planar False/True to (config, the batch of ``serving_inputs``)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import multiseq

    report, launches = {}, {k: 0 for k in KERNELS}
    mount = mount_matrix("cpu")
    for planar in (False, True):
        config, seqs = serving[planar]
        if planar:
            seqs = tuple(x[:planar_count].contiguous() for x in seqs)
        count, n_frames, n_slots = seqs[0].shape[:3]
        k8 = "track_frames_batched_planar" if planar else "track_frames_batched"
        label = "path E planar" if planar else "path E"
        _lib.reset_launches()
        traj, maps, outs = multiseq.run_sequences_batched(camera, config, *seqs)
        sync(device)
        ran = read_launches(("match_pairs", "join_candidates", "gather_rows", k8), label,
                            require_launches)
        if require_launches:
            want = {"match_pairs": 2, "join_candidates": 1, "gather_rows": 2, k8: 1,
                    "track_frames": 0, "track_frames_planar": 0}
            require(all(ran[k] == v for k, v in want.items()),
                    f"{label}: K1-K3 must launch once a stage over the batch and K8 once: {ran}")
        for k, v in ran.items():
            launches[k] += v
        require_tracked(outs, traj, n_slots, label)
        err, single_s = 0.0, []
        for i in range(count):
            t0 = time.perf_counter()
            t_i, m_i, _ = pipeline.run_sequence(camera, config, *(x[i] for x in seqs))
            sync(device)
            single_s.append(time.perf_counter() - t0)
            err = max(err, float((traj[i] - t_i).abs().max()))
            require(int(maps.count[i]) == int(m_i.count), f"{label}: sequence {i}'s map size")
        require(err <= K4_POSE_TOL, f"{label}: a sequence is {err} from its own run_sequence")
        if planar:
            dev = max(se3.planar_deviation(traj[i].cpu(), mount) for i in range(count))
            require(dev < PLANAR_DEV_TOL, f"{label}: planar-subgroup deviation {dev}")
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            multiseq.run_sequences_batched(camera, config, *seqs)
            sync(device)
            seconds.append(time.perf_counter() - t0)
        frames = count * n_frames
        serial = count * statistics.median(single_s)
        report["planar" if planar else "se3"] = {
            "sequences": count, "frames": n_frames, "slots": n_slots,
            "traj_max_abs_err_vs_run_sequence": err,
            "map_landmarks_mean": float(maps.count.float().mean()),
            "inliers_mean": float(outs.num_inliers.float().mean()), "seconds": seconds,
            "frames_per_s": frames / statistics.median(seconds),
            "single_sequence_seconds_median": statistics.median(single_s),
            "sequences_x_single_seconds": serial, "frames_per_s_serial": frames / serial,
            "launches": ran}
        print(f"{label} frames/s: {frames / statistics.median(seconds):.1f} batched, "
              f"{frames / serial:.1f} as {count} x run_sequence ({count} sequences x "
              f"{n_frames} frames x {n_slots} slots, median of {reps})")
    report["launches"] = launches
    print(json.dumps({"path_e": report}))
    return launches


def run_path_f(work_dir: str, device, ba_problem, require_launches: bool = True):
    """Refinement: (1) path A's dataset through vo_complete with 5 refinement
    iterations, sparse and dense, and the evaluation; (2) ``BA_STEPS`` steps of
    sparse bundle adjustment at 512 poses x 100,000 landmarks, packed and
    unpacked, under a fixed budget of ``BA_CG`` CG iterations (tolerance 0)."""
    import torch

    from visual_odometry_tpu_torch import apps
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import sparse_ba
    from visual_odometry_tpu_torch.utils import dataset_gen
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG

    data = os.path.join(work_dir, "data_f")
    dataset_gen.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    report, launches = {}, {k: 0 for k in KERNELS}
    results = {}
    for backend in (None, "sparse", "dense"):
        out = os.path.join(work_dir, "refine_" + str(backend))
        config = DEFAULT_CONFIG if backend is None else DEFAULT_CONFIG.replace(
            refine_iterations=5, refine_backend=backend)
        _lib.reset_launches()
        t0 = time.perf_counter()
        apps.run_vo_complete(data, out, config, device=device, verbose=False)
        sync(device)
        seconds = time.perf_counter() - t0
        ran = dict(_lib.launches)
        for k, v in ran.items():
            launches[k] += v
        res = apps.run_evaluation(data, out, verbose=False)
        results[backend] = res
        report["vo_complete_" + (backend or "unrefined")] = dict(
            check_accuracy(res, f"path F(1) {backend}"), seconds=seconds,
            segment_sum_launches=ran["segment_sum"], take_table_launches=ran["take_table"])
        if require_launches:
            used = ran["segment_sum"] > 0 and ran["take_table"] > 0
            require(used == (backend == "sparse"),
                    f"path F(1) {backend}: K9/K10 launches {ran}")
    # Bundle adjustment lowers the reprojection error. On this dataset the aligned
    # position and map errors then move by a few percent either way (the map 5%
    # down on one device and up on another): both must stay within 10%.
    base = results[None]
    for backend in ("sparse", "dense"):
        for metric in ("rmse_position", "rmse_map"):
            got, ref = getattr(results[backend], metric), getattr(base, metric)
            require(got <= ref * 1.1, f"path F(1) {backend}: refinement took {metric} from "
                                      f"{ref} to {got}, more than 10% up")
    gap = abs(results["sparse"].rmse_position - results["dense"].rmse_position)
    require(gap < 1e-3, f"path F(1): sparse and dense RMSE_position differ by {gap}")

    k, problem, n_live = ba_problem
    packed, degree = sparse_ba.pack_problem(problem)
    require(degree is not None, "path F(2): the corridor did not pack")
    for label, work, deg in (("packed", packed, degree), ("unpacked", problem, None)):
        sparse_ba.sparse_ba_step(k, work, cg_iterations=2, cg_tolerance=0.0, lm_degree=deg)
        sync(device)                                                    # warm-up
        _lib.reset_launches()
        chis, residuals = [], []
        t0 = time.perf_counter()
        for _ in range(BA_STEPS):
            work, stats = sparse_ba.sparse_ba_step(k, work, cg_iterations=BA_CG, cg_tolerance=0.0,
                                                   lm_degree=deg)
            chis.append(stats.chi)
            residuals.append(stats.cg_residual)
        sync(device)
        seconds = time.perf_counter() - t0
        ran = dict(_lib.launches)
        for name, v in ran.items():
            launches[name] += v
        chis = [float(c) for c in chis]
        residuals = [float(r) for r in residuals]
        # A step with i CG iterations: K10 = pose rows + i matvecs + the
        # back-substitution, K9 = H_pp, b_p, the preconditioner's diagonal, the
        # reduced right-hand side + i matvecs (parallel/sparse_ba.sparse_ba_step).
        want = {"take_table": BA_STEPS * (2 + BA_CG), "segment_sum": BA_STEPS * (4 + BA_CG)}
        if require_launches:
            require(all(ran[name] == v for name, v in want.items()),
                    f"path F(2) {label}: K9/K10 launched {ran}, reckoned {want}")
        require(all(np.isfinite(chis)) and chis[-1] < chis[0],
                f"path F(2) {label}: chi did not fall: {chis}")
        require(all(np.isfinite(residuals)), f"path F(2) {label}: CG residual {residuals}")
        require(bool(torch.isfinite(work.poses).all() and torch.isfinite(work.landmarks).all()),
                f"path F(2) {label}: non-finite unknowns")
        report["sparse_ba_" + label] = {
            "poses": BA_POSES, "landmarks": BA_LANDMARKS, "observations": n_live,
            "observation_slots": int(work.uv.shape[0]), "lm_steps": BA_STEPS,
            "cg_iterations": BA_CG, "chi": chis, "cg_residual": residuals,
            "ms_per_lm_step": 1e3 * seconds / BA_STEPS,
            "segment_sum_launches": ran["segment_sum"], "take_table_launches": ran["take_table"]}
        print(f"path F(2) sparse BA {label}: {1e3 * seconds / BA_STEPS:.1f} ms an LM step "
              f"({BA_POSES} poses x {BA_LANDMARKS} landmarks, {n_live} observations, "
              f"{BA_CG} CG iterations)")
    report["launches"] = launches
    print(json.dumps({"path_f": report}))
    return launches


def run_path_g(device, n: int = 8192, require_launches: bool = True, reps: int = 10):
    """K11 through its public entry point on the workload of
    benchmarks/bench_picp.py, beside ``ops.picp.linearize`` (plain tensor
    operations on the card): other arithmetic for the same system, so H and b
    are held to 1e-4 of their largest entry and the inlier count exactly."""
    from visual_odometry_tpu_torch.ops import picp
    from visual_odometry_tpu_torch.ops.kernels import _lib, picp_kernel

    cam, pts = linearize_problem(n, device, seed=1)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    _lib.reset_launches()
    h, b, st = picp_kernel.linearize(*head, *pts, 1e4)
    sync(device)
    launches = {k: _lib.launches[k] for k in KERNELS}
    if require_launches:
        require(launches["picp_linearize"] == 1, f"path G: K11 did not launch once: {launches}")
    h2, b2, st2 = picp.linearize(cam, *pts, 1e4)
    err_h = float((h - h2).abs().max()) / float(h2.abs().max())
    err_b = float((b - b2).abs().max()) / float(b2.abs().max())
    require(err_h < 1e-4 and err_b < 1e-4, f"path G: H {err_h}, b {err_b} from picp.linearize")
    require(int(st.num_inliers) == int(st2.num_inliers), "path G: inlier counts differ")
    kernel_ms = time_ms(lambda: picp_kernel.linearize(*head, *pts, 1e4), device, reps)
    ops_ms = time_ms(lambda: picp.linearize(cam, *pts, 1e4), device, reps)
    print(json.dumps({"path_g": {"n": n, "h_rel_err": err_h, "b_rel_err": err_b,
                                 "inliers": int(st.num_inliers), "kernel_ms": kernel_ms,
                                 "picp_linearize_ops_ms": ops_ms, "launches": launches}}))
    print(f"path G linearization at N={n}: K11 {kernel_ms:.3f} ms, picp.linearize as tensor "
          f"operations {ops_ms:.3f} ms (median of {reps})")
    return launches


def stage_report(device, frames: int = 512, slots: int = 1024, map_rows: int = 1 << 20,
                 reps: int = 5) -> dict:
    """Stage times of run_sequence on path B's and path D's inputs and of
    relocalize_frame on path C's: the entry points themselves, run inside
    ``profiling.stage_times`` so that each step the pipeline wraps in
    ``profiling.stage`` is sampled on the host clock and ended by a sync (ms,
    median of ``reps`` after one warm-up). Then one more call of each under
    torch.profiler gives the time of each of the port's kernels and the
    device-busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.parallel import multiseq, sparse_ba
    from visual_odometry_tpu_torch.utils import profiling, synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig

    own = ("match_pairs", "join_candidates", "gather_rows", "track_frames", "picp_solve",
           "best_match_scan", "best_match_fold", "segment_sum", "take_table",
           "picp_linearize")   # csrc/*.cu name their kernels <this>_kernel

    def measured(fn):
        with profiling.stage_times() as timer:
            for _ in range(reps + 1):
                fn()
        out = {"stages_ms": {k: 1e3 * statistics.median(v[1:])
                             for k, v in timer.samples.items()}}
        require(out["stages_ms"], "stages: the entry point ran no profiling.stage block")
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(device)
            wall = time.perf_counter() - t0
        # Device events only, the vo/ ranges' own device-side spans left out.
        on_card = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith("vo/")]
        busy_us = sum(e.time_range.elapsed_us() for e in on_card)
        require(busy_us > 0, "stages: the profiler saw no device time")
        kernels = {}
        for e in on_card:
            for k in own:
                if k + "_kernel" in e.name:
                    row = kernels.setdefault(k, {"device_ms": 0.0, "launches": 0})
                    row["device_ms"] += e.time_range.elapsed_us() / 1e3
                    row["launches"] += 1
        out.update(kernels=kernels, device_busy_ms=busy_us / 1e3, wall_ms=1e3 * wall,
                   busy_share=busy_us / 1e6 / wall)
        return out

    camera = synthetic.deep_camera(device=device)
    config = VOConfig(n_slots=slots, map_capacity=2 * slots)
    planar = config.with_planar_mount(mount_matrix("cpu").numpy())
    seq_b, seq_d = path_b_inputs(frames, slots, device), path_d_inputs(frames, slots, device)
    report = {"path_b": measured(lambda: pipeline.run_sequence(camera, config, *seq_b)),
              "path_d": measured(lambda: pipeline.run_sequence(camera, planar, *seq_d))}
    # The frame_step loop over the head of path B: one K6 launch a tracked frame.
    step = config.replace(scan_backend="step")
    head = tuple(x[:34] for x in seq_b)
    report["path_b_step_34_frames"] = measured(lambda: pipeline.run_sequence(camera, step, *head))
    del seq_b, seq_d, head
    # Path E: the serving batch; path F(2): one sparse-BA step in each layout.
    seq_e = serving_inputs(SERVE_B, SERVE_FRAMES, SERVE_SLOTS, DEFAULT_CONFIG, device)
    report["path_e"] = measured(
        lambda: multiseq.run_sequences_batched(camera, DEFAULT_CONFIG, *seq_e))
    del seq_e
    k, problem, _ = corridor(device)
    packed, degree = sparse_ba.pack_problem(problem)
    for label, work, deg in (("packed", packed, degree), ("unpacked", problem, None)):
        report["path_f_sparse_step_" + label] = measured(lambda: sparse_ba.sparse_ba_step(
            k, work, cg_iterations=BA_CG, cg_tolerance=0.0, lm_degree=deg))
    del problem, packed
    camera, map_state, frame, x0, _ = path_c_inputs(device, map_rows, slots)
    for precision in ("highest", "fast"):
        cfg = VOConfig(n_slots=slots, map_capacity=map_rows, gn_iterations=30,
                       matcher_precision=precision)
        report["path_c_" + precision] = measured(
            lambda: pipeline.relocalize_frame(camera, cfg, map_state, frame, x0))
    return report


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    require(res.returncode == 0, "nvidia-smi failed: " + res.stdout)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from visual_odometry_tpu_torch.ops.kernels import (
        _lib, frame_kernel, gather_kernel, matcher_kernel,
    )
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig

    device = torch.device("cuda")
    if sys.argv[1:] == ["--stages"]:
        print(nvidia_smi_line())
        print(json.dumps({"stages": stage_report(device)}))
        return 0
    t_start = time.perf_counter()

    def phase(label: str, t0: float) -> None:
        print(f"[{label}: {time.perf_counter() - t0:.1f} s]")

    # ---- 1. environment ----
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_lib._nvcc(), "--version"], stdout=subprocess.PIPE, text=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(nvcc.stdout.strip().splitlines()[-1])
    print(smi)

    # ---- 2. build ----
    path, seconds, log = _lib.build()
    _lib.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # ---- 3. kernels vs plain versions at the main path's shapes ----
    frames, slots = 512, 1024
    config = VOConfig(n_slots=slots, map_capacity=2 * slots)
    camera = synthetic.deep_camera(device=device)
    pts, apps, masks = path_b_inputs(frames, slots, device)
    t0 = time.perf_counter()
    inputs = kernel_inputs(camera, config, pts, apps, masks)
    kernel_fns = {
        "match_pairs": matcher_kernel.match_pairs_cuda,
        "join_candidates": frame_kernel.join_candidates_cuda,
        "gather_rows": gather_kernel.gather_rows_cuda,
        "track_frames": frame_kernel.track_frames_cuda,
    }
    table = compare_kernels(inputs, device, kernel_fns)
    planar_config = config.with_planar_mount(mount_matrix("cpu").numpy())
    planar_seq = path_d_inputs(frames, slots, device)
    inputs = kernel_inputs(camera, planar_config, *planar_seq)
    compare_frame_kernel("track_frames_planar", inputs["track_frames"], K5_PLAIN_FRAMES, device,
                         table, kernel_fns["track_frames"])
    del inputs
    compare_solves(device, table)
    compare_matchers(device, table)
    torch.cuda.empty_cache()
    serving = {}
    for cfg in (DEFAULT_CONFIG, DEFAULT_CONFIG.with_planar_mount(mount_matrix("cpu").numpy())):
        seqs = serving_inputs(SERVE_B, SERVE_FRAMES, SERVE_SLOTS, cfg, device)
        compare_serving(camera, cfg, seqs, device, table)
        serving[cfg.planar] = (cfg, seqs)
    ba_problem = corridor(device)
    compare_sparse_ba_kernels(ba_problem[1], device, table)
    compare_linearize(device, table)
    torch.cuda.empty_cache()
    print("kernels vs plain versions: all agree")
    phase("kernel phase", t0)

    # ---- 4-12. the paths ----
    work = os.path.join(ROOT, "build", "chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    launches = {}
    try:
        t0 = time.perf_counter()
        launches["A"] = run_path_a(work, device)
        phase("path A", t0)
        t0 = time.perf_counter()
        launches["B"], _, _ = run_path_b(camera, config, pts, apps, masks, device)
        phase("path B", t0)
        t0 = time.perf_counter()
        launches["C"] = run_path_c(device)
        phase("path C", t0)
        t0 = time.perf_counter()
        launches["D"] = run_path_d(camera, planar_config, *planar_seq, device)
        phase("path D", t0)
        t0 = time.perf_counter()
        launches["resume"] = run_resume(camera, config, pts, apps, masks, device, work)
        phase("resume", t0)
        t0 = time.perf_counter()
        launches["step"] = run_step_form(camera, config, pts, apps, masks, device)
        phase("step form", t0)
        del pts, apps, masks, planar_seq
        t0 = time.perf_counter()
        launches["E"] = run_path_e(camera, serving, device)
        phase("path E", t0)
        t0 = time.perf_counter()
        launches["F"] = run_path_f(work, device, ba_problem)
        phase("path F", t0)
        t0 = time.perf_counter()
        launches["G"] = run_path_g(device)
        phase("path G", t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rows = []
    for name, (source, replaces, home) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[home][name], "launches_path": home,
               "launches_by_path": {p: launches[p][name] for p in launches}}
        row.update(table[name])
        require(row["launches"] > 0, f"{name} never launched on path {home}")
        rows.append(row)
    print(f"[total: {time.perf_counter() - t_start:.1f} s]")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
