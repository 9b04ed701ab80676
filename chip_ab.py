"""A/B of two checkouts of the PyTorch/CUDA port on one card, in alternating
processes.

    python3 chip_ab.py serving OTHER_ROOT [--pairs 5] [--reps 5]
    python3 chip_ab.py launch OTHER_ROOT [--pairs 3] [--reps 200]
    python3 chip_ab.py kernels OTHER_ROOT [--pairs 3] [--reps 5]
    python3 chip_ab.py phases
    python3 chip_ab.py p1_phases
    python3 chip_ab.py selfcheck OTHER_ROOT [--pairs 1]
    python3 chip_ab.py gn_rounds OTHER_ROOT [--pairs 1]
    python3 chip_ab.py bootstrap OTHER_ROOT [--pairs 2] [--reps 5]

Runs one worker for OTHER_ROOT and one for this checkout in the order other,
this, this, other, other, this, ... (``--pairs`` of each), every worker a
process of its own that imports ``visual_odometry_tpu_torch`` from its root
and builds that root's kernels there, so a host whose speed drifts during the
call weighs on both sides alike. Each worker prints one JSON line; the last
line is {"ab": {metric: {"other": [...], "this": [...]}}} in run order.

``serving``: path E of chip_smoke.py, ``multiseq.run_sequences_batched`` over
64 sequences x 128 frames x 128 slots (``generate_tracking_sequence`` on
fields 100-163, the default config), one warm-up, then frames/s from the
median of ``--reps`` calls, each ended by a sync (host clock). Any checkout of
the port since its serving slice runs it.

``launch``: the wrappers of K3 at path B's appearance (510 x 1024 x 10) and
pixel (510 x 1024 x 2) gathers and of K10 as a sparse-BA step calls it
(R = 12 into (12, N), R = 6 into (N, 6), N = 592,896 slots, T = 512), of K9
at the same N and T (R = 36 and 6; over one plan of the ids in a checkout
that makes plans), of K6 at N = 1024 (``k6_n1024``), of the planar K6 at
N = 8192 (``k6_se2_n8192``) and of K11 at N = 8192, beside
``torch.gather`` and
``index_select`` on the same inputs: ``ms``, CUDA events around one call,
and ``host_ms``, the host clock around one call with no sync, each the median
of ``--reps``; the K6 and K11 rows also the profiler's device time of a
call (all its kernels) and of the kernel alone, over up to 50 calls. Both checkouts need K3's record form and K10's strided table.

``kernels``: the frame-loop kernels and K1 through each checkout's wrappers,
on inputs this checkout builds once (chip_smoke.py's, in
build/chip_ab/kernels_inputs.pt): K1 at path B's 510 pairs and at its
bootstrap pair (B = 1), K4 on path B (1,024 slots x 510 tracked frames; also
its first 128 frames, whose GN rounds the plain version counts once, for
``us_per_gn_round``), K5 on path D, K8 on path E (64 sequences x 128 slots
x 126 frames), K2 on path B (``k2_path_b``) and K7 at path C's shape
(``k7_fast``, ``k7_exact``: chip_smoke.match_problem, 1,024 queries x 2^20
rows), K7 exact at D = 17 and 32 (``k7_exact_d17``, ``k7_exact_d32``:
1,024 queries x 2^18 rows); ``ms`` is the median of ``--reps`` CUDA-event
times (4x as many for K1, K2 and K7). K7 at path A's relocalization shape
(``k7_exact_path_a``, ``k7_fast_path_a``: the default config's 128 slots
against its 1,024-row map) and exact at the shapes of ``K7_SMALL`` also give
``host_ms`` and the profiler's ``device_ms`` of a call (every kernel and the
memset). Then, through each checkout's own pipeline, path B's
``run_sequence`` (its bootstrap included; trajectory and map), path E's
``run_sequences_batched`` (trajectories, maps, per-frame outputs) and path
A's relocalization query, ``pipeline.relocalize_frame`` at the default
config's shape in both precisions (``reloc_path_a_*``: ``ms``, the host
clock around a call ended by a sync, median of 8 x ``--reps``). Each
output's SHA-256 shows whether the two checkouts agree bit for bit. Any checkout of the port since its serving slice runs it.

``phases`` (no OTHER_ROOT): K4's round broken into phases on path B. It
builds csrc/track_frames.cu six times into build/vo_torch_kernels_diag/: as
the package builds it (a cluster of 4 CTAs at 1,024 lanes), on one CTA
(-DVO_TRACK_CLUSTER_MAX=1), and on one CTA with the former warp sum of 30
shuffle-down trees (-DVO_GN_TREE_SUMS), each with and without
-DVO_GN_PHASES (clock64() stamps, gn_loop.cuh); it prints each build's
registers and spill stores, its ms (CUDA events, median of ``--reps``),
whether its outputs equal the package's K4 bit for bit, and for the stamped
builds the cycles a round spends in each phase (averaged over a cluster's
CTAs). Never built or loaded by the package.

``p1_phases`` (no OTHER_ROOT): P1 (csrc/eight_point.cu) broken into phases
at path B's bootstrap pair (1 x 1,024) and path E's 64 pairs (x 128). It
builds the source twice into build/vo_torch_kernels_diag/, as the package
builds it and with -DVO_P1_PHASES (clock64() stamps of thread 0), and prints
each build's registers and spill stores, its ms (CUDA events, median of
``--reps``), whether its poses equal the package's P1 bit for bit, and for
the stamped build the cycles a pair spends in each phase (averaged over the
pairs) with their shares. Where the source has the bootstrap instance
(``vo_eight_point_seed``), that instance is measured too, its ``seed``
phase included. Never built or loaded by the package.

``selfcheck``: ``utils/selfcheck.check_frame_pipeline``'s comparison (the
fused path, K1-K4, against the per-frame step form with the plain solve, 64
slots x 10 frames under ``deep_camera``) at seeds 1-30, with the gap
reported and not held to the check's 2e-3: ``frame_traj_diff`` a seed,
``over_2e-3`` (seeds over it), ``median`` and ``max``.

``gn_rounds``: K4's plain version over path B's first 256 tracked frames
(chip_smoke.kernel_inputs, 1,024 slots; each checkout bootstraps with its
own pipeline), the GN rounds of each frame (``rounds``), then again with the
bootstrap's output moved by one ulp (``torch.nextafter``): the start pose's
x translation up (``x_init_tx_up``) and down (``x_init_tx_down``), its first
rotation entry up (``x_init_r00_up``), and every triangulated point's
coordinates up (``tri_up``); each row gives the rounds a frame, their mean
and the frames whose count differs from ``rounds``. Also K4's ms over the
full 510 frames (CUDA events, median of ``--reps``), the start pose's
entries as hex floats and the triangulation's SHA-256, so two checkouts'
bootstraps can be compared.

``bootstrap``: each checkout's bootstrap stage through its own entry points:
path B (``run_sequence``, 1,024 slots x 512 frames), path D (its planar
form), the step form (path B's first 34 frames, ``scan_backend="step"``),
path H (``run_sequence_chunked``, 4 chunks) and path E (the serving batch,
64 x 128 x 128, and its planar batch of 8). For each, after ``--reps`` + 1
warm-up calls, one profiled call after a profiler warm-up step: its wall ms,
the device's busy share and P1's device ms and launches; and the SHA-256 of
the trajectory and map (path E: also its per-frame outputs), which must be
the same in both checkouts. Also the SHA-256 of ``initialize_batched``'s
whole output at path E's bootstrap pairs, and of path A's ``run_vo_complete``
trajectory and map on chip_smoke.py's generated 40-frame dataset.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _device_ms(fn, reps: int, kernel: str) -> dict:
    """Under the profiler, ``reps`` calls: ``device_ms``, the device time of
    every kernel a call launches, summed, over ``reps``; ``kernel_device_ms``,
    the mean device time of the kernels whose name holds ``kernel``, and
    their count (the profiler may drop some events of a window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    own = [e.time_range.elapsed_us() for e in seen if kernel in e.name]
    return {"device_ms": sum(e.time_range.elapsed_us() for e in seen) / 1e3 / reps,
            "kernel_device_ms": sum(own) / 1e3 / max(len(own), 1), "kernels_seen": len(own)}


def _timings(fn, reps: int, kernel: str = "") -> dict:
    """``ms`` (CUDA events) and ``host_ms`` (host clock, no sync) of one call,
    medians of ``reps``; with ``kernel``, also the profiler's times
    (_device_ms) over up to 50 calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = {"ms": statistics.median(ms), "host_ms": 1e3 * statistics.median(host)}
    if kernel:
        out.update(_device_ms(fn, min(reps, 50), kernel))
    return out


def _serving(reps: int) -> dict:
    import torch

    from visual_odometry_tpu_torch.parallel import multiseq
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG

    device = torch.device("cuda")
    camera = synthetic.deep_camera(device=device)
    seqs = [[torch.from_numpy(x).to(device) for x in synthetic.generate_tracking_sequence(
        np.random.default_rng(seed), 128, 128)] for seed in range(100, 164)]
    batch = tuple(torch.stack([q[k] for q in seqs]).contiguous() for k in range(3))
    count, frames = batch[0].shape[:2]
    multiseq.run_sequences_batched(camera, DEFAULT_CONFIG, *batch)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        multiseq.run_sequences_batched(camera, DEFAULT_CONFIG, *batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return {"path_e_frames_per_s": count * frames / statistics.median(seconds)}


def _launch(reps: int) -> dict:
    import torch

    import chip_smoke   # the worker's own root is first on sys.path
    from visual_odometry_tpu_torch.ops.kernels import gather_kernel, picp_kernel, segsum_kernel

    device = torch.device("cuda")
    rng = np.random.default_rng(0)

    def tensor(x):
        return torch.from_numpy(x).to(device)

    out = {}
    for label, d in (("k3_apps", 10), ("k3_pixels", 2)):
        src = tensor(rng.normal(size=(510, 1024, d)).astype(np.float32))
        idx = tensor(rng.integers(0, 1024, (510, 1024)).astype(np.int32))
        idx64 = idx.long()[..., None].expand(510, 1024, d)
        out[label] = _timings(lambda: gather_kernel.gather_rows(src, idx), reps)
        out[label + "_torch_gather"] = _timings(lambda: torch.gather(src, 1, idx64), reps)
    idx = tensor(rng.integers(0, 512, 592_896).astype(np.int32))
    idx64 = idx.long()
    for r, transpose_out in ((12, False), (6, True)):
        rows = tensor(rng.normal(size=(512, r)).astype(np.float32))
        out[f"k10_r{r}"] = _timings(
            lambda: gather_kernel.take_table(rows.T, idx, transpose_out=transpose_out), reps)
        out[f"k10_r{r}_index_select"] = _timings(
            (lambda: torch.index_select(rows, 0, idx64)) if transpose_out
            else (lambda: torch.index_select(rows.T, 1, idx64)), reps)
    # K9 as a sparse-BA step calls it, over one plan of the ids where the
    # checkout makes plans (made outside the timing, as a run makes it once).
    seg = tensor(rng.integers(0, 513, 592_896).astype(np.int32))
    plan = segsum_kernel.plan_segments(seg, 512) if hasattr(segsum_kernel, "plan_segments") else None
    for r in (36, 6):
        vals = tensor(rng.normal(size=(592_896, r)).astype(np.float32))
        kw = {} if plan is None else {"plan": plan}
        out[f"k9_r{r}"] = _timings(lambda: segsum_kernel.segment_sum_small(vals, seg, 512, **kw),
                                   reps)
    args, _ = chip_smoke.solve_problem(1024, False, device)
    out["k6_n1024"] = _timings(lambda: picp_kernel.solve_fused(*args, backend="cuda"), reps,
                               "picp_solve")
    args, _ = chip_smoke.solve_problem(8192, True, device)
    out["k6_se2_n8192"] = _timings(lambda: picp_kernel.solve_se2_fused(*args, backend="cuda"),
                                   reps, "picp_solve")
    cam, pts = chip_smoke.linearize_problem(8192, device, seed=1)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    out["k11_n8192"] = _timings(lambda: picp_kernel.linearize(*head, *pts, 1e4), reps,
                                "picp_linearize")
    return out


KERNEL_INPUTS = os.path.join(ROOT, "build", "chip_ab", "kernels_inputs.pt")
K4_HEAD_FRAMES = 128
K7_WIDE_DIMS = (17, 32)   # K7 exact past D = 16: the tensor-core scan here, the FP32 scan before
# K7 exact between path A's and path C's shapes, (queries, rows) at D = 10:
# 2^19 to 2^26 pairs, across matcher_kernel.EXACT_SCAN_PAIRS.
K7_SMALL = ((128, 4096), (128, 16384), (1024, 4096), (128, 65536), (256, 65536), (512, 65536),
            (1024, 65536))


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _k8_args(camera, config, seqs):
    """K8's arguments over the sequences, as chip_smoke.compare_serving builds them."""
    import torch

    import chip_smoke
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    rows = [chip_smoke.kernel_inputs(camera, config, *(x[i] for x in seqs))["track_frames"]
            for i in range(seqs[0].shape[0])]
    stack = lambda k: torch.stack([a[k] for a in rows]).contiguous()   # noqa: E731
    cand = frame_kernel.JoinCandidates(
        *(torch.stack([a[3][q] for a in rows]).contiguous() for q in range(3)))
    pose0 = torch.stack([a[0][28:40] for a in rows]).contiguous()
    return (rows[0][0], pose0, stack(1), stack(2), cand, stack(4), stack(5), stack(6),
            config.gn_iterations, config.gn_min_iterations, config.planar)


def _cpu(args):
    return tuple(tuple(x.cpu() for x in a) if isinstance(a, tuple)
                 else (a.cpu() if hasattr(a, "cpu") else a) for a in args)


def _prepare_kernel_inputs() -> None:
    """Build the ``kernels`` inputs once with this checkout's chip_smoke.py."""
    import torch

    import chip_smoke
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig

    device = torch.device("cuda")
    camera = synthetic.deep_camera(device=device)
    config = VOConfig(n_slots=1024, map_capacity=2048)
    b = chip_smoke.kernel_inputs(camera, config, *chip_smoke.path_b_inputs(512, 1024, device))
    mount = chip_smoke.mount_matrix("cpu").numpy()
    d = chip_smoke.kernel_inputs(camera, config.with_planar_mount(mount),
                                 *chip_smoke.path_d_inputs(512, 1024, device))
    rounds = []
    frame_kernel.track_frames_plain(*chip_smoke.head_frames(b["track_frames"], K4_HEAD_FRAMES),
                                    rounds_out=rounds)
    seqs = chip_smoke.serving_inputs(64, 128, 128, DEFAULT_CONFIG, device)
    os.makedirs(os.path.dirname(KERNEL_INPUTS), exist_ok=True)
    k7, _ = chip_smoke.match_problem(1024, 1 << 20, device)
    k7_wide = {f"k7_exact_d{d}": _cpu(chip_smoke.match_problem(1024, 1 << 18, device, dim=d)[0])
               for d in K7_WIDE_DIMS}
    k7_path_a, _ = chip_smoke.match_problem(DEFAULT_CONFIG.n_slots, DEFAULT_CONFIG.map_capacity,
                                            device)
    k7_small = {f"k7_exact_q{nq}_k{nk}": _cpu(chip_smoke.match_problem(nq, nk, device)[0])
                for nq, nk in K7_SMALL}
    torch.save({"k1": _cpu(b["match_pairs"]), "k1_b1": _cpu(b["match_pairs_b1"]),
                "k2": _cpu(b["join_candidates"]), "k7": _cpu(k7),
                "k7_path_a": _cpu(k7_path_a), **k7_wide, **k7_small,
                "k4": _cpu(b["track_frames"]), "k5": _cpu(d["track_frames"]),
                "k8": _cpu(_k8_args(camera, DEFAULT_CONFIG, seqs)), "k4_head_rounds": rounds},
               KERNEL_INPUTS)


def _load_kernel_inputs(device):
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    raw = torch.load(KERNEL_INPUTS, weights_only=False)

    def card(args):
        out = []
        for a in args:
            if isinstance(a, tuple):
                out.append(frame_kernel.JoinCandidates(*(x.to(device) for x in a)))
            else:
                out.append(a.to(device) if hasattr(a, "to") else a)
        return tuple(out)

    return {k: (card(v) if k != "k4_head_rounds" else v) for k, v in raw.items()}


def _kernels(reps: int) -> dict:
    import torch

    import chip_smoke   # the worker's own root is first on sys.path
    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel, matcher_kernel
    from visual_odometry_tpu_torch.parallel import multiseq
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig

    inp = _load_kernel_inputs(torch.device("cuda"))
    out = {}
    for key, args in (("k1_b510", inp["k1"]), ("k1_b1", inp["k1_b1"])):
        out[key] = {"ms": _ms(lambda: matcher_kernel.match_pairs_cuda(*args), 4 * reps),
                    "sha": _sha(matcher_kernel.match_pairs_cuda(*args))}
    head = chip_smoke.head_frames(inp["k4"], K4_HEAD_FRAMES)
    rounds = sum(inp["k4_head_rounds"])
    head_ms = _ms(lambda: frame_kernel.track_frames_cuda(*head), reps)
    out["k4_path_b"] = {"ms": _ms(lambda: frame_kernel.track_frames_cuda(*inp["k4"]), reps),
                        "ms_head": head_ms, "us_per_gn_round": 1e3 * head_ms / rounds,
                        "gn_rounds_per_frame_head": rounds / K4_HEAD_FRAMES,
                        "sha": _sha(frame_kernel.track_frames_cuda(*inp["k4"]))}
    out["k5_path_d"] = {"ms": _ms(lambda: frame_kernel.track_frames_cuda(*inp["k5"]), reps),
                        "sha": _sha(frame_kernel.track_frames_cuda(*inp["k5"]))}
    out["k8_path_e"] = {
        "ms": _ms(lambda: frame_kernel.track_frames_batched_cuda(*inp["k8"]), reps),
        "sha": _sha(frame_kernel.track_frames_batched_cuda(*inp["k8"]))}
    out["k2_path_b"] = {"ms": _ms(lambda: frame_kernel.join_candidates_cuda(*inp["k2"]), 4 * reps),
                        "sha": _sha(frame_kernel.join_candidates_cuda(*inp["k2"]))}
    for key, fast in (("k7_fast", True), ("k7_exact", False)):
        out[key] = {"ms": _ms(lambda: matcher_kernel.best_match_cuda(*inp["k7"], fast), 4 * reps),
                    "sha": _sha(matcher_kernel.best_match_cuda(*inp["k7"], fast))}
    for key in (f"k7_exact_d{d}" for d in K7_WIDE_DIMS):
        out[key] = {"ms": _ms(lambda: matcher_kernel.best_match_cuda(*inp[key]), 4 * reps),
                    "sha": _sha(matcher_kernel.best_match_cuda(*inp[key]))}
    # Small problems, where launches and latency weigh: host and device time too.
    small = {"k7_exact_path_a": (inp["k7_path_a"], False),
             "k7_fast_path_a": (inp["k7_path_a"], True),
             **{f"k7_exact_q{nq}_k{nk}": (inp[f"k7_exact_q{nq}_k{nk}"], False)
                for nq, nk in K7_SMALL}}
    for key, (args, fast) in small.items():
        out[key] = dict(_timings(lambda: matcher_kernel.best_match_cuda(*args, fast), 4 * reps,
                                 "best_match"),
                        sha=_sha(matcher_kernel.best_match_cuda(*args, fast)))
    # End to end through each checkout's own pipeline: path B's run_sequence
    # (bootstrap included) and path E's serving batch.
    device = torch.device("cuda")
    camera = synthetic.deep_camera(device=device)
    traj, map_state, _ = pipeline.run_sequence(camera, VOConfig(n_slots=1024, map_capacity=2048),
                                               *chip_smoke.path_b_inputs(512, 1024, device))
    out["path_b_run_sequence"] = {"sha": _sha((traj, *map_state))}
    seqs = chip_smoke.serving_inputs(64, 128, 128, DEFAULT_CONFIG, device)
    traj, maps, outs = multiseq.run_sequences_batched(camera, DEFAULT_CONFIG, *seqs)
    out["path_e_serving"] = {"sha": _sha((traj, *maps, *outs))}
    # Path A's relocalization query end to end: the default config's 128
    # slots against its 1,024-row map (chip_smoke.path_c_inputs at that size).
    camera, map_state, frame, x0, _ = chip_smoke.path_c_inputs(
        device, DEFAULT_CONFIG.map_capacity, DEFAULT_CONFIG.n_slots)
    for precision in ("highest", "fast"):
        config = DEFAULT_CONFIG.replace(matcher_precision=precision)

        def reloc():
            return pipeline.relocalize_frame(camera, config, map_state, frame, x0)

        pose, stats, n_matches = reloc()
        out["reloc_path_a_" + precision] = {
            "ms": _wall_ms(reloc, 8 * reps),
            "sha": _sha((pose, stats.num_inliers, torch.as_tensor(n_matches)))}
    return out


def _wall_ms(fn, reps: int) -> float:
    """The host clock around one call ended by a sync, median of ``reps`` after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


DIAG_DIR = os.path.join(ROOT, "build", "vo_torch_kernels_diag")
ONE_CTA = "-DVO_TRACK_CLUSTER_MAX=1"
DIAG_VARIANTS = {"cluster": [], "cluster_stamped": ["-DVO_GN_PHASES"],
                 "one_cta": [ONE_CTA], "one_cta_stamped": [ONE_CTA, "-DVO_GN_PHASES"],
                 "tree_one_cta": [ONE_CTA, "-DVO_GN_TREE_SUMS"],
                 "tree_one_cta_stamped": [ONE_CTA, "-DVO_GN_TREE_SUMS", "-DVO_GN_PHASES"]}
PHASES = ("lane_terms", "warp_sum_and_stores", "wait_for_other_warps", "cross_warp_fold",
          "solve", "second_barrier")


def _build_diag(source: str = "track_frames.cu", variants=None) -> dict:
    """``source`` in each diagnostic variant, nvcc started together."""
    from visual_odometry_tpu_torch.ops.kernels import _lib

    os.makedirs(DIAG_DIR, exist_ok=True)
    procs = {}
    for name, defs in (variants or DIAG_VARIANTS).items():
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, *defs, "-shared", "-o",
               os.path.join(DIAG_DIR, name + ".so"), str(_lib.CSRC / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    logs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        logs[name] = [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line or "Compiling entry" in line]
    return logs


def _phases(reps: int) -> dict:
    import ctypes

    import torch

    import chip_smoke
    from visual_odometry_tpu_torch.ops.kernels import _lib, frame_kernel
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import VOConfig

    device = torch.device("cuda")
    logs = _build_diag()
    camera = synthetic.deep_camera(device=device)
    args = chip_smoke.kernel_inputs(camera, VOConfig(n_slots=1024, map_capacity=2048),
                                    *chip_smoke.path_b_inputs(512, 1024, device))["track_frames"]
    params, tri, tri_ok, cand, prev_al, cur_al, valid, iters, min_iters, _ = args
    f, depth, s = cand.idx.shape
    ref = frame_kernel.track_frames_cuda(*args)
    report = {"package_ms": _ms(lambda: frame_kernel.track_frames_cuda(*args), reps)}
    for name in DIAG_VARIANTS:
        lib = ctypes.CDLL(os.path.join(DIAG_DIR, name + ".so"))
        fn = lib.vo_track_frames
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        outs = tuple(torch.empty_like(x) for x in ref)

        def run():
            code = fn(*(t.data_ptr() for t in (params, tri, tri_ok, cand.idx, cand.ok, prev_al,
                                               cur_al, valid, *outs)),
                      f, s, depth, int(iters), int(min_iters),
                      torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{name}: launch failed with CUDA error {code}")

        row = {"ptxas": logs[name], "ms": _ms(run, reps)}
        run()
        torch.cuda.synchronize()
        row["equals_package_bitwise"] = all(torch.equal(a, b) for a, b in zip(outs, ref))
        if "stamped" in name:
            take = lib.vo_gn_phases_take
            take.argtypes = [ctypes.c_void_p]
            counts = (ctypes.c_ulonglong * 16)()
            take(counts)                    # zero what the timed runs added
            run()
            torch.cuda.synchronize()
            take(counts)
            rounds, frames = counts[6], counts[7]
            row["rounds"], row["frames"] = rounds, frames
            row["cycles_per_round"] = {p: counts[i] / rounds for i, p in enumerate(PHASES)}
            row["cycles_per_frame"] = {"join": counts[8] / frames,
                                       "triangulation_and_stores": counts[9] / frames}
        report[name] = row
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    report["clocks_sm_now_and_max"] = smi.stdout.strip()
    return report


P1_VARIANTS = {"p1": [], "p1_stamped": ["-DVO_P1_PHASES"]}
P1_PHASES = ("masked_maxima", "normal_sums", "jacobi", "lu_and_inverse_iterations",
             "svds_and_candidates", "votes", "seed", "stores")


def _p1_phases(reps: int) -> dict:
    import ctypes

    import torch

    import chip_smoke
    from visual_odometry_tpu_torch.ops.kernels import epipolar_kernel
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig

    device = torch.device("cuda")
    logs = _build_diag("eight_point.cu", P1_VARIANTS)
    camera = synthetic.deep_camera(device=device)
    cases = {"path_b": (VOConfig(n_slots=1024, map_capacity=2048),
                        tuple(x[None, :2] for x in chip_smoke.path_b_inputs(2, 1024, device))),
             "path_e": (DEFAULT_CONFIG, chip_smoke.serving_inputs(64, 2, 128, DEFAULT_CONFIG,
                                                                  device))}
    seeded = hasattr(epipolar_kernel, "bootstrap_batched_cuda")
    report = {}
    for label, (cfg, seqs) in cases.items():
        args, (_, f1, _) = chip_smoke.eight_point_args(camera, cfg, *seqs)
        want = {"pose": (epipolar_kernel.estimate_transform_batched_cuda(*args),)}
        rows = {"package_ms": _ms(lambda: epipolar_kernel.estimate_transform_batched_cuda(*args),
                                  reps)}
        if seeded:
            boot = (*args, f1.appearances, cfg.map_capacity)
            want["seed"] = tuple(_flat_tensors(epipolar_kernel.bootstrap_batched_cuda(*boot)))
            rows["package_seed_ms"] = _ms(lambda: epipolar_kernel.bootstrap_batched_cuda(*boot),
                                          reps)
        for name in P1_VARIANTS:
            lib = ctypes.CDLL(os.path.join(DIAG_DIR, name + ".so"))
            for inst, ref in want.items():
                run, outs = _p1_runner(lib, inst, args, f1.appearances, cfg.map_capacity, ref)
                row = {"ptxas": logs[name], "ms": _ms(run, reps)}
                run()
                torch.cuda.synchronize()
                row["equals_package_bitwise"] = chip_smoke.same_bits(*zip(outs, ref))
                if "stamped" in name:
                    take = lib.vo_p1_phases_take
                    take.argtypes = [ctypes.c_void_p]
                    counts = (ctypes.c_ulonglong * 16)()
                    take(counts)                 # zero what the timed runs added
                    run()
                    torch.cuda.synchronize()
                    take(counts)
                    pairs = counts[15]
                    cycles = {p: counts[i] / pairs for i, p in enumerate(P1_PHASES)}
                    total = sum(cycles.values())
                    row.update(pairs=pairs, cycles_per_pair=cycles, cycles_total=total,
                               share={p: c / total for p, c in cycles.items()})
                rows[f"{name}_{inst}"] = row
        report[label] = rows
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    report["card_limit_clocks"] = smi.stdout.strip()
    return report


def _flat_tensors(t) -> list:
    """The tensors of a tuple tree, in order (other leaves left out)."""
    if hasattr(t, "data_ptr"):
        return [t]
    return [y for x in t for y in _flat_tensors(x)] if isinstance(t, (tuple, list)) else []


def _p1_runner(lib, inst: str, args: tuple, apps2, capacity: int, ref: tuple):
    """(run, outputs): one launch of a diagnostic build's P1 instance (``pose``:
    vo_eight_point, ``seed``: vo_eight_point_seed) into fresh outputs shaped
    as the package's ``ref``, the wrapper's argument order (epipolar_kernel)."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import _lib, epipolar_kernel

    symbol = "vo_eight_point" if inst == "pose" else "vo_eight_point_seed"
    fn = getattr(lib, symbol)
    fn.argtypes = _lib._SIGNATURES[symbol]
    outs = tuple(torch.empty_like(t) for t in ref)
    b, s = args[1].shape
    n, d = args[4].shape[1], apps2.shape[-1]
    if inst == "pose":
        ptrs, tail = args + outs, (b, s, n)
    else:
        ptrs = args + (apps2,) + outs
        tail = (b, s, n, capacity, d, 2 * n, 2 * n, n, n, n * d, epipolar_kernel.mount_arg(None))

    def run():
        code = fn(*(t.data_ptr() for t in ptrs), *tail, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{symbol}: launch failed with CUDA error {code}")

    return run, outs


def _selfcheck(reps: int) -> dict:
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.utils import selfcheck, synthetic
    from visual_odometry_tpu_torch.utils.config import VOConfig

    device = torch.device("cuda")
    camera = synthetic.deep_camera(device=device)
    config = VOConfig(n_slots=64, map_capacity=128, gn_iterations=30)
    step = config.replace(scan_backend="step", solver_backend="torch")
    gaps = []
    for seed in range(1, 31):
        pts, apps, masks = (x.to(device) for x in selfcheck.sequence_inputs(seed))
        traj_f, _, _ = pipeline.run_sequence(camera, config, pts, apps, masks)
        traj_x, _, _ = pipeline.run_sequence(camera, step, pts, apps, masks)
        gaps.append(float((traj_x - traj_f).abs().max()))
    return {"frame_traj_diff": gaps, "over_2e-3": sum(g >= 2e-3 for g in gaps),
            "median": statistics.median(gaps), "max": max(gaps)}


def _gn_rounds(reps: int) -> dict:
    import torch

    import chip_smoke   # the worker's own root is first on sys.path
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import VOConfig

    device = torch.device("cuda")
    camera = synthetic.deep_camera(device=device)
    config = VOConfig(n_slots=1024, map_capacity=2048)
    args = chip_smoke.kernel_inputs(camera, config, *chip_smoke.path_b_inputs(512, 1024, device))
    args = args["track_frames"]
    head = chip_smoke.head_frames(args, 256)

    def rounds_of(a):
        rounds = []
        frame_kernel.track_frames_plain(*a, rounds_out=rounds)
        return rounds

    def nudged(i, up):
        x = head[0].clone()
        x[i] = torch.nextafter(x[i], torch.tensor(float("inf") if up else float("-inf"),
                                                  device=device))
        return x

    base = rounds_of(head)
    tri, tri_ok = head[1], head[2]
    inf = torch.full_like(tri, float("inf"))
    tri_up = torch.where(tri_ok[:, None], torch.nextafter(tri, inf), tri)
    # pack_params: entries 28-39 hold the start pose's 3 x 4 rows.
    variants = {"x_init_tx_up": (nudged(31, True),) + head[1:],
                "x_init_tx_down": (nudged(31, False),) + head[1:],
                "x_init_r00_up": (nudged(28, True),) + head[1:],
                "tri_up": (head[0], tri_up) + head[2:]}
    out = {"rounds": base, "mean": sum(base) / len(base),
           "x_init_hex": [float(v).hex() for v in head[0][28:40].cpu()],
           "tri_sha": _sha((tri, tri_ok)), "tri_valid": int(tri_ok.sum()),
           "k4_ms": _ms(lambda: frame_kernel.track_frames_cuda(*args), reps)}
    for name, a in variants.items():
        r = rounds_of(a)
        out[name] = {"rounds": r, "mean": sum(r) / len(r),
                     "frames_differing": sum(x != y for x, y in zip(r, base))}
    return out


def _bootstrap(reps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke   # the worker's own root is first on sys.path
    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.parallel import multiseq, posegraph
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig
    from visual_odometry_tpu_torch.utils.roofline import device_events

    device = torch.device("cuda")
    camera = synthetic.deep_camera(device=device)
    config = VOConfig(n_slots=1024, map_capacity=2048)
    planar = config.with_planar_mount(chip_smoke.mount_matrix("cpu").numpy())
    seq_b = chip_smoke.path_b_inputs(512, 1024, device)
    seq_d = chip_smoke.path_d_inputs(512, 1024, device)
    seq_e = chip_smoke.serving_inputs(64, 128, 128, DEFAULT_CONFIG, device)
    planar_e = DEFAULT_CONFIG.with_planar_mount(chip_smoke.mount_matrix("cpu").numpy())
    seq_e8 = chip_smoke.serving_inputs(8, 128, 128, planar_e, device)
    step = config.replace(scan_backend="step")
    head = tuple(x[:34] for x in seq_b)
    paths = {
        "path_b": lambda: pipeline.run_sequence(camera, config, *seq_b),
        "path_d": lambda: pipeline.run_sequence(camera, planar, *seq_d),
        "step_34_frames": lambda: pipeline.run_sequence(camera, step, *head),
        "path_h": lambda: posegraph.run_sequence_chunked(camera, config, *seq_b, num_chunks=4,
                                                         overlap=10),
        "path_e": lambda: multiseq.run_sequences_batched(camera, DEFAULT_CONFIG, *seq_e),
        "path_e_planar_8": lambda: multiseq.run_sequences_batched(camera, planar_e, *seq_e8)}
    out = {}
    for name, fn in paths.items():
        for _ in range(reps + 1):
            result = fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
        on_card = device_events(prof)
        p1 = [e.time_range.elapsed_us() for e in on_card if "eight_point" in e.name]
        row = dict(wall_ms=1e3 * wall,
                   busy_share=sum(e.time_range.elapsed_us() for e in on_card) / 1e6 / wall,
                   p1_device_ms=sum(p1) / 1e3, p1_launches=len(p1),
                   sha=_sha(_flat_tensors(result)))
        out[name] = row
    args, (f0, f1, corr) = chip_smoke.eight_point_args(camera, DEFAULT_CONFIG, *seq_e)
    out["initialize_batched_path_e"] = {"sha": _sha(_flat_tensors(
        pipeline.initialize_batched(camera, DEFAULT_CONFIG, f0, f1, corr=corr)))}
    # Path A's tracking app on chip_smoke.py's generated dataset.
    from visual_odometry_tpu_torch import apps
    from visual_odometry_tpu_torch.utils import dataset_gen

    work = os.path.join(os.getcwd(), "build", "chip_ab", "path_a")
    shutil.rmtree(work, ignore_errors=True)
    dataset_gen.generate_dataset(os.path.join(work, "data"), num_frames=40, num_landmarks=400,
                                 seed=1)
    traj, map_state, _, _ = apps.run_vo_complete(os.path.join(work, "data"),
                                                 os.path.join(work, "out"), verbose=False,
                                                 device=device)
    out["path_a_vo_complete"] = {"sha": _sha([torch.as_tensor(traj), *map_state])}
    shutil.rmtree(work, ignore_errors=True)
    return out


def worker(mode: str, root: str, reps: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p or ".") != ROOT]
    from visual_odometry_tpu_torch.ops.kernels import _lib

    _lib.build()
    result = {"serving": _serving, "launch": _launch, "kernels": _kernels,
              "selfcheck": _selfcheck, "gn_rounds": _gn_rounds, "bootstrap": _bootstrap}[mode](reps)
    print(json.dumps({"root": root, mode: result}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("serving", "launch", "kernels", "phases", "p1_phases",
                                     "selfcheck", "gn_rounds", "bootstrap"))
    ap.add_argument("other", nargs="?")
    ap.add_argument("--pairs", type=int, default=None)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    reps = a.reps or {"serving": 5, "launch": 200, "kernels": 5, "phases": 3, "p1_phases": 20,
                      "selfcheck": 1, "gn_rounds": 5, "bootstrap": 5}[a.mode]
    if a.worker:
        return worker(a.mode, os.path.abspath(a.other), reps)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if a.mode in ("phases", "p1_phases"):
        fn = _phases if a.mode == "phases" else _p1_phases
        print(json.dumps({a.mode: fn(reps)}))
        return 0
    if a.other is None:
        ap.error(f"{a.mode} needs OTHER_ROOT")
    if a.mode == "kernels":
        _prepare_kernel_inputs()
    pairs = a.pairs or {"serving": 5, "selfcheck": 1, "gn_rounds": 1, "bootstrap": 2}.get(a.mode, 3)
    other = os.path.abspath(a.other)
    order = [("other", "this") if i % 2 == 0 else ("this", "other") for i in range(pairs)]
    ab = {}
    for side in (s for pair in order for s in pair):
        root = other if side == "other" else ROOT
        res = subprocess.run([sys.executable, os.path.abspath(__file__), a.mode, root, "--worker",
                              "--reps", str(reps)], cwd=root, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=900)
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or not lines:
            print(res.stdout)
            print(f"chip_ab: the {side} worker failed with exit code {res.returncode}",
                  file=sys.stderr)
            return 1
        print(json.dumps({"side": side, **json.loads(lines[-1])}), flush=True)
        flat = json.loads(lines[-1])[a.mode]
        for key, val in flat.items():
            for metric, v in (val.items() if isinstance(val, dict) else [("", val)]):
                name = key + ("." + metric if metric else "")
                ab.setdefault(name, {"other": [], "this": []})[side].append(v)
    print(json.dumps({"ab": ab}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
