#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (visual_odometry_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. environment: torch, CUDA, the card, nvcc, nvidia-smi name and power limit;
  2. build: compile csrc/*.cu with nvcc into build/vo_torch_kernels/;
  3. each kernel (K1 pair matcher, K2 join candidates, K3 lane gather, K4 fused
     frame loop) against its plain PyTorch version on the card, on the main
     path's own inputs (S = 1024 slots x 512 frames), with CUDA-event times;
  4. path A: the reference-format application — generate_dataset (40 frames,
     400 landmarks), apps.run_vo_complete on cuda, apps.run_evaluation — held
     to the accuracy bounds of tests/test_dataset_gen.py;
  5. path B: pipeline.run_sequence at 1024 slots x 512 frames, held against
     the same run through the plain versions, and its frames/s.
The launch counters are zeroed right before each path and read right after;
every kernel must have launched in both. The last two lines are the kernel
table ({"kernels": [...]}) and {"ok": true, "device": {...}}.
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
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "match_pairs": ("visual_odometry_tpu_torch/csrc/match_pairs.cu",
                    "visual_odometry_tpu/ops/pallas/matcher_kernel.py:302"),
    "join_candidates": ("visual_odometry_tpu_torch/csrc/join_candidates.cu",
                        "visual_odometry_tpu/ops/pallas/frame_kernel.py:134"),
    "gather_rows": ("visual_odometry_tpu_torch/csrc/gather_rows.cu",
                    "visual_odometry_tpu/ops/pallas/gather_kernel.py:45"),
    "track_frames": ("visual_odometry_tpu_torch/csrc/track_frames.cu",
                     "visual_odometry_tpu/ops/pallas/frame_kernel.py:952"),
}
K4_POSE_TOL = 2e-3   # the repo's fused-vs-scan trajectory tolerance (tests/test_pipeline.py:331)
K1_DIST_RTOL = 1e-5


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
    import torch

    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Median time of fn() in ms over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed_call(fn, device)[1] for _ in range(reps))


def path_b_inputs(frames: int, slots: int, device):
    """The full-width tracking sequence of benchmarks/bench_scale.py:76-79."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    pts, apps, masks = synthetic.generate_tracking_sequence(np.random.default_rng(0), frames, slots)
    return tuple(torch.from_numpy(x).to(device) for x in (pts, apps, masks))


def kernel_inputs(camera, config, pts, apps, masks):
    """Each kernel's inputs as the main path builds them (plain versions)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    plain = config.replace(matcher_backend="torch", scan_backend="torch")
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    f0 = pipeline.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps[1], masks[1], ids[1])
    corr01 = pipeline._match(plain, f0, f1)
    state, _ = pipeline.initialize(camera, plain, f0, f1, corr=corr01)
    rest = pipeline.FrameData(pts[2:], apps[2:], masks[2:], ids[2:])
    prev = pipeline.FrameData(pts[1:-1], apps[1:-1], masks[1:-1], ids[1:-1])
    corr = pipeline._batched_match(plain, rest, prev)
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
    k4_args = (
        frame_kernel.pack_params(
            camera.camera_matrix, camera.params(), state.x_curr, config.kernel_threshold,
            config.damping, config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
            config.keep_outliers, config.warm_start, config.min_num_inliers,
        ),
        state.tri_points.contiguous(), state.tri_valid.contiguous(), cand,
        pix[:, 0:2].transpose(1, 2).contiguous(), pix[:, 2:4].transpose(1, 2).contiguous(),
        corr.valid.contiguous(), config.gn_iterations, config.gn_min_iterations,
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
        "track_frames": k4_args,
    }


def compare_kernels(inputs, device, kernel_fns, reps: int = 10):
    """Run each kernel and its plain version on the same inputs; returns
    {name: (max_abs_err, kernel_ms, plain_ms)} and raises on disagreement."""
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
    out["match_pairs"] = (err, time_ms(lambda: kernel_fns["match_pairs"](*a), device, reps),
                          time_ms(lambda: matcher_kernel.match_pairs_plain(*a), device, 3))

    a = inputs["join_candidates"]
    kc = kernel_fns["join_candidates"](*a)
    pc = frame_kernel.join_candidates_plain(*a)
    require(all(torch.equal(x, y) for x, y in zip(kc, pc)), "K2: join candidates differ")
    out["join_candidates"] = (0.0, time_ms(lambda: kernel_fns["join_candidates"](*a), device, reps),
                              time_ms(lambda: frame_kernel.join_candidates_plain(*a), device, 3))

    for key in ("gather_rows", "gather_rows_apps"):
        a = inputs[key]
        require(torch.equal(kernel_fns["gather_rows"](*a), gather_kernel.gather_rows_plain(*a)),
                f"K3 {key}: gathers differ")
    a = inputs["gather_rows_apps"]
    out["gather_rows"] = (0.0, time_ms(lambda: kernel_fns["gather_rows"](*a), device, reps),
                          time_ms(lambda: gather_kernel.gather_rows_plain(*a), device, reps))

    a = inputs["track_frames"]
    kp = kernel_fns["track_frames"](*a)[0]
    # The plain K4 syncs with the host every GN round: one timed run.
    pp, plain_ms = timed_call(lambda: frame_kernel.track_frames_plain(*a)[0], device)
    require(bool(torch.isfinite(kp).all()), "K4: non-finite poses")
    err = float((kp - pp).abs().max())
    require(err <= K4_POSE_TOL, f"K4: poses differ by {err} > {K4_POSE_TOL}")
    out["track_frames"] = (err, time_ms(lambda: kernel_fns["track_frames"](*a), device, 3),
                           plain_ms)
    return out


def run_path_a(work_dir: str, device, require_launches: bool):
    """The reference-format application on a generated dataset."""
    from visual_odometry_tpu_torch import apps
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.utils import dataset_gen

    data, out = os.path.join(work_dir, "data"), os.path.join(work_dir, "out")
    dataset_gen.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    _lib.reset_launches()
    apps.run_vo_complete(data, out, device=device, verbose=True)
    sync(device)
    launches = dict(_lib.launches)
    res = apps.run_evaluation(data, out, verbose=True)
    finite = np.isfinite(res.orientation_errors)
    e_theta = float(np.abs(res.orientation_errors[finite]).mean())
    print(json.dumps({"path_a": {"e_theta_mean": e_theta, "rmse_position": res.rmse_position,
                                 "rmse_map": res.rmse_map, "n_map_matched": res.n_map_matched,
                                 "launches": launches}}))
    require(e_theta < 1e-4, f"path A: mean |e_theta| {e_theta} >= 1e-4")
    require(res.rmse_position < 0.2, f"path A: rmse_position {res.rmse_position} >= 0.2")
    require(res.n_map_matched > 100, f"path A: only {res.n_map_matched} map landmarks matched")
    if require_launches:
        require(all(n > 0 for n in launches.values()), f"path A: a kernel never ran: {launches}")
    return launches


def run_path_b(camera, config, pts, apps, masks, device, require_launches: bool, reps: int = 3):
    """Full-width tracking through the kernels, held against the plain versions."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import _lib

    _lib.reset_launches()
    traj, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, masks)
    sync(device)
    launches = dict(_lib.launches)
    if require_launches:
        require(all(n > 0 for n in launches.values()), f"path B: a kernel never ran: {launches}")
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
    from visual_odometry_tpu_torch.utils.config import VOConfig

    device = torch.device("cuda")
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
    inputs = kernel_inputs(camera, config, pts, apps, masks)
    kernel_fns = {
        "match_pairs": matcher_kernel.match_pairs_cuda,
        "join_candidates": frame_kernel.join_candidates_cuda,
        "gather_rows": gather_kernel.gather_rows_cuda,
        "track_frames": frame_kernel.track_frames_cuda,
    }
    t0 = time.perf_counter()
    table = compare_kernels(inputs, device, kernel_fns)
    print(f"kernels vs plain versions: all agree ({time.perf_counter() - t0:.1f} s)")
    del inputs

    # ---- 4. path A: reference-format application ----
    work = os.path.join(ROOT, "build", "chip_smoke_path_a")
    shutil.rmtree(work, ignore_errors=True)
    try:
        launches_a = run_path_a(work, device, require_launches=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 5. path B: full width ----
    launches_b, _, _ = run_path_b(camera, config, pts, apps, masks, device, require_launches=True)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms = table[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches_b[name], "launches_path_a": launches_a[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
