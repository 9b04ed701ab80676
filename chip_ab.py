"""A/B of two checkouts of the PyTorch/CUDA port on one card, in alternating
processes.

    python3 chip_ab.py serving OTHER_ROOT [--pairs 5] [--reps 5]
    python3 chip_ab.py launch OTHER_ROOT [--pairs 3] [--reps 200]

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
(R = 12 into (12, N), R = 6 into (N, 6), N = 592,896 slots, T = 512), of K6
at N = 1024 and of K11 at N = 8192, beside ``torch.gather`` and
``index_select`` on the same inputs: ``ms``, CUDA events around one call,
and ``host_ms``, the host clock around one call with no sync, each the median
of ``--reps``. Both checkouts need K3's record form and K10's strided table.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _timings(fn, reps: int) -> dict:
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
    return {"ms": statistics.median(ms), "host_ms": 1e3 * statistics.median(host)}


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
    from visual_odometry_tpu_torch.ops.kernels import gather_kernel, picp_kernel

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
    args, _ = chip_smoke.solve_problem(1024, False, device)
    out["k6_n1024"] = _timings(lambda: picp_kernel.solve_fused(*args, backend="cuda"), reps)
    cam, pts = chip_smoke.linearize_problem(8192, device, seed=1)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    out["k11_n8192"] = _timings(lambda: picp_kernel.linearize(*head, *pts, 1e4), reps)
    return out


def worker(mode: str, root: str, reps: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p or ".") != ROOT]
    from visual_odometry_tpu_torch.ops.kernels import _lib

    _lib.build()
    result = _serving(reps) if mode == "serving" else _launch(reps)
    print(json.dumps({"root": root, mode: result}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("serving", "launch"))
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=None)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    reps = a.reps or (5 if a.mode == "serving" else 200)
    if a.worker:
        return worker(a.mode, os.path.abspath(a.other), reps)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    pairs = a.pairs or (5 if a.mode == "serving" else 3)
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
