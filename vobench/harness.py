"""One run of one cell: set-up, the measured window, the traced stretch, the
output check and the result line (``run.py`` is its command line).

A run loads the program's kernel library (building it on a checkout's
first run), makes the cell's pool of sequences from the seed on the device
and warms up with a few calls of the cell's one shape (that and the imports
are the set-up), then calls the entry back to back for the window's
seconds, each call ended by a device sync, cycling the pool in an order
drawn from the seed. From every pool item it keeps the outputs of one call,
drawn from the seed among its calls in the first two cycles; after the
window those outputs are held to the reference run on the same sequences:
the module the configuration names under ``reference``, its ``track`` and,
where it defines one, its ``gaps`` (else ``compare.gaps``). With
``control``, the reference computed in that lower precision takes the place
of the kept outputs and is judged by the same rule.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, peaks, program, tracing

VOBENCH = Path(__file__).resolve().parent
REPO = VOBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "visual_odometry_tpu")
WARMUP_CALLS = 3   # set-up calls, of distinct pool items: every call of a cell has one shape
MEASUREMENTS = ("points", "appearances", "masks")   # what every pool holds
DEFAULT_GENERATOR = "vobench/generator.py"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@functools.cache
def load_module(path: Path):
    """A module from its file, by path (metric names hold dots); each file is
    executed once a process."""
    spec = importlib.util.spec_from_file_location(f"vobench_dyn.{path.parent.name}.{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: "dict | None"
    end_to_end: list   # (spec, path of the reader)
    per_layer: list
    entry_path: Path
    reference_path: Path
    generator_path: Path


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def reader(here: Path, name: str) -> "Path | None":
    """``metrics/<name>.py``; for a name with a dot and no reader of its own
    (``call_p95_ms.single``), the reader of the name before its last dot."""
    while True:
        path = here / "metrics" / f"{name}.py"
        if path.exists():
            return path
        if "." not in name:
            return None
        name = name.rsplit(".", 1)[0]


def cell(name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, every file it needs found by name."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / "vobench"
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = matches[0]
    config = load_json(here / "configs" / f"{w['config']}.json")
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    limits_path = here / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else None

    def readers(metrics):
        out = []
        for m in _for_cell(metrics, name):
            path = reader(here, m["name"])
            if path is None:
                raise FileNotFoundError(f"metric {m['name']!r} has no reader "
                                        f"{here / 'metrics' / (m['name'] + '.py')}")
            out.append((m, path))
        return out

    entry = here / "entries" / f"{traffic['entry']}.py"
    if not entry.exists():
        raise FileNotFoundError(f"traffic {w['traffic']!r} names the entry {traffic['entry']!r}, "
                                f"which has no driver {entry}")
    named = {}
    for key, default in (("reference", None), ("generator", DEFAULT_GENERATOR)):
        rel = config[key] if default is None else config.get(key, default)
        named[key] = root / rel
        if not named[key].is_file():
            raise FileNotFoundError(f"configuration {w['config']!r} names the {key} {rel!r}, "
                                    f"which is no file {named[key]}")
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=readers(bench["end_to_end"]), per_layer=readers(bench["per_layer"]),
                entry_path=entry, reference_path=named["reference"],
                generator_path=named["generator"])


def generator(c: Cell):
    """The traffic generator module the cell's configuration names."""
    return load_module(c.generator_path)


def make_pool(c: Cell, seed: int, device) -> dict:
    """The generator's pool: the measurements ``MEASUREMENTS`` and whatever
    else the configuration's deployment needs."""
    t = c.traffic
    return generator(c).make_pool(int(t["pool_calls"]) * int(t["sequences_per_call"]),
                                  int(c.config["frames"]), int(c.config["slots"]),
                                  int(c.config["appearance_dim"]), c.config["camera"],
                                  c.config["scene"], seed, device)


def make_entry(c: Cell, pool: dict, device):
    return load_module(c.entry_path).Entry(pool, c.config, c.traffic, device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reference(c: Cell):
    """The reference module the cell's configuration names."""
    return load_module(c.reference_path)


def run_reference(c: Cell, pool: dict, dtype=torch.float64) -> dict:
    """The reference's ``track`` over the whole pool; the pool's keys beside
    the measurements go to it as keyword arguments."""
    extra = {k: v for k, v in pool.items() if k not in MEASUREMENTS}
    with torch.no_grad():
        return reference(c).track(*(pool[k] for k in MEASUREMENTS), c.config["vo_config"],
                                  c.config["camera"], dtype, **extra)


def check(c: Cell, entry, outputs: dict, ref: dict) -> dict:
    """The worst of each compared number over the kept calls ``outputs``
    ({pool call: the program's output, ``entry.collect``-ed}) against the
    reference: its module's ``gaps`` where it has one, else ``compare.gaps``;
    every number it computes."""
    gaps = getattr(reference(c), "gaps", compare.gaps)
    return compare.worst([gaps(out, compare.select(ref, entry.sequences(k)))
                          for k, out in sorted(outputs.items())])


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    frames: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    failed: int = 0
    kept: dict = dataclasses.field(default_factory=dict)
    traced_calls: list = dataclasses.field(default_factory=list)
    untraced_from: int = 0   # the first call after the profiled stretch
    trace: "tracing.Trace | None" = None

    def p95_ms(self) -> "float | None":
        """The 95th percentile of the call latencies after the profiled stretch, in ms."""
        lat = self.latencies[self.untraced_from:]
        return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None


class _Loop:
    """The closed loop over the pool: calls in an order drawn from the seed,
    each timed from its start to the sync that ends it."""

    def __init__(self, entry, device, seed: int, win: Window):
        self.entry, self.device, self.win = entry, device, win
        self.gen = torch.Generator().manual_seed(int(seed) ^ 0x5EED)
        self.keep_cycle = torch.randint(0, 2, (entry.calls,), generator=self.gen).tolist()
        self.order = torch.randperm(entry.calls, generator=self.gen).tolist()
        self.pos = self.cycle = 0
        self.error = None

    def call(self) -> int:
        k = self.order[self.pos]
        t0 = time.perf_counter()
        try:
            out = self.entry(k)
            sync(self.device)
        except Exception as e:  # a failed call is counted and reported, the window goes on
            out = None
            self.win.failed += 1
            self.error = self.error or repr(e)
        self.win.latencies.append(time.perf_counter() - t0)
        if out is not None:
            self.win.frames += self.entry.frames_per_call
            if self.cycle == self.keep_cycle[k] and self.cycle < 2:
                self.win.kept[k] = self.entry.collect(out)
        self.pos += 1
        if self.pos == self.entry.calls:
            self.pos, self.cycle = 0, self.cycle + 1
            self.order = torch.randperm(self.entry.calls, generator=self.gen).tolist()
        return k


def _profile(loop: _Loop, warm: int, active: int, out_dir: str) -> tuple:
    """Profile ``active`` calls after ``warm`` calls of the profiler's warm-up
    step; returns (the trace, the pool calls profiled)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile, schedule

    path = os.path.join(out_dir, "trace.json")
    calls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(warm):
            loop.call()
        prof.step()
        with record_function(tracing.WINDOW):
            for _ in range(active):
                with record_function(tracing.CALL):
                    calls.append(loop.call())
        prof.step()
    trace = tracing.read(path)
    os.remove(path)
    return trace, calls


def measure(entry, device, seed: int, seconds: float, trace_calls: int = 0) -> Window:
    """The window: at least ``seconds`` and two cycles of the pool; with
    ``trace_calls``, its first calls are profiled and that many of them traced."""
    win = Window()
    loop = _Loop(entry, device, seed, win)
    gc.collect()
    gc.freeze()   # the set-up's objects are never scanned again in the window
    t0 = time.perf_counter()
    if trace_calls:
        active = int(trace_calls)
        with tempfile.TemporaryDirectory(prefix="vobench-trace-") as tmp:
            for _ in range(3):
                # The profiler has been seen to drop device events of a short
                # window: a stretch whose calls show unequal kernel counts is
                # traced again, at most three times.
                win.trace, win.traced_calls = _profile(loop, max(2, active // 4), active, tmp)
                if win.trace is not None and win.trace.complete(active):
                    break
        win.untraced_from = len(win.latencies)
    while time.perf_counter() - t0 < seconds or loop.cycle < 2:
        loop.call()
    win.seconds = time.perf_counter() - t0
    if loop.error:
        print(f"vobench: {win.failed} calls failed, first: {loop.error}", file=sys.stderr)
    return win


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_settings() -> str:
    """The card's name, power limit and SM clock as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(ctx)``)."""

    cell: Cell
    entry: object
    window: Window
    setup_s: float
    reference: dict
    chip: "peaks.Chip | None"


def _judge(c: Cell, found: dict, complete: bool) -> tuple:
    """(correct, {number: {value, limit}}): every number the reference
    computes and every number the cell's limits file holds finite and within
    its limit (one computed without a limit, or limited and not computed,
    fails), on a run whose every call succeeded and every pool item was kept."""
    limits = c.limits or {}
    checks, correct = {}, complete and c.limits is not None
    for name in dict.fromkeys([*found, *limits]):
        value = found.get(name, math.nan)
        limit = limits.get(name)
        correct = correct and limit is not None and value == value and value <= limit
        checks[name] = {"value": value if value == value else None, "limit": limit}
    return bool(correct), checks


def run(c: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        control: "torch.dtype | None" = None) -> tuple:
    """One run; returns (the result line's object, exit code). ``started`` is
    the process's start on the host clock. With ``control`` (a dtype), the
    reference in that dtype is put in the program's place for the check."""
    device = torch.device(device)
    build_s = program.load_kernels() if device.type == "cuda" else 0.0
    pool = make_pool(c, seed, device)
    entry = make_entry(c, pool, device)
    for k in range(min(entry.calls, WARMUP_CALLS)):
        entry(k)
        sync(device)
    setup_s = time.perf_counter() - started
    win = measure(entry, device, seed, seconds, int(c.traffic["trace_calls"]) if trace else 0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"vobench: {len(win.latencies)} calls in {win.seconds:.3f} s of window; set-up "
          f"{setup_s:.3f} s, of it the kernel library's build {build_s:.3f} s", file=sys.stderr)

    t_ref = time.perf_counter()
    ref = run_reference(c, pool)
    kept = win.kept
    if control is not None:
        lower = run_reference(c, pool, control)
        kept = {k: compare.select(lower, entry.sequences(k)) for k in kept}
    found = check(c, entry, kept, ref) if kept else {}
    ref_s = time.perf_counter() - t_ref
    missing = sorted(set(range(entry.calls)) - set(kept))
    correct, checks = _judge(c, found, win.failed == 0 and not missing)
    held = occupancy(c, pool, kept)

    chip = None
    kind = "cpu"
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        kind = torch.cuda.get_device_name(device)
        chip = peaks.chip(kind, props.multi_processor_count)
    ctx = Context(cell=c, entry=entry, window=win, setup_s=setup_s, reference=ref, chip=chip)
    metrics = {}
    for spec, path in (c.per_layer if trace else c.end_to_end):
        value = load_module(path).read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": c.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(win.latencies), "failed": win.failed,
              "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_us / 1e6
        dev["window_s"] = win.trace.window_us / 1e6
        result["breakdown"] = tracing.breakdown(win.trace)
    result["card"] = card_settings() if device.type == "cuda" else "cpu"
    result["build_s"] = build_s
    result["reference_s"] = ref_s
    result["occupancy"] = held
    if control is not None:
        result["control"] = str(control).replace("torch.", "")
    result["checks"] = checks
    found = forbidden_modules()
    if found:   # after the window, the reference and every reader have run
        print(f"vobench: the process holds {found} after the window", file=sys.stderr)
        return None, 4
    print(f"vobench: reference {ref_s:.3f} s; kept calls {len(kept)} of {entry.calls}"
          + (f"; never kept: {missing}" if missing else "")
          + ("" if c.limits is not None else "; no limits file"), file=sys.stderr)
    print("vobench: occupancy " + " ".join(f"{k} {v}" for k, v in held.items()),
          file=sys.stderr)
    for name, chk in checks.items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}", file=sys.stderr)
    return result, 0


def occupancy(c: Cell, pool: dict, kept: dict) -> dict:
    """What the traffic puts through the program's state: the generator's
    reading of the pool (``occupancy``) and, where the kept calls fold a
    map (``map_count``), its fill of the capacity."""
    held = generator(c).occupancy(pool)
    counts = [out["map_count"].double().reshape(-1).cpu() for out in kept.values()
              if "map_count" in out]
    if counts:
        cap = int(c.config["vo_config"]["map_capacity"])
        count = torch.cat(counts)
        held.update(map_fill_mean=float(count.mean()) / cap, map_fill_max=float(count.max()) / cap,
                    map_full_share=float((count >= cap).double().mean()))
    return held
