"""The port's own counters, on the CPU: the GN rounds each tracked frame ran
(``FrameOutput.gn_rounds``, from the frame loop's kernels on the card and
from the plain versions here) and the host waits of the main path
(``utils/profiling.host_wait``): their counts, and their ``wait/`` ranges in
a ``torch.profiler`` trace, which leave the benchmark's reading of that trace
(``vobench/tracing``) as it is without them. The card's side is
tests/test_torch_cuda.py (kernel counts against these plain ones, and every
synchronizing call of the entry points inside a ``host_wait`` block)."""

import json

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.models import pipeline
from visual_odometry_tpu_torch.ops import picp
from visual_odometry_tpu_torch.ops.kernels import frame_kernel
from visual_odometry_tpu_torch.parallel import multiseq
from visual_odometry_tpu_torch.utils import profiling, synthetic
from visual_odometry_tpu_torch.utils.config import VOConfig
from vobench import tracing

F, S = 8, 64
MOUNT = np.array([[0.0, 0.0, 1.0, 0.2], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def sequence():
    return tuple(torch.from_numpy(x) for x in
                 synthetic.generate_tracking_sequence(np.random.default_rng(0), F, S))


def _config(**kw):
    return VOConfig(n_slots=S, map_capacity=2 * S, gn_iterations=30, **kw)


def _witness(monkeypatch, module, name, at):
    """Wrap ``module.name``, a GN loop whose argument ``at`` is its
    ``rounds_out`` list, so that every loop's count also lands in the list
    returned; the caller's own list, if any, still gets it."""
    loop = getattr(module, name)
    seen = []

    def counted(*args, **kw):
        args = list(args)
        mine = []
        if len(args) > at:
            theirs, args[at] = args[at], mine
        else:
            theirs, kw["rounds_out"] = kw.get("rounds_out"), mine
        out = loop(*args, **kw)
        seen.extend(mine)
        if theirs is not None:
            theirs.extend(mine)
        return out

    monkeypatch.setattr(module, name, counted)
    return seen


def _run(form, sequence):
    cam = synthetic.deep_camera()
    if form in ("se3", "planar", "step", "step_planar"):
        cfg = _config(scan_backend="step" if form.startswith("step") else "auto")
        if form.endswith("planar"):
            cfg = cfg.with_planar_mount(MOUNT)
        return pipeline.run_sequence(cam, cfg, *sequence)[2].gn_rounds
    batch = tuple(torch.stack([x, x.flip(1)]) for x in sequence)   # two sequences
    run = multiseq.run_sequences_batched if form == "batched" else multiseq._run_serving
    return run(cam, _config(), *batch)[2].gn_rounds


@pytest.mark.parametrize("form", ["se3", "planar", "step", "step_planar", "batched", "serving"])
def test_gn_rounds_are_the_plain_loops_counts(sequence, form, monkeypatch):
    """``FrameOutput.gn_rounds`` of run_sequence (SE(3), planar, and the
    frame_step form of both) and of run_sequences_batched (the loop form and
    the batch-aware program): int32, one count a tracked frame, each the
    count the plain GN loop appended to its ``rounds_out``."""
    fused = _witness(monkeypatch, frame_kernel, "_gn_loop_plain", 11)
    step = _witness(monkeypatch, picp, "run_rounds", 7)
    got = _run(form, sequence)
    assert got.dtype == torch.int32
    assert got.shape == ((F - 2,) if form in ("se3", "planar", "step", "step_planar")
                         else (2, F - 2))
    want = step if form.startswith("step") else fused
    assert not (fused and step)
    assert got.reshape(-1).tolist() == want
    assert 1 <= min(want) and max(want) <= 30


# The host waits a call of each entry makes, by site. The CPU runs the plain
# versions, which call se3.pose_from_rt more often than the card's kernels;
# tests/test_torch_cuda.py counts the card's.
FOLD = {"map_fold.nonzero": 1, "map_fold.unique": 1, "map_fold.bincount": 2,
        "map_fold.keep": 4, "map_fold.valid": 1}
WAITS = {
    "run_sequence": {"match.radius": 2, "frame_loop.params": 1, "frame_loop.k_inverse": 1,
                     "se3.bottom_row": 4, **FOLD, "overflow_check.fetch": 1},
    # The CPU's loop form: two run_sequence programs, one overflow check.
    "run_sequences_batched": {"match.radius": 4, "frame_loop.params": 2,
                              "frame_loop.k_inverse": 2, "se3.bottom_row": 8,
                              **{k: 2 * v for k, v in FOLD.items()}, "overflow_check.fetch": 1},
    # The batch-aware program the card runs, and its overflow check.
    "serving": {"match.radius": 2, "frame_loop.params": 1, "frame_loop.k_inverse": 1,
                "se3.bottom_row": 3, **FOLD, "overflow_check.fetch": 1},
}


@pytest.mark.parametrize("entry", sorted(WAITS))
def test_host_waits_by_site_a_call(sequence, entry):
    cam, cfg = synthetic.deep_camera(), _config()
    batch = tuple(torch.stack([x, x]) for x in sequence)
    calls = {
        "run_sequence": lambda: pipeline.run_sequence(cam, cfg, *sequence),
        "run_sequences_batched": lambda: multiseq.run_sequences_batched(cam, cfg, *batch),
        "serving": lambda: pipeline.check_join_overflow(
            multiseq._run_serving(cam, cfg, *batch)[2]),
    }
    for _ in range(2):   # the counter is reset between calls, never carried over
        profiling.reset_host_waits()
        calls[entry]()
        assert profiling.host_waits == WAITS[entry]


def test_host_wait_enters_a_range_only_under_a_profiler(monkeypatch):
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Range)
    profiling.reset_host_waits()
    with profiling.host_wait("map_fold.unique"):
        pass
    assert entered == [] and profiling.host_waits == {"map_fold.unique": 1}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.host_wait("map_fold.keep", 4):
            pass
    assert entered == ["wait/map_fold.keep"]
    assert profiling.host_waits == {"map_fold.unique": 1, "map_fold.keep": 4}


def _fake_launches(events: list) -> list:
    """The CPU trace with each operator of the window read as a kernel
    launch: a runtime call at the operator's start and a device kernel
    carrying its correlation id, so that ``tracing.read`` labels them."""
    window = next(e for e in events if e.get("name") == tracing.WINDOW)
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    out = list(events)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e.get("tid") == window["tid"] and w0 <= e["ts"] <= w1]
    for i, e in enumerate(ops, 1):
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                    "pid": e["pid"], "tid": e["tid"], "ts": e["ts"], "dur": 0.0,
                    "args": {"correlation": i}})
        out.append({"ph": "X", "cat": "kernel", "name": "k_" + e["name"], "pid": -1, "tid": 7,
                    "ts": e["ts"] + 0.5 * e.get("dur", 0.0), "dur": 0.01,
                    "args": {"correlation": i}})
    return out


def test_wait_ranges_nest_in_stages_and_leave_the_labels(sequence, tmp_path):
    """A traced run_sequence: every ``wait/`` range lies inside a ``vo/``
    range of its thread, and ``vobench.tracing.read`` gives the same labels,
    idle gaps and breakdown with the ``wait/`` ranges as without them."""
    cam, cfg = synthetic.deep_camera(), _config()
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            with torch.profiler.record_function(tracing.CALL):
                pipeline.run_sequence(cam, cfg, *sequence)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    waits = [e for e in spans if e["name"].startswith("wait/")]
    stages = [e for e in spans if e["name"].startswith("vo/")]
    assert {e["name"] for e in waits} == {"wait/" + k for k in WAITS["run_sequence"]}
    for w in waits:
        assert any(s["tid"] == w["tid"] and s["ts"] <= w["ts"]
                   and w["ts"] + w["dur"] <= s["ts"] + s["dur"] for s in stages), w["name"]

    traces = {}
    for name, keep in (("with", events), ("without", [e for e in events if e not in waits])):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({"traceEvents": _fake_launches(keep)}))
        traces[name] = tracing.read(str(p))
    got, want = traces["with"], traces["without"]
    assert got.ops and [op.label for op in got.ops] == [op.label for op in want.ops]
    assert got.idle == want.idle and tracing.breakdown(got) == tracing.breakdown(want)
    labels = {op.label for op in got.ops}
    assert "vo/map_fold" in labels and not any(x.startswith("wait/") for x in labels)
