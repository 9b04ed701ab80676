"""CPU tests of the readers of the program's own counters
(``metrics/gn_rounds_per_frame.py``, ``gn_round_us.py`` and
``host_waits_per_call.py`` over ``counters.py``) on a hand-made context: the
GN-round division for one sequence a call and for a batch, the host waits a
call, the counts taken once a run and anew for the next, and a program that
counts nothing.

Run from the repository root: ``python -m pytest vobench/tests -q``."""

from __future__ import annotations

import types

import pytest
import torch

from visual_odometry_tpu_torch.utils import profiling

from vobench import counters, harness, tracing

METRICS = harness.REPO / "vobench" / "metrics"


def read(name: str, ctx):
    return harness.load_module(METRICS / f"{name}.py").read(ctx)


class Entry:
    """An entry whose call ``k`` returns the rounds ``rounds[k]`` and makes
    ``waits[k]`` host waits; it counts its calls."""

    def __init__(self, rounds, waits):
        self.rounds, self.waits, self.calls = rounds, waits, []

    def __call__(self, k):
        self.calls.append(k)
        for _ in range(self.waits[k]):
            with profiling.host_wait("map_fold.keep"):
                pass
        return None, None, types.SimpleNamespace(gn_rounds=torch.tensor(self.rounds[k]))


def context(entry, traced, kernel_us):
    ops = [tracing.DeviceOp("void track_frames_kernel<false, 256>(...)", "kernel", 10.0 * i, us,
                            "vo/frame_loop") for i, us in enumerate(kernel_us)]
    ops.append(tracing.DeviceOp("match_pairs_kernel", "kernel", 99.0, 50.0, "vo/batched_match"))
    trace = tracing.Trace(window_us=1000.0, calls=len(traced), ops=ops, busy_us=100.0, idle={},
                          call_kernels=[2] * len(traced))
    window = harness.Window(traced_calls=list(traced), trace=trace)
    return harness.Context(cell=None, entry=entry, window=window, setup_s=0.0, reference={},
                           chip=None)


def test_one_sequence_a_call():
    entry = Entry({0: [3, 4, 5], 1: [2, 2, 2], 2: [9, 9, 9]}, {0: 7, 1: 9, 2: 1})
    ctx = context(entry, [1, 0], [20.0, 16.0])
    assert read("gn_rounds_per_frame", ctx) == pytest.approx(18 / 6)
    assert read("gn_round_us", ctx) == pytest.approx(36.0 / 18)   # K4: every round in turn
    assert read("host_waits_per_call", ctx) == pytest.approx(8.0)
    assert entry.calls == [1, 0]   # each traced call once, shared by the three readers


def test_a_batch_a_call():
    """K8 runs its sequences side by side: a call's rounds are its slowest
    sequence's; the mean a frame is over every sequence's frames."""
    entry = Entry({0: [[3, 4], [10, 1]], 1: [[1, 1], [2, 2]]}, {0: 5, 1: 5})
    ctx = context(entry, [0, 1], [15.0, 15.0])
    assert read("gn_rounds_per_frame", ctx) == pytest.approx(24 / 8)
    assert read("gn_round_us", ctx) == pytest.approx(30.0 / (11 + 4))
    assert read("host_waits_per_call", ctx) == pytest.approx(5.0)


def test_counted_anew_for_each_run():
    first = context(Entry({0: [4, 4]}, {0: 3}), [0], [8.0])
    assert read("host_waits_per_call", first) == 3.0
    second_entry = Entry({0: [1, 1]}, {0: 6})
    second = context(second_entry, [0], [8.0])
    assert read("host_waits_per_call", second) == 6.0
    assert read("gn_rounds_per_frame", second) == 1.0 and second_entry.calls == [0]
    assert read("gn_round_us", context(Entry({0: [2]}, {0: 0}), [0], [0.0])) is None


def test_a_program_without_the_counters(monkeypatch):
    """The parent program of this benchmark: no ``FrameOutput.gn_rounds`` and
    no host-wait counter. Every reader gives nothing and no call runs again."""
    monkeypatch.setattr(counters, "_program_counters", lambda: (False, None))
    entry = Entry({0: [3]}, {0: 2})
    ctx = context(entry, [0], [8.0])
    for name in ("gn_rounds_per_frame", "gn_round_us", "host_waits_per_call"):
        assert read(name, ctx) is None
    assert entry.calls == []
