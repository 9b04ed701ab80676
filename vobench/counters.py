"""What the program counts itself in the traced calls: each tracked frame's
GN rounds (``FrameOutput.gn_rounds``, written by the frame loop's kernels K4
and K8) and the host waits of a call (``utils/profiling.host_waits``).

The harness keeps neither (``program.collect`` reads no rounds, and the
trace file is deleted), so after the window each traced call runs once more
through the entry, with the wait counter reset before it; the kernels are
deterministic, so the re-run gives the traced call's rounds. That costs one
call per traced call, after the window and outside ``setup_s``. The readers
of one run share the counts. A program that counts neither gives None, and
its calls are not run again.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Counts:
    rounds: "list | None"   # per traced call: the GN rounds (sequences, tracked frames), int64
    waits: "list | None"    # per traced call: the host waits it made


_last: "tuple | None" = None   # (the window counted, its Counts)


def _program_counters() -> tuple:
    """(whether FrameOutput has gn_rounds, the host-wait module or None)."""
    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.utils import profiling

    has_rounds = "gn_rounds" in pipeline.FrameOutput._fields
    return has_rounds, (profiling if hasattr(profiling, "host_waits") else None)


def _count(ctx) -> "Counts | None":
    calls = ctx.window.traced_calls
    has_rounds, profiling = _program_counters()
    if not calls or not (has_rounds or profiling):
        return None
    rounds, waits = [], []
    for k in calls:
        if profiling:
            profiling.reset_host_waits()
        outs = ctx.entry(k)[2]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if profiling:
            waits.append(sum(profiling.host_waits.values()))
        if has_rounds:
            r = outs.gn_rounds.to("cpu", torch.int64)
            rounds.append(r.reshape(-1, r.shape[-1]))
    return Counts(rounds=rounds if has_rounds else None, waits=waits if profiling else None)


def read(ctx) -> "Counts | None":
    """The counts of ``ctx``'s traced calls, counted once a run."""
    global _last
    if _last is None or _last[0] is not ctx.window:
        _last = (ctx.window, _count(ctx))
    return _last[1]
