"""gn_round_us: the frame loop's device time a GN round, in us: the
profiler's device time of ``track_frames_kernel`` (K4, K8) in the traced
calls over their GN rounds as the program counts them (``counters``). A
call's rounds are its slowest sequence's: K8 runs its sequences' CTAs side
by side, so the kernel lasts as long as the sequence with most rounds. This
parts a kernel's change from a change in convergence."""

from vobench import counters

KERNEL = "track_frames_kernel"


def read(ctx):
    t = ctx.window.trace
    c = counters.read(ctx)
    if t is None or c is None or not c.rounds:
        return None
    device_us = sum(op.dur_us for op in t.ops if KERNEL in op.name)
    rounds = sum(int(r.sum(dim=1).max()) for r in c.rounds)
    return device_us / rounds if device_us > 0 and rounds > 0 else None
