"""gn_rounds_per_frame: the GN rounds the program's frame loop ran a tracked
frame (K4 for one sequence, K8 for a batch; ``FrameOutput.gn_rounds``), the
mean over every tracked frame of the traced calls' sequences, counted by the
program (``vobench/counters.py``)."""

from vobench import counters


def read(ctx):
    c = counters.read(ctx)
    if c is None or not c.rounds:
        return None
    rounds = [r.double() for r in c.rounds]
    frames = sum(r.numel() for r in rounds)
    return float(sum(r.sum() for r in rounds)) / frames if frames else None
