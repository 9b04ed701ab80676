"""map_fold_ms: the device time per call of the operations launched inside
the program's ``vo/map_fold`` range (``landmark_map.merge_stream``). Not the
range's host duration: ``torch.unique`` syncs inside it, so the range also
holds the wait for the frame loop."""


def read(ctx):
    t = ctx.window.trace
    if t is None or t.calls == 0:
        return None
    us = sum(op.dur_us for op in t.ops if op.label == "vo/map_fold")
    return us / 1e3 / t.calls if us > 0 else None
