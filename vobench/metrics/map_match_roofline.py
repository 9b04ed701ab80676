"""map_match_roofline: the map-scale matcher's share of its roofline, in %:
the least time of the traced calls' K7 launches over the profiler's device
time of the operations launched inside the program's ``vo/map_match`` range
(matched to the range through the runtime call's correlation id, as
``map_fold_ms`` reads ``vo/map_fold``). The least time is the frozen work
model (``workmodels.matcher_model``) at the call's shape, every slot a query
against every map row, against the card's published peaks (``peaks``)."""

STAGE = "vo/map_match"


def read(ctx):
    t = ctx.window.trace
    if t is None or ctx.chip is None or t.calls == 0 or not hasattr(ctx.entry, "map_match_work"):
        return None
    device_us = sum(op.dur_us for op in t.ops if op.label == STAGE)
    if device_us <= 0:
        return None
    least_s = ctx.entry.map_match_work().least_s(ctx.chip) * t.calls
    return 100.0 * least_s / (device_us / 1e6)
