"""device_idle_pct: the share of the traced stretch in which no kernel, copy
or fill runs on the card (the union of the profiler's device intervals)."""


def read(ctx):
    t = ctx.window.trace
    if t is None or t.window_us <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
