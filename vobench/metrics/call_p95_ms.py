"""call_p95_ms: the 95th percentile of every call's latency in the window, a
call timed on the host from its start to the device sync that ends it (in a
traced run, the calls after the profiled stretch). Also the reader of
``call_p95_ms.single``, the same tail as a per-layer metric in a cell whose
card is idle over half the window, where it follows the host's speed."""


def read(ctx):
    return ctx.window.p95_ms()
