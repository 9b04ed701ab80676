"""frame_loop_roofline: the fused frame loop's share of its roofline, in %:
the least time of the traced calls' loops (K4 ``track_frames`` for one
sequence, K8 ``track_frames_batched`` for a batch; both are
``track_frames_kernel`` on the card) over the profiler's device time of
those kernels. The least time is the frozen work model (``workmodels``) at
the calls' shapes and at the GN rounds a frame that the reference needed on
the same sequences, against the card's published peaks (``peaks``)."""

KERNEL = "track_frames_kernel"


def read(ctx):
    t = ctx.window.trace
    if t is None or ctx.chip is None or not ctx.window.traced_calls:
        return None
    device_us = sum(op.dur_us for op in t.ops if KERNEL in op.name)
    if device_us <= 0:
        return None
    rounds = ctx.reference["rounds"]
    least_s = 0.0
    for k in ctx.window.traced_calls:
        seqs = ctx.entry.sequences(k)
        least_s += ctx.entry.frame_loop_work(rounds[seqs.start:seqs.stop]).least_s(ctx.chip)
    return 100.0 * least_s / (device_us / 1e6)
