"""host_waits_per_call: the times a traced call made the host wait for the
card (a device-to-host read, or an operator that syncs), as the program
counts them in ``utils/profiling.host_wait`` (``vobench/counters.py``): the
mean over the traced calls."""

from vobench import counters


def read(ctx):
    c = counters.read(ctx)
    if c is None or not c.waits:
        return None
    return sum(c.waits) / len(c.waits)
