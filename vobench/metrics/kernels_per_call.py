"""kernels_per_call: the device kernels the traced calls launched, the
program's and PyTorch's, per call (copies and fills not counted)."""


def read(ctx):
    t = ctx.window.trace
    if t is None or t.calls == 0:
        return None
    kernels = sum(1 for op in t.ops if op.cat == "kernel")
    return kernels / t.calls if kernels else None
