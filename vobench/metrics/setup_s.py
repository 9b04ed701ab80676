"""setup_s: the process's start to the window's: the imports, the kernel
library's load (or build, on a checkout's first run; its seconds are
printed apart as ``build_s``), the pool made on the device and the warm-up
calls (a few calls of the cell's one shape)."""


def read(ctx):
    return ctx.setup_s
