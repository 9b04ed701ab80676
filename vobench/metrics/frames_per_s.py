"""frames_per_s: every frame of the sequences the window's calls completed,
over the window's seconds (all the work over all the time), host clock."""


def read(ctx):
    w = ctx.window
    return w.frames / w.seconds if w.seconds > 0 else None
