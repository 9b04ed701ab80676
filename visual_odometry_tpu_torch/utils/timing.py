"""Measurement-grade synchronization and device timing
(port of visual_odometry_tpu.utils.timing).

PyTorch returns from a CUDA call before the device has finished, so a host
clock measures the enqueue unless the timed region ends in a synchronize.
:func:`sync` is that end; :func:`cuda_timed` times one call with CUDA events.
"""

from __future__ import annotations

import time

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)


def sync(tree=None):
    """Wait for every CUDA device that holds a tensor of ``tree`` (a tensor,
    or nested tuples, lists and dicts of them); with no argument, for the
    current device if there is a card. Returns ``tree``."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return tree
    for dev in {t.device for t in _leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def cuda_timed(fn, device):
    """``(fn(), milliseconds)``: CUDA events around one call on a card, the
    host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize(device)
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    return out, start.elapsed_time(end)
