"""Per-stage wall-clock timing and device traces (port of
visual_odometry_tpu.utils.profiling).

The reference times its data-association stage per frame into
``time_known.txt`` (vo_daKnown.cpp:127-129, 163-164); :meth:`StageTimer.dump`
writes that file.

The pipeline's entry points wrap their own steps in :func:`stage`, so a
``torch.profiler`` trace shows them as ``vo/<name>`` ranges, and each call of
theirs that makes the host wait for the card in :func:`host_wait`, counted in
:data:`host_waits` and shown as a ``wait/<stage>.<site>`` range inside its
stage's. :func:`trace` writes a ``torch.profiler`` trace of a block.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import profile, record_function, supported_activities, tensorboard_trace_handler

from .timing import sync


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer()
    >>> with t.stage("matching", sync_on=result_holder):
    ...     ...
    >>> t.summary()                      # {'matching': {...}}
    """

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None) -> Iterator[None]:
        """Time the block; the clock stops after the device has finished:
        ``sync_on`` is a tensor tree to wait for, None waits for the current
        CUDA device."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(sync_on)
            self.samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"count": len(xs), "total_s": sum(xs), "mean_ms": 1e3 * sum(xs) / len(xs),
                   "min_ms": 1e3 * min(xs), "max_ms": 1e3 * max(xs)}
            for name, xs in self.samples.items()
        }

    def dump(self, file_path: str, name: Optional[str] = None) -> None:
        """One duration (ms) per line — the ``time_known.txt`` contract."""
        names = [name] if name else sorted(self.samples)
        with open(file_path, "w") as f:
            for n in names:
                for x in self.samples[n]:
                    f.write(f"{x * 1e3:g}\n")


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """One named step of a pipeline entry point: a ``torch.profiler`` range
    ``vo/<name>``."""
    with record_function("vo/" + name):
        yield


# The host waits of the main path by site (``<stage>.<site>``), counted by
# :func:`host_wait` whether or not a profiler records; the benchmark resets
# and reads them.
host_waits: Dict[str, int] = {}


def reset_host_waits() -> None:
    host_waits.clear()


@contextlib.contextmanager
def host_wait(site: str, waits: int = 1) -> Iterator[None]:
    """A call that makes the host wait for the card ``waits`` times (a
    device-to-host read, an operator that reads a size or a bound back, a
    copy from pageable host memory, each of which drains the stream):
    counted in :data:`host_waits` under ``site`` and, while a
    ``torch.profiler`` records, a ``wait/<site>`` range on the trace's clock.
    Its prefix is not ``vo/``: a device operation launched inside it keeps
    the label of its ``vo/`` stage. With no profiler it costs one flag test
    and one count."""
    host_waits[site] = host_waits.get(site, 0) + waits
    if not torch.autograd._profiler_enabled():
        yield
        return
    with record_function("wait/" + site):
        yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (host, and the card where there
    is one), written into ``log_dir`` as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard and Perfetto
    read). The JAX package's ``trace`` silently does nothing when tracing
    fails; this one raises, so that a trace the caller asked for is never
    quietly missing."""
    with profile(activities=supported_activities(),
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
