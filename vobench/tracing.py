"""The reading of a traced stretch of the window: ``torch.profiler``'s Chrome
trace reduced to the device's operations, each labelled by the host range it
was launched from, the busy time, and the idle gaps by what the host was
doing.

The harness marks the traced calls with a ``vobench/traced`` range and each
call with ``vobench/call``; the program marks its stages with ``vo/<stage>``
ranges (``visual_odometry_tpu_torch/utils/profiling.stage``). A device
operation (a kernel, a copy or a fill) carries the correlation id of the
runtime call that launched it, and that call's host time places it in the
innermost ``vo/`` range, else in ``vobench/call`` (the entry outside its
stages), else in ``harness``.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict

WINDOW = "vobench/traced"
CALL = "vobench/call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start_us: float
    dur_us: float
    label: str   # the host range the operation was launched from


@dataclasses.dataclass
class Trace:
    window_us: float
    calls: int
    ops: list            # DeviceOp of the window, by start
    busy_us: float       # the union of the ops' intervals
    idle: dict           # label -> idle microseconds while the host was in it
    call_kernels: list   # the kernels launched in each traced call

    def complete(self, calls: int) -> bool:
        """Whether the trace shows ``calls`` calls, each with the same
        nonzero number of kernels (the program launches the same kernels on
        every call of a cell)."""
        return (self.calls == calls == len(self.call_kernels)
                and min(self.call_kernels, default=0) > 0
                and len(set(self.call_kernels)) == 1)


class _Ranges:
    """The host ranges of one thread, for the innermost-range lookup."""

    def __init__(self, spans):
        self.spans = sorted(spans)   # (start, end, name)
        self.starts = [s[0] for s in self.spans]

    def label(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        inside_call = False
        while i >= 0:
            start, end, name = self.spans[i]
            if end >= t:
                if name.startswith("vo/"):
                    return name
                if name == CALL:
                    inside_call = True
                    break
            i -= 1
        return CALL if inside_call else "harness"


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def read(path: str) -> "Trace | None":
    """The trace of the ``vobench/traced`` range in a Chrome trace file, or
    None where the file has no such range."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    spans = defaultdict(list)
    window = None
    for e in events:
        if e.get("cat") == "user_annotation":
            start = float(e["ts"])
            end = start + float(e.get("dur", 0.0))
            spans[e.get("tid")].append((start, end, e["name"]))
            if e["name"] == WINDOW and window is None:
                window = (start, end, e.get("tid"))
    if window is None:
        return None
    w0, w1, main_tid = window
    call_spans = sorted(s for s in spans[main_tid] if s[2] == CALL and w0 <= s[0] <= w1)
    calls = len(call_spans)
    call_kernels = [0] * calls
    ranges = {tid: _Ranges(v) for tid, v in spans.items()}
    launches = {}
    for e in events:
        if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        start = float(e["ts"])
        if not w0 <= start <= w1:
            continue
        host = launches.get(e.get("args", {}).get("correlation"))
        label = ranges[host[1]].label(host[0]) if host and host[1] in ranges else "harness"
        if e["cat"] == "kernel" and host and host[1] == main_tid:
            i = bisect.bisect_right([s[0] for s in call_spans], host[0]) - 1
            if i >= 0 and host[0] <= call_spans[i][1]:
                call_kernels[i] += 1
        ops.append(DeviceOp(e["name"], e["cat"], start, float(e.get("dur", 0.0)), label))
    ops.sort(key=lambda op: op.start_us)

    busy, idle = 0.0, defaultdict(float)
    main = ranges[main_tid]
    cursor = w0
    for op in ops:
        end = min(op.start_us + op.dur_us, w1)
        if op.start_us > cursor:
            idle[main.label(cursor)] += op.start_us - cursor
            cursor = op.start_us
        if end > cursor:
            busy += end - cursor
            cursor = end
    if w1 > cursor:
        idle[main.label(cursor)] += w1 - cursor
    return Trace(window_us=w1 - w0, calls=calls, ops=ops, busy_us=busy, idle=dict(idle),
                 call_kernels=call_kernels)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time by name, and the idle time by
    the host range it fell in, each in seconds, the largest first."""
    by_name = defaultdict(float)
    for op in trace.ops:
        by_name[short_name(op.name)] += op.dur_us
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(trace.idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e6] for k, v in device_ops],
            "idle_gaps": [[k, v / 1e6] for k, v in idle]}
