"""The traced window: ``torch.profiler`` over whole frames, read back from
its Chrome trace into plain lists that the metric readers share.

Each frame the harness drives is wrapped in a ``portbench.frame`` span of
its own (the harness's span, around the call into the program; the
synchronize that ends the frame lies outside it).  From the trace:

* ``kernels``: device kernels (name, start us, duration us, correlation);
* ``copies``: device memcpy and memset activity (name, start, duration);
* ``runtime``: host CUDA runtime and driver calls (name, start, duration,
  correlation);
* ``ops``: host operators (name, start, duration, thread, input dims);
* ``frames``: the harness's frame spans (start, duration).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

FRAME_SPAN = "portbench.frame"


@dataclass
class Trace:
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    runtime: list = field(default_factory=list)
    ops: list = field(default_factory=list)
    frames: list = field(default_factory=list)

    @property
    def window_us(self) -> tuple[float, float]:
        """From the first frame span's start to the last one's end."""
        return self.frames[0][0], max(s + d for s, d in self.frames)

    def device_intervals(self) -> list[tuple[float, float]]:
        """The merged intervals in which a kernel or a copy ran, clipped
        to the window."""
        lo, hi = self.window_us
        spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d, *_ in self.kernels + self.copies)
        merged: list[list[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]


def parse(events: list[dict]) -> Trace:
    """The lists above from a Chrome trace's ``traceEvents``."""
    t = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args", {})
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "kernel":
            t.kernels.append((name, s, d, args.get("correlation")))
        elif cat in ("gpu_memcpy", "gpu_memset"):
            t.copies.append((name, s, d))
        elif cat in ("cuda_runtime", "cuda_driver"):
            t.runtime.append((name, s, d, args.get("correlation")))
        elif cat == "cpu_op":
            t.ops.append((name, s, d, e.get("tid"), args.get("Input Dims")))
        elif cat == "user_annotation" and name == FRAME_SPAN:
            t.frames.append((s, d))
    t.frames.sort()
    return t


def profiler():
    """A profiler of host and device activity that records shapes."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True)


def read(prof) -> Trace:
    """Export the stopped profiler's trace to a temporary file, parse it,
    and remove the file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return parse(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def top_device_ops(t: Trace, n: int = 10) -> list[list]:
    """The device operations (kernels, copies) that took most time, in
    seconds over the window."""
    total: dict[str, float] = {}
    for name, s, d, *_ in t.kernels + t.copies:
        total[name] = total.get(name, 0.0) + d
    return [[name[:96], secs / 1e6] for name, secs in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(t: Trace, n: int = 10) -> list[list]:
    """The device's idle time in the window, by what the host was doing:
    each gap between device intervals goes to the innermost host operator
    or runtime call on the main thread at the gap's middle, or to "host:
    outside any operator"; the n largest sums, in seconds."""
    lo, hi = t.window_us
    busy = t.device_intervals()
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    main = _main_thread(t)
    host = [(name, s, d) for name, s, d, tid, _ in t.ops if tid == main]
    host += [(name, s, d) for name, s, d, _ in t.runtime]
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    total: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid)
        label, best = "host: outside any operator", None
        for name, hs, hd in reversed(host[max(0, i - 64):i]):
            if hs <= mid <= hs + hd and (best is None or hd < best):
                label, best = name, hd
        total[label] = total.get(label, 0.0) + (e - s)
    return [[name[:96], secs / 1e6] for name, secs in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _main_thread(t: Trace):
    """The thread that ran the most operators: the harness's."""
    count: dict = {}
    for *_, tid, _ in t.ops:
        count[tid] = count.get(tid, 0) + 1
    return max(count, key=count.get) if count else None
