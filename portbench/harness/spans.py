"""The program's spans in a traced run, and what the per-layer readers
charge to them.

While a profiler records, ``cwipc_util_tpu_torch`` opens ``record_function``
spans named ``cwipc.*`` around the exact chain's stages (its
utils/trace.py): ``cwipc.exact`` around the entry, and inside it
``cwipc.downsample``, ``cwipc.grid_build`` and ``cwipc.fixup``.  They share
the trace's clock with the kernels, copies and runtime calls, so each idle
gap of the card is put on the innermost span the host was in.

``parse`` in trace.py keeps only the harness's frame spans.  So the
program's spans are read here from the stopped profiler that recorded the
run (cell.py's ``run_cell`` holds it as ``prof`` beside ``run`` while the
readers run), and moved onto the Chrome trace's clock through the first
frame span, which both hold.  A trace that carries a ``spans`` list is
read as it is.  A span is (name, start us, duration us, thread).

Each function returns None without a trace or where the program opened
no span (a program without them)."""

from __future__ import annotations

import sys

from .trace import FRAME_SPAN

PREFIX = "cwipc."
ENTRY = "cwipc.exact"
OUTSIDE = "outside cwipc.exact"


def parse(events: list[dict]) -> list[tuple]:
    """The program's spans among a Chrome trace's ``traceEvents``."""
    return sorted((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e.get("tid")) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith(PREFIX))


def of(run) -> list[tuple] | None:
    """The run's program spans, read once and kept on its trace."""
    t = run.trace
    if t is None:
        return None
    if getattr(t, "spans", None) is None:
        prof = _profiler(run)
        t.spans = _from_profiler(prof, t) if prof is not None and t.frames else []
    return t.spans or None


def _profiler(run):
    """The profiler that recorded ``run``: the ``prof`` of the calling
    frame that holds ``run``."""
    f = sys._getframe(1)
    while f is not None:
        prof = f.f_locals.get("prof")
        if f.f_locals.get("run") is run and hasattr(getattr(prof, "profiler", None), "kineto_results"):
            return prof
        f = f.f_back
    return None


def _from_profiler(prof, t) -> list[tuple]:
    """The host spans of the profiler's events, on the Chrome trace's
    clock: the first frame span starts at ``t.frames[0][0]`` in both."""
    import torch

    cpu = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CPU]
    frames = [e.start_ns() for e in cpu if e.name() == FRAME_SPAN]
    if not frames:
        return []
    ns0, us0 = min(frames), t.frames[0][0]
    return sorted((e.name(), us0 + (e.start_ns() - ns0) / 1e3, e.duration_ns() / 1e3, e.start_thread_id())
                  for e in cpu if e.name().startswith(PREFIX))


def _main(spans: list[tuple]) -> list[tuple]:
    """The spans of the thread that opened most of them: the harness's."""
    count: dict = {}
    for *_, tid in spans:
        count[tid] = count.get(tid, 0) + 1
    main = max(count, key=count.get)
    return [s for s in spans if s[3] == main]


def idle_gaps(t) -> list[tuple[float, float]]:
    """The window's intervals in which no kernel, copy or memset ran, as
    trace.idle_gaps finds them."""
    lo, hi = t.window_us
    gaps, at = [], lo
    for s, e in t.device_intervals():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def idle_by_span(run) -> dict[str, float] | None:
    """Idle seconds of the window by the innermost program span on the
    main thread that holds each gap's middle, or ``OUTSIDE``.  The values
    add up to the window's idle time."""
    spans = of(run)
    if spans is None:
        return None
    main = _main(spans)
    total: dict[str, float] = {}
    for s, e in idle_gaps(run.trace):
        mid = (s + e) / 2
        label, best = OUTSIDE, None
        for name, ss, sd, _ in main:
            if ss <= mid <= ss + sd and (best is None or sd < best):
                label, best = name, sd
        total[label] = total.get(label, 0.0) + (e - s) / 1e6
    return total


def idle_ms_per_frame(run, name: str) -> float | None:
    """Device idle ms a traced frame charged to the span ``name``."""
    idle = idle_by_span(run)
    if idle is None:
        return None
    return 1e3 * idle.get(name, 0.0) / run.traced_frames


def _inside(run, name: str) -> list[tuple[float, float]] | None:
    spans = of(run)
    if spans is None:
        return None
    return [(s, s + d) for n, s, d, _ in _main(spans) if n == name]


def kernel_ms_per_frame(run, name: str) -> float | None:
    """Device ms a traced frame of the kernels launched inside the span
    ``name``, found through the launches' correlation ids."""
    within = _inside(run, name)
    if within is None:
        return None
    corr = {c for _, s, _, c in run.trace.runtime if c is not None and any(a <= s <= b for a, b in within)}
    return sum(d for _, _, d, c in run.trace.kernels if c in corr) / 1e3 / run.traced_frames


def host_ms_per_frame(run, name: str, calls: frozenset) -> float | None:
    """Host ms a traced frame in the runtime ``calls`` that start inside
    the span ``name``."""
    within = _inside(run, name)
    if within is None:
        return None
    return sum(d for n, s, d, _ in run.trace.runtime
               if n in calls and any(a <= s <= b for a, b in within)) / 1e3 / run.traced_frames
