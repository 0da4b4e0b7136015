"""What the metric readers under ``portbench/metrics/`` share.

A reader gets the run (``cell.Run``): its frames, window, latencies and
set-up time, the chain's returned counts, and for a traced run the trace
(``trace.Trace``), the frames it covers and their work counts (from the
traffic's judge: ``work.frame_counts`` for the exact chain).  It returns
a number, or None where the run has nothing for it to read (no trace, or
a kernel that did not run)."""

from __future__ import annotations

from . import work

SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                        "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuMemcpyDtoH_v2"})


def kernel_seconds(run, *names: str) -> float:
    """Device seconds of the traced kernels whose name holds one of
    ``names``."""
    return sum(d for name, _, d, _ in run.trace.kernels if any(n in name for n in names)) / 1e6


def roofline_pct(run, names: tuple[str, ...], work_fn, unit: str):
    """100 x the least time the frames' work allows over the device time
    of the kernels ``names``; None without a trace or without a launch."""
    if run.trace is None or run.peaks is None or not run.traced_counts:
        return None
    secs = kernel_seconds(run, *names)
    if secs <= 0.0:
        return None
    least = sum(work.least_seconds(work_fn(c), run.peaks, unit) for c in run.traced_counts)
    return 100.0 * least / secs


def in_frames(run, start_us: float) -> bool:
    """Whether a host event that starts at ``start_us`` lies in a traced
    frame span (the harness's synchronize lies outside them)."""
    return any(s <= start_us <= s + d for s, d in run.trace.frames)
