"""One run of one cell: set-up, the measured window, the check, the line.

The traffic file names the program's entry (a function of
``cwipc_util_tpu_torch.ops.chain``), the configuration keys it takes, how
frames arrive and the judge of its outputs; the configuration names its
frame source (both resolve to files by name, harness/spec.py).  The one
loop so far is ``closed``: the next frame's call follows the synchronize
that ends the previous one, the frames cycled in the seed's order from
those held on the card.

Set-up (``setup_s``) runs from process start to the first timed frame:
the program's import, the card's context, the sequence made on the card,
and one warm-up cycle over every frame held (which loads, and in a
checkout's first run builds, the kernels).  The window runs whole frames
until ``seconds`` have passed.  With ``trace`` the profiler records the
window's first ``trace_cycles`` cycles.  After the window: the memory
peak, then the judge's check of one sampled output of each frame held
against its plain reference, then the metrics.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field

import torch

from . import spec, trace as tracing
from .guard import forbidden_modules


@dataclass
class Run:
    """What the metric readers read (harness/readers.py)."""

    frames: int = 0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    setup_s: float = 0.0
    uncovered: int | None = None
    capacity: int = 0
    peaks: dict | None = None
    trace: tracing.Trace | None = None
    traced_frames: int = 0
    traced_counts: list = field(default_factory=list)
    busy_s: float = 0.0
    trace_window_s: float = 0.0


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run_cell(*, cfg: dict, traffic: dict, metrics: list[dict], seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", parts: dict | None = None) -> tuple[dict, list[str]]:
    """One run of configuration ``cfg`` under ``traffic`` (both as their
    files hold them), reporting ``metrics`` (entries of BENCHMARK.json).
    Returns the result line's object and the check's lines for standard
    error (each number beside its limit).  ``parts`` holds the set-up's
    seconds by part so far; the rest are added and logged.  A traffic
    whose ``judge`` is null is run unchecked (``correct`` null): no cell
    has one."""
    from cwipc_util_tpu_torch.core.buffers import PointBuffer
    from cwipc_util_tpu_torch.ops import chain as chain_mod

    parts = dict(parts or {})
    if traffic["loop"] != "closed":
        raise spec.SpecError(f"traffic loop {traffic['loop']!r} is not known")
    judge = None if traffic["judge"] is None else spec.judge(traffic["judge"])
    make_sequence = spec.generator(cfg)
    entry = getattr(chain_mod, traffic["entry"])
    args = {key: cfg["chain"][key] for key in traffic["args"]}
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t = time.monotonic()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    parts["card_context"] = time.monotonic() - t
    t = time.monotonic()
    held, _ = make_sequence(cfg, seed, device, capacity=cfg["capacity"])
    bufs = [PointBuffer(xyz=x, rgba=r, count=c) for x, r, c in held]
    sync()
    parts["data"] = time.monotonic() - t
    t = time.monotonic()
    for buf in bufs:  # one warm-up cycle: every frame's shapes, the kernels loaded
        entry(buf, **args)
    sync()
    parts["warmup"] = time.monotonic() - t
    npoints = [int(c) for _, _, c in held]
    log(f"set-up parts (s): {parts}; points a frame {npoints}")

    run = Run(capacity=cfg["capacity"])
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    nheld = len(bufs)
    trace_frames = traffic["trace_cycles"] * nheld if traced else 0
    rng = random.Random(seed)
    seen = [0] * nheld
    outputs: dict = {}
    unc = []
    prof = tracing.profiler() if traced else None
    if prof is not None:
        prof.start()
    run.setup_s = time.time() - t_start
    w0 = time.perf_counter()
    i = 0
    while True:
        f = i % nheld
        t0 = time.perf_counter()
        if i < trace_frames:
            with torch.profiler.record_function(tracing.FRAME_SPAN):
                out = entry(bufs[f], **args)
        else:
            out = entry(bufs[f], **args)
        sync()
        t1 = time.perf_counter()
        run.latencies_s.append(t1 - t0)
        result, n_unc = out if isinstance(out, tuple) else (out, None)
        if n_unc is not None:
            unc.append(n_unc)
        seen[f] += 1
        if rng.random() * seen[f] < 1.0:  # one output of each frame held, drawn from the seed
            outputs[f] = result
        del out, result, n_unc
        i += 1
        if i == trace_frames:
            prof.stop()
        if t1 - w0 >= seconds:
            break
    run.frames = i
    run.window_s = time.perf_counter() - w0
    if prof is not None and i < trace_frames:
        prof.stop()
    log(f"window: {run.frames} frames in {run.window_s:.4f} s; setup_s {run.setup_s:.4f}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if unc:
        run.uncovered = int(torch.stack(unc).sum())
    del unc

    checks, failed, counts = None, 0, []
    t = time.monotonic()
    if judge is not None:
        checks, failed, counts = judge.judge(held, outputs, cfg, traffic, want_counts=traced)
        log(f"check: {len(outputs)} frames judged in {time.monotonic() - t:.2f} s")
    del outputs

    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if prof is not None:
        run.trace = tracing.read(prof)
        run.traced_frames = len(run.trace.frames)
        run.traced_counts = [counts[j % nheld] for j in range(run.traced_frames)] if counts else []
        lo, hi = run.trace.window_us
        run.trace_window_s = (hi - lo) / 1e6
        run.busy_s = sum(e - s for s, e in run.trace.device_intervals()) / 1e6
        run.peaks = _peaks(dev["kind"])
        dev.update(busy_s=run.busy_s, window_s=run.trace_window_s)
        if on_card:
            dev["power_limit_w"] = _power_limit()
        breakdown = {"device_ops": tracing.top_device_ops(run.trace),
                     "idle_gaps": tracing.idle_gaps(run.trace)}

    values = {}
    for m in metrics:
        value = spec.reader(m["name"])(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}

    correct = None if checks is None else (failed == 0)
    line = {"correct": correct, "attempted": run.frames, "failed": failed, "metrics": values, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    notes = []
    if checks is not None:
        line["checks"] = {name: {"value": checks[name], "limit": limit} for name, limit in judge.LIMITS.items()}
        notes = [f"check {name}: {checks[name]!r} (limit {limit!r})" for name, limit in judge.LIMITS.items()]
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded forbidden modules: {bad}")
    return line, notes


def _peaks(kind: str) -> dict | None:
    import json

    with open(spec.HERE / "peaks.json") as f:
        table = json.load(f)
    return table.get(kind)


def _power_limit() -> float | None:
    """The card's power limit in watts, from nvidia-smi (None if it cannot
    be read)."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return float(p.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
