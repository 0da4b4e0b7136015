"""The program's spans (harness/spans.py) and the readers that charge the
card's idle time, kernels and host waits to them: on the known trace of
test_portbench_harness.py with spans added, where every reader there reads
what it read before; on a CPU profile of the exact chain, read back from
the stopped profiler; and in a whole traced run on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

import test_portbench_harness as known
from harness import cell, spans, spec, trace
from harness.cell import Run

NEW = ("downsample_idle_ms_per_frame.exact", "build_idle_ms_per_frame.exact", "build_ms_per_frame.exact",
       "fixup_wait_ms_per_frame.exact", "entry_idle_ms_per_frame.exact")
OLD = [m["name"] for m in known.BENCH["end_to_end"] + known.BENCH["per_layer"] if m["name"] not in NEW]


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


# The known trace's idle gaps are 0-10, 30-45, 50-210, 260-280 and 290-300.
# Frame 1: the downsample holds the first gap's middle and the first sort's
# launch, the build the second gap's middle and the second sort's launch
# (5 us of kernel), the fixup the 5 us synchronize.  50-210 lies between
# frames.  Frame 2: the fixup holds 260-280's middle, the entry 290-300's.
# A span of another thread is not the harness's and is left out.
SPAN_EVENTS = [
    _span("cwipc.exact", 2.0, 93.0), _span("cwipc.downsample", 3.0, 32.0),
    _span("cwipc.grid_build", 36.0, 19.0), _span("cwipc.fixup", 58.0, 12.0),
    _span("cwipc.exact", 202.0, 96.0), _span("cwipc.downsample", 203.0, 6.0),
    _span("cwipc.grid_build", 211.0, 19.0), _span("cwipc.fixup", 265.0, 10.0),
    _span("cwipc.downsample", 0.0, 300.0, tid=2),
    _span("other.span", 0.0, 300.0),
]


def _known_events() -> list[dict]:
    got = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "parse", got.append)
        known._trace()
    return got[0]


def _run_with_spans() -> Run:
    events = _known_events() + SPAN_EVENTS
    run = known._run()
    run.trace = trace.parse(events)
    run.trace.spans = spans.parse(events)
    return run


@pytest.mark.parametrize("name, want", [
    ("downsample_idle_ms_per_frame.exact", 10e-3 / 2),
    ("build_idle_ms_per_frame.exact", 15e-3 / 2),
    ("build_ms_per_frame.exact", 5e-3 / 2),
    ("fixup_wait_ms_per_frame.exact", 5e-3 / 2),
    ("entry_idle_ms_per_frame.exact", 10e-3 / 2),
])
def test_span_readers_on_a_known_trace(name, want):
    assert spec.reader(name)(_run_with_spans()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", NEW)
def test_span_readers_without_spans_return_nothing(name):
    assert spec.reader(name)(known._run()) is None


@pytest.mark.parametrize("name", OLD)
def test_old_readers_read_the_same_beside_spans(name):
    assert spec.reader(name)(_run_with_spans()) == spec.reader(name)(known._run())


def test_span_events_leave_the_trace_lists_and_gaps_as_they_were():
    plain, spanned = known._trace(), trace.parse(_known_events() + SPAN_EVENTS)
    for lst in ("kernels", "copies", "runtime", "ops", "frames"):
        assert getattr(spanned, lst) == getattr(plain, lst)
    assert trace.idle_gaps(spanned) == trace.idle_gaps(plain)
    assert trace.top_device_ops(spanned) == trace.top_device_ops(plain)


def test_idle_split_adds_up_to_the_window_idle():
    run = _run_with_spans()
    idle = spans.idle_by_span(run)
    assert idle == pytest.approx({"cwipc.downsample": 10e-6, "cwipc.grid_build": 15e-6, "cwipc.fixup": 20e-6,
                                  "cwipc.exact": 10e-6, spans.OUTSIDE: 160e-6}, rel=1e-9)
    window_idle = spec.reader("device_idle_pct.exact")(run) / 100.0 * run.trace_window_s
    assert sum(idle.values()) == pytest.approx(window_idle, rel=1e-12)


@pytest.fixture(scope="module")
def tiny_frame():
    import cwipc_util_tpu_torch as port
    from cwipc_util_tpu_torch.models.synthetic import _generate_host

    return port.buffer_from_numpy(_generate_host(24, 24, 0.5), 1024, device="cpu")


def test_spans_read_back_from_the_stopped_profiler(tiny_frame, tmp_path):
    import json

    from cwipc_util_tpu_torch.ops import chain

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    for _ in range(2):
        with torch.profiler.record_function(trace.FRAME_SPAN):
            chain.downsample_outliers_tilefilter_exact(tiny_frame, 1 / 6, 30, 1.0, 0, 1024, gy=16, gz=8, cap=3)
    prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    run = Run(trace=trace.parse(events), traced_frames=2)
    got = spans.of(run)
    assert run.trace.spans is got
    want = spans.parse(events)
    assert [s[0] for s in got] == [s[0] for s in want] and len(got) == 8
    for (_, s, d, _), (_, ws, wd, _) in zip(got, want):
        assert s == pytest.approx(ws, abs=2e-3) and d == pytest.approx(wd, abs=2e-3)


def test_traced_cpu_run_reports_each_span_once_a_frame(tiny_config, monkeypatch):
    seen = []
    reader = spec.reader

    def keeping(name):
        read = reader(name)
        return lambda run: (seen.append(run), read(run))[1]

    monkeypatch.setattr(spec, "reader", keeping)
    metrics = [m for m in spec.load_bench()["per_layer"] if m["name"] in NEW + ("device_idle_pct.exact",)]
    line, _ = cell.run_cell(cfg=tiny_config, traffic=spec.traffic("exact-closed"), metrics=metrics,
                            seed=2**31 + 29, seconds=1.0, traced=True, t_start=time.time(), device="cpu")
    assert line["correct"] is True
    assert set(line["metrics"]) == set(NEW) | {"device_idle_pct.exact"}
    run = seen[0]
    got = spans.of(run)
    for fs, fd in run.trace.frames:
        inside = [name for name, s, d, _ in got if fs <= s and s + d <= fs + fd]
        assert sorted(inside) == sorted(["cwipc.exact", "cwipc.downsample", "cwipc.grid_build", "cwipc.fixup"])
    idle = spans.idle_by_span(run)
    assert sum(idle.values()) == pytest.approx(run.trace_window_s * (1 - run.busy_s / run.trace_window_s))
    assert line["metrics"]["build_ms_per_frame.exact"]["value"] == 0.0  # no kernel on the CPU
