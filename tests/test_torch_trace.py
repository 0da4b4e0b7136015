"""The exact chain's spans (cwipc_util_tpu_torch/utils/trace.py), on the
CPU at 576 points: off, ``span`` enters nothing; under ``torch.profiler``
each of the four spans is in the Chrome trace once a call, the stages
inside ``cwipc.exact``; the outputs are bit-equal either way.  The column
cap of 3 leaves every voxel uncovered, so the fixup runs its blocks."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cwipc_util_tpu_torch as port
from cwipc_util_tpu_torch.models.synthetic import _generate_host
from cwipc_util_tpu_torch.ops import chain
from cwipc_util_tpu_torch.utils import trace

H = 24
CELL = 2.0 / H * 2.0
STAGES = ("cwipc.downsample", "cwipc.grid_build", "cwipc.fixup")


@pytest.fixture(scope="module")
def buf():
    return port.buffer_from_numpy(_generate_host(H, H, 0.5), 1024, device="cpu")


def _exact(buf):
    return chain.downsample_outliers_tilefilter_exact(buf, CELL, 30, 1.0, 0, 1024, gy=16, gz=8, cap=3)


def _profiled(buf, tmp_path):
    """One call under a CPU profiler: (outputs, the trace's program spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _exact(buf)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("cwipc.")]
    return out, spans


def test_span_off_is_the_shared_null_context(buf, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.enabled()
    assert trace.span("cwipc.exact") is trace.span("cwipc.fixup")
    with trace.span("cwipc.exact"):
        pass
    out, unc = _exact(buf)
    assert int(unc) > 0 and int(out.count) > 0


def test_enabled_follows_the_profiler():
    assert not trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
        assert trace.span("cwipc.exact") is not trace.span("cwipc.exact")
    assert not trace.enabled()


def test_each_span_once_a_call_nested_in_the_entry(buf, tmp_path):
    _, spans = _profiled(buf, tmp_path)
    assert sorted(e["name"] for e in spans) == sorted(("cwipc.exact",) + STAGES)
    assert all(e["cat"] == "user_annotation" for e in spans)
    entry = next(e for e in spans if e["name"] == "cwipc.exact")
    for e in spans:
        assert e["tid"] == entry["tid"]
        if e["name"] in STAGES:
            assert entry["ts"] <= e["ts"] and e["ts"] + e["dur"] <= entry["ts"] + entry["dur"]
    order = [e["name"] for e in sorted(spans, key=lambda e: e["ts"]) if e["name"] in STAGES]
    assert order == list(STAGES)


def test_outputs_bit_equal_with_the_profiler_on_and_off(buf, tmp_path):
    off, unc_off = _exact(buf)
    (on, unc_on), _ = _profiled(buf, tmp_path)
    assert int(unc_on) == int(unc_off) > 0
    assert torch.equal(on.count, off.count)
    assert torch.equal(on.xyz, off.xyz) and torch.equal(on.rgba, off.rgba)
