"""The harness: names in BENCHMARK.json resolve to files, the work and
byte functions give hand-counted values, the import guard, the metric
readers on a trace of known contents, and the runs that must fail."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from harness import spec, trace, work
from harness.cell import Run
from harness.guard import forbidden_modules

BENCH = spec.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    cfg = spec.config(BENCH, entry["name"])
    assert cfg["name"] == entry["name"]
    assert entry["file"].startswith("portbench/configs/")
    assert all(key in cfg for key in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert {"cellsize", "k", "mult", "tile", "out_capacity", "gy", "gz", "cap"} <= set(cfg["chain"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = spec.workload(BENCH, cell)
    traffic = spec.traffic(w["traffic"])
    cfg = spec.config(BENCH, w["config"])
    assert set(traffic["args"]) <= set(cfg["chain"])
    assert callable(spec.generator(cfg))
    if traffic["judge"] is not None:
        judge = spec.judge(traffic["judge"])
        assert callable(judge.judge) and judge.LIMITS
    assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = [m["name"] for m in spec.metrics_for(BENCH, cell, traced=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(BENCH, cell, traced=True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"])
    assert callable(spec.reader(metric["name"]))
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if "moves" in metric:
        assert metric["moves"] in E2E


def test_names_are_unique_and_valid():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_ring_offsets_are_the_77_columns():
    offs = work.ring_offsets()
    assert len(offs) == 77 and (0, 0) in offs
    assert (4, 3) in offs and (4, 4) not in offs and (-4, -4) not in offs


def _ref(vox: list[list[int]], keep: list[bool]) -> dict:
    return {"vox": torch.tensor(vox), "key": torch.arange(len(vox)), "keep": torch.tensor(keep)}


def test_frame_counts_hand_counted():
    # three voxels in column (y 0, z 0), one in (0, 2), one in (0, 5)
    vox = [[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 0, 2], [7, 0, 5]]
    chain = {"gy": 4, "gz": 8, "cap": 8}
    c = work.frame_counts(_ref(vox, [True, True, False, True, True]), chain, points_in=40)
    # column (0,0): 3 queries x (3 + 1 in ring - 1 self) = 9; (0,2): 1 x (3 + 1 + 1 - 1) = 4;
    # (0,5): 1 x (1 + 1 - 1) = 1, as (0,2) is 3 columns away and (0,0) 5
    assert c == {"points_in": 40, "voxels": 5, "kept": 4, "ring_pairs": 14}


def test_frame_counts_clamp_to_cap():
    vox = [[x, 0, 0] for x in range(6)]
    c = work.frame_counts(_ref(vox, [True] * 6), {"gy": 2, "gz": 2, "cap": 4}, points_in=6)
    assert c["ring_pairs"] == 4 * 3  # 4 slots held, each against the 3 others


def test_work_functions_hand_counted():
    c = {"points_in": 1000, "voxels": 100, "kept": 90, "ring_pairs": 5000}
    assert work.k1_segment_reduce(c) == (8000.0, 12000.0 + 3600.0)
    assert work.k4_select(c) == (40000.0, 2000.0)
    assert work.k3_compact(c) == (100.0, 1700.0 + 1440.0)
    peaks = {"hbm_bytes_per_s": 1e3, "fp32_flops_per_s": 1e4}
    assert work.least_seconds((4e4, 2e3), peaks, "fp32_flops_per_s") == 4.0
    assert work.least_seconds((1e2, 3140.0), peaks, "fp32_flops_per_s") == 3.14


def test_guard_catches_jax_and_passes_the_port():
    assert forbidden_modules({"jax": 1, "jax.numpy": 1, "numpy": 1}) == ["jax", "jax.numpy"]
    assert forbidden_modules({"cwipc_util_tpu.ops": 1, "jaxlib": 1}) == ["cwipc_util_tpu.ops", "jaxlib"]
    assert forbidden_modules({"cwipc_util_tpu_torch": 1, "cwipc_util_tpu_torch.ops.chain": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"flax.linen": 1}) == ["flax.linen"]


def _trace() -> trace.Trace:
    """Two frames of 100 us each; kernels: a sort pass, kernels 1, 4 and
    3; one host read in frame 1, the harness's synchronize outside."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.FRAME_SPAN, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": trace.FRAME_SPAN, "ts": 200.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 5.0, "dur": 10.0, "tid": 1,
         "args": {"Input Dims": [[1024], [], []]}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 40.0, "dur": 10.0, "tid": 1,
         "args": {"Input Dims": [[256], [], []]}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6.0, "dur": 1.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 41.0, "dur": 1.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 60.0, "dur": 5.0, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 150.0, "dur": 5.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "DeviceRadixSortOnesweepKernel", "ts": 10.0, "dur": 20.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "DeviceRadixSortOnesweepKernel", "ts": 45.0, "dur": 5.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::segment_reduce_lookback(int)", "ts": 210.0, "dur": 10.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "cols_select_strip", "ts": 220.0, "dur": 30.0, "args": {}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 250.0, "dur": 10.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "compact_lookback", "ts": 280.0, "dur": 10.0, "args": {}},
    ]
    return trace.parse(events)


def _run() -> Run:
    t = _trace()
    lo, hi = t.window_us
    counts = {"points_in": 10_000_000, "voxels": 1_000_000, "kept": 500_000, "ring_pairs": 50_000_000}
    return Run(frames=4, window_s=0.5, latencies_s=[0.1, 0.2, 0.3, 0.4], setup_s=9.0, uncovered=40,
               capacity=1024, peaks={"hbm_bytes_per_s": 3e12, "fp32_flops_per_s": 6e13}, trace=t,
               traced_frames=2, traced_counts=[counts, counts], trace_window_s=(hi - lo) / 1e6,
               busy_s=sum(e - s for s, e in t.device_intervals()) / 1e6)


@pytest.mark.parametrize("name, want", [
    ("frames_per_s.exact", 8.0),
    ("frame_ms_p95.exact", 385.0),
    ("setup_s", 9.0),
    ("launches_per_frame.exact", 2.5),
    ("host_syncs_per_frame.exact", 0.5),
    ("sort_ms_per_frame.exact", 0.01),
    ("uncovered_per_frame.exact", 10.0),
    ("device_idle_pct.exact", 100.0 * (1 - 85.0 / 300.0)),
    ("k1_roofline.exact", 100.0 * 2 * (1.2e8 + 3.6e7) / 3e12 / 10e-6),
    ("k4_roofline.exact", 100.0 * 2 * (8 * 5e7) / 6e13 / 30e-6),
    ("k3_roofline.exact", 100.0 * 2 * (1.7e7 + 8e6) / 3e12 / 10e-6),
])
def test_readers_on_a_known_trace(name, want):
    assert spec.reader(name)(_run()) == pytest.approx(want, rel=1e-9)


def test_readers_without_a_trace_return_nothing():
    run = Run(frames=4, window_s=0.5, latencies_s=[0.1], setup_s=1.0)
    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace":
            assert spec.reader(m["name"])(run) is None


def test_idle_gaps_name_the_host_work():
    gaps = dict(trace.idle_gaps(_trace()))
    # gaps 0-10 (its middle inside the first sort), 30-45, 50-210, 260-280 and 290-300
    assert gaps == {"aten::sort": pytest.approx(10e-6), "host: outside any operator": pytest.approx(205e-6)}
    top = trace.top_device_ops(_trace())
    assert top[0] == ["cols_select_strip", pytest.approx(30e-6)]
    assert top[1] == ["DeviceRadixSortOnesweepKernel", pytest.approx(25e-6)]


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(spec.HERE / "run.py"), "--workload", CELLS[0], "--seed", str(2**31 + 5),
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "3",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
