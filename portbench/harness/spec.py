"""Finding a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` its entry names (under ``portbench/configs/``);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a metric's reader: ``portbench/metrics/<name>.py``, or, where there is
  none, ``portbench/metrics/<base>.py`` for the part of the name before
  its first dot (``frames_per_s`` reads ``frames_per_s.exact``).  A
  reader is a module with ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent


class SpecError(Exception):
    """A name in BENCHMARK.json that resolves to no file."""


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise SpecError(f"no configuration {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    """A configuration by its name under ``configs/`` (for the scripts
    that work outside a cell: readings.py, size_grid.py, explore.py)."""
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no traffic file {path}")
    with open(path) as f:
        return json.load(f)


def reader_path(metric: str) -> Path:
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            return path
    raise SpecError(f"no reader for metric {metric!r} under {HERE / 'metrics'}")


def reader(metric: str):
    """The ``read`` function of the metric's reader module."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; each where its ``workloads`` name the cell
    or it has none."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
