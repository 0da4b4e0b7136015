"""Finding a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` its entry names (under ``portbench/configs/``);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a metric's reader: ``portbench/metrics/<name>.py``, or, where there is
  none, ``portbench/metrics/<base>.py`` for the part of the name before
  its first dot (``frames_per_s`` reads ``frames_per_s.exact``).  A
  reader is a module with ``read(run) -> float | None``;
* a configuration's frame source: ``portbench/generators/<generator>.py``
  for its ``"generator"`` key, ``harness/bodies.py`` where it has none.  A
  source is a module with ``make_sequence(cfg, seed, device, capacity=None)
  -> (held, info)``: ``held`` a list of (xyz f32 [capacity, 3], rgba int32
  [capacity], count int32 0-d) on ``device``, ``info`` what else it tells;
* a traffic's judge: ``portbench/judges/<judge>.py`` for its ``"judge"``
  key (null: the run is unchecked).  A judge is a module with ``LIMITS``
  (each number's name and its limit) and ``judge(held, outputs, cfg,
  traffic, want_counts) -> (worst, failed, counts)``: the worst of each
  number over the outputs judged (None where there were none), the frames
  failed, and with ``want_counts`` one dict of work counts a frame held,
  which the metric readers read (``Run.traced_counts``).
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


def _load(path: Path, kind: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(kind: str, folder: str, name: str) -> Path:
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no {kind} {name!r}: no file {path}")
    return path


def reader(metric: str):
    """The ``read`` function of the metric's reader module."""
    return _load(reader_path(metric), "metric").read


def generator(cfg: dict):
    """The ``make_sequence`` function of the configuration's frame source."""
    name = cfg.get("generator")
    if name is None:
        from . import bodies

        return bodies.make_sequence
    return _load(_named("frame source", "generators", name), "generator").make_sequence


def judge(name: str):
    """The judge module a traffic names (``LIMITS``, ``judge``)."""
    return _load(_named("judge", "judges", name), "judge")


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; each where its ``workloads`` name the cell
    or it has none."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
