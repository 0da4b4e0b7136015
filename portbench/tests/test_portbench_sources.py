"""A configuration's frame source and a traffic's judge resolve to files by
name (harness/spec.py): a source, a judge and a reader that exist only as
files in a folder of their own run a whole cell on the CPU; an unknown
name is refused with the path looked for; without a ``"generator"`` key
the frames are ``harness/bodies.py``'s; and the exact chain's judge gives
the numbers, failures and work counts the harness gave before it was a
file of its own."""

from __future__ import annotations

import re
import shutil
import textwrap
import time
from pathlib import Path

import pytest
import torch

from harness import bodies, cell, spec

POINTS = 3000

SPHERE = '''
"""A jittered sphere of radius 0.3 m, the same number of points each frame."""

import torch


def make_sequence(cfg, seed, device, capacity=None):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    n = cfg["points"]
    cap = capacity or n
    held = []
    for f in range(cfg["frames"]):
        d = torch.randn(n, 3, generator=gen, device=device, dtype=torch.float64)
        r = 0.3 + 0.002 * torch.randn(n, 1, generator=gen, device=device, dtype=torch.float64)
        xyz = torch.zeros(cap, 3, dtype=torch.float32, device=device)
        xyz[:n] = (d / d.norm(dim=1, keepdim=True) * r + torch.tensor([0.0, 1.0 + 0.01 * f, 0.0], device=device)).float()
        rgba = torch.zeros(cap, dtype=torch.int32, device=device)
        rgba[:n] = torch.randint(0, 1 << 24, (n,), generator=gen, device=device, dtype=torch.int32) | (1 << 24)
        held.append((xyz, rgba, torch.tensor(n, dtype=torch.int32, device=device)))
    return held, {"frames": list(range(cfg["frames"]))}
'''

BOUNDED = '''
"""Each output point has to lie in a cell that holds an input point, and
no more points may come out than the frame has cells."""

import torch

LIMITS = {"excess": 0, "foreign": 0}


def _cells(xyz, cell):
    return set(map(tuple, torch.floor(xyz.double() / cell).long().tolist()))


def judge(held, outputs, cfg, traffic, want_counts):
    cell = float(torch.tensor(cfg["chain"]["cellsize"], dtype=torch.float32))
    readings, counts, failed = [], [], 0
    for f, (xyz, rgba, count) in enumerate(held):
        n = int(count)
        cells = _cells(xyz[:n], cell)
        if want_counts:
            counts.append({"points_in": n, "voxels": len(cells)})
        out = outputs.get(f)
        if out is not None:
            m = int(out.count)
            r = {"excess": max(0, m - len(cells)), "foreign": len(_cells(out.xyz[:m], cell) - cells)}
            readings.append(r)
            failed += any(r[k] > LIMITS[k] for k in LIMITS)
    worst = {k: max(r[k] for r in readings) for k in LIMITS} if readings else None
    return worst, failed, counts
'''

POINTS_IN = '''
def read(run):
    if not run.traced_counts:
        return None
    return sum(c["points_in"] for c in run.traced_counts) / len(run.traced_counts)
'''


def _elsewhere(monkeypatch, tmp_path: Path) -> Path:
    """A benchmark folder that holds only the new source, judge and reader
    (and the table of peaks a traced run reads), put where spec looks."""
    for folder, name, text in (("generators", "sphere", SPHERE), ("judges", "bounded", BOUNDED),
                               ("metrics", "points_in_per_frame", POINTS_IN)):
        (tmp_path / folder).mkdir()
        (tmp_path / folder / f"{name}.py").write_text(textwrap.dedent(text))
    shutil.copy(spec.HERE / "peaks.json", tmp_path / "peaks.json")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    return tmp_path


def _traffic(judge: str | None) -> dict:
    return {**spec.traffic("exact-closed"), "judge": judge}


@pytest.mark.parametrize("fault", [None, "moved"])
def test_new_source_and_judge_run_a_cell(tiny_config, monkeypatch, tmp_path, fault):
    traffic = _traffic("bounded")  # read before spec looks elsewhere
    cfg = {**tiny_config, "generator": "sphere", "points": POINTS}
    if fault == "moved":
        from cwipc_util_tpu_torch.core.buffers import PointBuffer
        from cwipc_util_tpu_torch.ops import chain

        sound = chain.downsample_outliers_tilefilter_exact

        def moved(buf, cellsize, *args, **kwargs):
            out, unc = sound(buf, cellsize, *args, **kwargs)
            xyz = out.xyz.clone()
            xyz[0, 0] += 1.0  # one point carried a metre off the sphere
            return PointBuffer(xyz=xyz, rgba=out.rgba, count=out.count), unc

        monkeypatch.setattr(chain, "downsample_outliers_tilefilter_exact", moved)
    _elsewhere(monkeypatch, tmp_path)
    line, notes = cell.run_cell(cfg=cfg, traffic=traffic, metrics=[{"name": "points_in_per_frame", "unit": "points"}],
                                seed=2**31 + 7, seconds=0.5, traced=True, t_start=time.time(), device="cpu")
    assert set(line["checks"]) == {"excess", "foreign"} and len(notes) == 2
    assert all(c["limit"] == 0 and c["value"] >= 0 for c in line["checks"].values())
    assert line["metrics"]["points_in_per_frame"]["value"] == POINTS  # the judge's counts reach the reader
    if fault is None:
        assert line["correct"] is True and line["failed"] == 0
    else:
        assert line["correct"] is False and line["checks"]["foreign"]["value"] >= 1


@pytest.mark.parametrize("kind", ["generator", "judge"])
def test_unknown_name_names_its_path(tiny_config, kind):
    cfg, traffic = dict(tiny_config), _traffic(None)
    if kind == "generator":
        cfg["generator"] = "no_such_source"
        want = spec.HERE / "generators" / "no_such_source.py"
    else:
        traffic["judge"] = "no_such_judge"
        want = spec.HERE / "judges" / "no_such_judge.py"
    with pytest.raises(spec.SpecError, match=re.escape(str(want))):
        cell.run_cell(cfg=cfg, traffic=traffic, metrics=[], seed=1, seconds=0.1, traced=False,
                      t_start=time.time(), device="cpu")


@pytest.mark.parametrize("seed", [2**31 + 3, 5])
def test_default_source_is_the_bodies_bit_for_bit(tiny_config, seed):
    assert "generator" not in tiny_config
    got, got_info = spec.generator(tiny_config)(tiny_config, seed, "cpu", capacity=tiny_config["capacity"])
    want, want_info = bodies.make_sequence(tiny_config, seed, "cpu", capacity=tiny_config["capacity"])
    assert got_info == want_info and len(got) == len(want) == tiny_config["frames"]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# What the harness's own check of the exact chain gave, before it moved to
# judges/exact_chain.py, on the tiny body at seed 2**31 + 41 on the CPU:
# frame 0 as the chain left it, frame 1 with its first point moved one cell.
WORST = {"stray": 1, "keep_margin": 0.028894408569441383, "centroid_err_m": 0.008681635797074705, "color_wrong": 1}
COUNTS = [{"points_in": 19328, "voxels": 2620, "kept": 2289, "ring_pairs": 920800},
          {"points_in": 19172, "voxels": 2598, "kept": 2298, "ring_pairs": 959128}]
SOUND = {"stray": 0, "keep_margin": 0.0, "centroid_err_m": 1.0302613073776001e-07, "color_wrong": 0}


def test_exact_chain_judge_gives_the_harness_s_numbers(tiny_config):
    from cwipc_util_tpu_torch.core.buffers import PointBuffer
    from cwipc_util_tpu_torch.ops import chain

    traffic = spec.traffic("exact-closed")
    judge = spec.judge(traffic["judge"])
    assert judge.LIMITS == {"stray": 0, "keep_margin": 1e-3, "centroid_err_m": 1e-4, "color_wrong": 0}
    args = {key: tiny_config["chain"][key] for key in traffic["args"]}
    held, _ = spec.generator(tiny_config)(tiny_config, 2**31 + 41, "cpu", capacity=tiny_config["capacity"])
    outputs = {}
    for f, (xyz, rgba, count) in enumerate(held):
        out, _ = chain.downsample_outliers_tilefilter_exact(PointBuffer(xyz=xyz, rgba=rgba, count=count), **args)
        if f == 1:
            moved = out.xyz.clone()
            moved[0, 0] += tiny_config["chain"]["cellsize"]
            out = PointBuffer(xyz=moved, rgba=out.rgba, count=out.count)
        outputs[f] = out

    worst, failed, counts = judge.judge(held, outputs, tiny_config, traffic, want_counts=True)
    assert failed == 1 and counts == COUNTS
    assert worst == {k: pytest.approx(v, rel=1e-9) if isinstance(v, float) else v for k, v in WORST.items()}
    worst, failed, counts = judge.judge(held, {0: outputs[0]}, tiny_config, traffic, want_counts=False)
    assert failed == 0 and counts == []
    assert worst == {k: pytest.approx(v, rel=1e-9) if isinstance(v, float) else v for k, v in SOUND.items()}
    assert judge.judge(held, {}, tiny_config, traffic, want_counts=False) == (None, 0, [])
