"""The plain reference against brute-force NumPy at a tiny size, and the
judge on outputs that are right and on outputs with a planted fault."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from harness import bodies
from reference import exact_chain, judge

CELL = 0.03


def _naive_morton(x: int, y: int, z: int) -> int:
    key = 0
    for b in range(10):
        key |= ((x >> b) & 1) << (3 * b) | ((y >> b) & 1) << (3 * b + 1) | ((z >> b) & 1) << (3 * b + 2)
    return key


@pytest.fixture(scope="module")
def frame(tiny_config):
    (xyz, rgba, count), *_ = bodies.make_sequence(tiny_config, 2**31 + 99, "cpu", capacity=tiny_config["capacity"])[0]
    return xyz, rgba, int(count)


def test_morton_matches_bit_by_bit():
    rng = np.random.default_rng(0)
    vm = rng.integers(0, 1024, size=(200, 3))
    got = exact_chain.morton(torch.from_numpy(vm)).numpy()
    assert [int(k) for k in got] == [_naive_morton(*map(int, v)) for v in vm]


def test_f32_scale_is_the_float32_product():
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, size=(1000, 3)).astype(np.float32)
    inv = np.float32(1.0) / np.float32(0.004)
    want = x * inv  # numpy multiplies float32 by float32 in float32
    np.testing.assert_array_equal(exact_chain.f32_scale(torch.from_numpy(x), 0.004).numpy(), want)


def test_downsample_matches_numpy_groups(frame):
    xyz, rgba, n = frame
    got = exact_chain.downsample(xyz, rgba, n, CELL)
    x = xyz[:n].numpy()
    c = rgba[:n].numpy().view(np.uint32).astype(np.int64)
    scaled = x * (np.float32(1.0) / np.float32(CELL))
    v = np.floor(scaled).astype(np.int64)
    q = np.clip(((scaled - v.astype(np.float32)) * np.float32(1024)).astype(np.int64), 0, 1023)
    groups: dict = {}
    for i in range(n):
        groups.setdefault(tuple(v[i]), []).append(i)
    vmin = v.min(0)
    keys = sorted(groups, key=lambda t: _naive_morton(*(np.array(t) - vmin)))
    assert got["key"].tolist() == [_naive_morton(*(np.array(t) - vmin)) for t in keys]
    cell64 = float(np.float32(CELL))
    for j, t in enumerate(keys[::37]):
        idx = groups[t]
        j = keys.index(t)
        cen = (np.array(t) + ((q[idx] + 0.5) / 1024).mean(0)) * cell64
        np.testing.assert_allclose(got["centroid"][j].numpy(), cen, rtol=0, atol=1e-12)
        assert got["rgb"][j].tolist() == [int(((c[idx] >> s) & 255).sum() // len(idx)) for s in (16, 8, 0)]
        tile = 0
        for i in idx:
            tile |= int(c[i] >> 24)
        assert int(got["tile"][j]) == tile and got["vox"][j].tolist() == list(t)


@pytest.mark.parametrize("slab", [0.05, 0.5])
def test_knn_mean_distance_is_exact(frame, slab):
    xyz, rgba, n = frame
    c = exact_chain.downsample(xyz, rgba, n, CELL)["centroid"]
    cn = c.numpy()
    d = np.sqrt(((cn[:, None, :] - cn[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    want = np.sort(d, axis=1)[:, :30].mean(1)
    got = exact_chain.knn_mean_distance(c, 30, slab, block=256).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_threshold_is_mean_plus_sample_sigma():
    md = torch.tensor([1.0, 2.0, 4.0, 8.0], dtype=torch.float64)
    want = md.numpy().mean() + 1.5 * md.numpy().std(ddof=1)
    assert float(exact_chain.threshold(md, 1.5)) == pytest.approx(want, rel=1e-15)


@pytest.fixture(scope="module")
def ref(frame):
    xyz, rgba, n = frame
    return exact_chain.run(xyz, rgba, n, cellsize=CELL, k=30, mult=1.0, tile=0, slab=8 * CELL)


def _as_output(r):
    kept = r["kept"]
    rgba = (r["tile"][kept] << 24) | (r["rgb"][kept, 0] << 16) | (r["rgb"][kept, 1] << 8) | r["rgb"][kept, 2]
    return r["centroid"][kept].to(torch.float32), rgba.to(torch.int32), int(kept.shape[0])


def test_judge_passes_the_reference_itself(ref):
    got = judge.judge_frame(ref, *_as_output(ref), CELL)
    assert got["stray"] == 0 and got["color_wrong"] == 0 and got["keep_margin"] == 0.0
    assert got["centroid_err_m"] < 1e-7 and judge.verdict(got)


@pytest.mark.parametrize("fault", ["moved", "swapped", "dropped", "recoloured", "low_precision"])
def test_judge_fails_planted_faults(ref, frame, fault):
    xyz, rgba, n = _as_output(ref)
    xyz, rgba = xyz.clone(), rgba.clone()
    if fault == "moved":
        xyz[3, 1] += CELL
    elif fault == "swapped":
        xyz[[3, 4]] = xyz[[4, 3]]
        rgba[[3, 4]] = rgba[[4, 3]]
    elif fault == "dropped":  # the most clearly kept voxel left out
        j = int(torch.argmin(torch.where(ref["keep"], ref["md"], torch.inf)))
        at = int((ref["kept"] == j).nonzero())
        keep = torch.arange(n) != at
        xyz, rgba, n = xyz[keep], rgba[keep], n - 1
    elif fault == "recoloured":
        rgba[5] ^= 1
    else:
        fx, frgba, fn = frame
        low = exact_chain.run(fx, frgba, fn, cellsize=CELL, k=30, mult=1.0, tile=0, slab=8 * CELL,
                              dtype=torch.bfloat16)
        xyz, rgba, n = _as_output(low)
    assert not judge.verdict(judge.judge_frame(ref, xyz, rgba, n, CELL))
