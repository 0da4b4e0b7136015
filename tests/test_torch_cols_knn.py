"""Column-grid exact kNN parity: the port's ops/cols_knn.py and the host
grid heuristic against the JAX package, on seeded numpy clouds.

* ``_cols_build`` on a voxel-unique cloud: planes, slot_orig, point_slot
  and drop_ring bit-equal (the sort keys are unique, so the stable torch
  sort and lax.sort order the slots alike).
* With column-cap drops and out-of-grid points: drop_ring equal (which of
  two tied points a column drops may differ; the flagged column cannot).
* ``cols_knn_mean_distance``: the uncovered set equal, md allclose
  (rtol 1e-5, atol 1e-6) where covered: summation order differs, and XLA
  on the CPU rounds d2 through FMAs (tests/test_torch_cols_select.py).
* ``bruteforce_md_subset``: allclose (rtol 1e-5, atol 1e-6), zero off the
  selection; both expand |a|^2 + |b|^2 - 2ab in full f32.
* ``_cols_grid_params``: the same (perm, gy, gz, cap, origin) tuple.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu import ops as jops
from cwipc_util_tpu.ops import cols_knn as jcols
from cwipc_util_tpu_torch import ops as pops
from cwipc_util_tpu_torch.ops import cols_knn

CHUNK = 64


def _voxel_unique(seed=3, cell=0.02):
    rng = np.random.default_rng(seed)
    pts = []
    for iy in range(3, 28):
        for iz in range(3, 20):
            for ix in range(int(rng.integers(1, 9))):
                j = rng.random(3) * cell * 0.9
                pts.append([ix * cell + j[0], iy * cell + j[1], iz * cell + j[2]])
    n = len(pts)
    xyz = np.zeros((1 << int(np.ceil(np.log2(n))), 3), np.float32)
    xyz[:n] = np.asarray(pts, np.float32)
    return xyz, n, cell


def _random(n, seed, spread=0.3, capn=1024):
    rng = np.random.default_rng(seed)
    xyz = np.zeros((capn, 3), np.float32)
    xyz[:n] = rng.random((n, 3), dtype=np.float32) * spread
    return xyz, n


def _build_both(xyz, n, cell, vmin=None, **geo):
    j = jcols._cols_build(jnp.asarray(xyz), jnp.int32(n), jnp.float32(cell), chunk=CHUNK,
                          vmin_override=None if vmin is None else jnp.asarray(vmin, jnp.int32), **geo)
    p = cols_knn._cols_build(torch.from_numpy(xyz), torch.tensor(n, dtype=torch.int32), cell,
                             chunk=CHUNK, vmin_override=vmin, **geo)
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


def test_build_bit_equal_on_voxel_unique_cloud():
    xyz, n, cell = _voxel_unique()
    j, p = _build_both(xyz, n, cell, gy=32, gz=24, cap=28)
    for a, b in zip(j[:3], p[:3]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    for i in (3, 4, 5, 6):  # slot_orig, valid, drop_ring, point_slot
        np.testing.assert_array_equal(j[i], p[i])
    assert not p[5].any() and (p[6][:n] < 32 * 24 * 28).all()
    assert np.array_equal(np.sort(p[3][p[3] >= 0]), np.arange(n))


@pytest.mark.parametrize("cap,vmin", [(1, None), (8, [2, 10, 5]), (1, [-1, 5, 4])])
def test_build_drop_ring_with_drops(cap, vmin):
    """Column-cap drops (cap 1: the few columns holding two of the sparse
    cloud's points) and out-of-grid points (the override moves the grid's
    origin into the cloud)."""
    xyz, n = _random(900, 17, spread=0.9)
    j, p = _build_both(xyz, n, 0.02, vmin=vmin, gy=64, gz=64, cap=cap)
    assert j[5].any() and 0 < p[5].sum() < p[5].size
    np.testing.assert_array_equal(j[5], p[5])


def _md_both(xyz, n, cell, k, vu, **geo):
    jmd, junc = jcols.cols_knn_mean_distance(jnp.asarray(xyz), jnp.int32(n), jnp.float32(cell), k,
                                             voxel_unique=vu, chunk=CHUNK, **geo)
    pmd, punc = cols_knn.cols_knn_mean_distance(torch.from_numpy(xyz), torch.tensor(n, dtype=torch.int32),
                                                cell, k, voxel_unique=vu, chunk=CHUNK, **geo)
    return np.asarray(jmd), np.asarray(junc), pmd.numpy(), punc.numpy()


@pytest.mark.parametrize("scene", ["random_k6", "voxel_unique_k30"])
def test_mean_distance_matches_jax(scene):
    if scene == "random_k6":
        xyz, n = _random(700, 5)
        jmd, junc, pmd, punc = _md_both(xyz, n, 0.02, 6, False, gy=24, gz=24, cap=12)
    else:
        xyz, n, cell = _voxel_unique()
        jmd, junc, pmd, punc = _md_both(xyz, n, cell, 30, True, gy=32, gz=24, cap=28)
    np.testing.assert_array_equal(punc, junc)
    cov = ~junc & (np.arange(xyz.shape[0]) < n)
    assert cov.sum() > 100 and punc.any()
    np.testing.assert_allclose(pmd[cov], jmd[cov], rtol=1e-5, atol=1e-6)
    assert not pmd[n:].any() and not punc[n:].any()


def test_bruteforce_subset_matches_jax():
    xyz, n = _random(700, 9)
    sel = np.random.default_rng(1).random(1024) < 0.3  # some past the count
    j = np.asarray(jcols.bruteforce_md_subset(jnp.asarray(xyz), jnp.int32(n), jnp.asarray(sel), 8))
    p = cols_knn.bruteforce_md_subset(torch.from_numpy(xyz), torch.tensor(n, dtype=torch.int32),
                                      torch.from_numpy(sel), 8).numpy()
    on = sel & (np.arange(1024) < n)
    assert on.sum() > 150
    np.testing.assert_allclose(p[on], j[on], rtol=1e-5, atol=1e-6)
    assert not p[~on].any()


@pytest.mark.parametrize("seed,outliers", [(0, 0), (1, 5)])
def test_grid_params_same_tuple(seed, outliers):
    rng = np.random.default_rng(seed)
    xyz = rng.random((5000, 3)) * [0.5, 2.0, 0.4]
    xyz[:outliers] += 50.0  # far points, clipped by the percentiles
    cell = 0.011
    a, b = jops._cols_grid_params(xyz, cell), pops._cols_grid_params(xyz, cell)
    assert a[:4] == b[:4]
    np.testing.assert_array_equal(a[4], b[4])
    assert pops._cols_grid_params(xyz * 1e3, cell) is None is jops._cols_grid_params(xyz * 1e3, cell)
