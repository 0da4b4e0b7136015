"""Kernel 4 parity: the port's column-grid selection (its plain version,
which CPU tensors run) against the JAX package's XLA formulation
(``cols_knn._cols_select``) and its Pallas kernel in interpret mode, on
planes that the JAX ``_cols_build`` makes from a seeded numpy cloud.

The contract is the one tests/test_pallas.py holds the TPU kernel to, on
occupied slots: the covered/uncovered classification (kth < 4*cell) is
equal; on covered slots kth agrees and the sums are allclose with rtol
1e-5, atol 1e-5 (the order of summation differs).

kth agrees to 1 ulp, not bit for bit: XLA on the CPU contracts the
squared distance into FMAs, fma(dz, dz, fma(dx, dx, dy*dy)) (measured: it
matches that form on every element and the port's rounded
((dx*dx) + (dy*dy)) + (dz*dz) on ~80%), so about one k-th distance in
ten comes out one ulp apart.  The port rounds d2 in the written order,
without FMAs, and kernel 4 on the card is held bit-equal to this plain
version by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu.ops.cols_knn import _cols_build as jax_build
from cwipc_util_tpu.ops.cols_knn import _cols_select as jax_select
from cwipc_util_tpu.ops.pallas_cols_select import cols_select_pallas
from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.ops.cols_select import cols_select, cols_select_plain

CHUNK = 64


def _random_scene(n, seed):
    rng = np.random.default_rng(seed)
    capn = 1 << int(np.ceil(np.log2(max(n, 2))))
    xyz = np.zeros((capn, 3), np.float32)
    xyz[:n] = rng.random((n, 3), dtype=np.float32) * 0.3
    return xyz, n, 0.02


def _tier_scene():
    """test_pallas.py's mixed-occupancy scene: blobs of columns holding
    27, 22, 18, 14 and 6 points on distinct x-cells."""
    cell = 0.02
    rng = np.random.default_rng(11)
    pts = []
    for y0, ny, occ in ((0, 4, 27), (15, 4, 22), (30, 3, 18), (45, 3, 14), (60, 2, 6)):
        for iy in range(ny):
            for iz in range(4):
                for ix in range(occ):
                    j = rng.random(3) * cell * 0.4
                    pts.append([(ix * 2) * cell + j[0], (y0 + iy) * cell + j[1], (2 + iz) * cell + j[2]])
    n = len(pts)
    xyz = np.zeros((1 << int(np.ceil(np.log2(n))), 3), np.float32)
    xyz[:n] = np.asarray(pts, np.float32)
    return xyz, n, cell


def _voxel_unique_scene():
    """test_pallas.py's voxel-unique scene: 1-8 points per column on
    distinct cells."""
    cell = 0.02
    rng = np.random.default_rng(3)
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


SCENES = {
    "n900_k8": (lambda: _random_scene(900, 908), dict(k=8, gy=24, gz=24, cap=12), False),
    "n300_k5": (lambda: _random_scene(300, 305), dict(k=5, gy=24, gz=24, cap=12), False),
    "n40_k30": (lambda: _random_scene(40, 70), dict(k=30, gy=24, gz=24, cap=12), False),
    "tiers": (_tier_scene, dict(k=9, gy=64, gz=24, cap=28), False),
    "voxel_unique_k30": (_voxel_unique_scene, dict(k=30, gy=32, gz=24, cap=28), True),
}


def _planes(scene):
    make, geo, vu = SCENES[scene]
    xyz, n, cell = make()
    built = jax_build(jnp.asarray(xyz), jnp.int32(n), jnp.float32(cell), gy=geo["gy"], gz=geo["gz"],
                      cap=geo["cap"], chunk=CHUNK)
    return [np.asarray(a) for a in built[:3]], cell, geo, vu


def _port(planes, geo, vu, **kw):
    t = [torch.from_numpy(a.copy()) for a in planes]
    sums, kth = cols_select(*t, **geo, chunk=CHUNK, voxel_unique=vu, **kw)
    return sums.numpy(), kth.numpy()


def _occupied(planes, geo):
    off = 4 * geo["gz"] + 4
    return planes[0][off:off + geo["gy"] * geo["gz"], :geo["cap"]] < 1e30


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _hold(scene, sums, kth, ref_sums, ref_kth, occ, cell):
    r_cut = np.float32(cell) * np.float32(4.0) * np.float32(1.0 - 1e-6)
    np.testing.assert_array_equal((kth < r_cut)[occ], (ref_kth < r_cut)[occ])
    cov = occ & (ref_kth < r_cut)
    assert _ulps(kth[cov], ref_kth[cov]).max(initial=0) <= 1
    np.testing.assert_allclose(sums[cov], ref_sums[cov], rtol=1e-5, atol=1e-5)
    if scene == "n40_k30":
        # 39 other points, none with k = 30 of them in its ring: every
        # query has fewer than k candidates and reads kth = F32_MAX
        assert occ.sum() == 40 and not cov.any()
        assert (kth[occ] == np.float32(3.4028235e38)).all()
    else:
        assert cov.sum() > 20


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_matches_jax_xla_selection(scene):
    planes, cell, geo, vu = _planes(scene)
    gyz = geo["gy"] * geo["gz"]
    c0s = jnp.arange(gyz // CHUNK, dtype=jnp.int32) * CHUNK
    js, jk = jax_select(*map(jnp.asarray, planes), c0s, chunk=CHUNK, voxel_unique=vu, **geo)
    js, jk = np.asarray(js).reshape(gyz, -1), np.asarray(jk).reshape(gyz, -1)
    sums, kth = _port(planes, geo, vu)
    occ = _occupied(planes, geo)
    _hold(scene, sums, kth, js, jk, occ, cell)
    # the same 81-column candidate set: kth within 1 ulp on every occupied
    # slot, covered or not (F32_MAX where < k candidates)
    assert _ulps(kth[occ], jk[occ]).max(initial=0) <= 1


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_matches_jax_pallas_kernel(scene):
    """The TPU kernel in interpret mode (77-column ring; the voxel-unique
    scene with its seeded bisection, as the exact chain runs it)."""
    planes, cell, geo, vu = _planes(scene)
    seeded = dict(cell=jnp.float32(cell), seeded=True) if vu else {}
    ps, pk = cols_select_pallas(*map(jnp.asarray, planes), k=geo["k"], gy=geo["gy"], gz=geo["gz"],
                                cap=geo["cap"], interpret=True, **seeded)
    sums, kth = _port(planes, geo, vu)
    _hold(scene, sums, kth, np.asarray(ps), np.asarray(pk), _occupied(planes, geo), cell)


@pytest.mark.parametrize("split", [1, 200, 575])
def test_row_ranges_concatenate_to_full(split):
    """Two row ranges, one not chunk-aligned, give the full run's rows."""
    planes, _cell, geo, vu = _planes("n900_k8")
    full = _port(planes, geo, vu)
    a = _port(planes, geo, vu, row0=0, nrows=split)
    b = _port(planes, geo, vu, row0=split)
    for i in range(2):
        np.testing.assert_array_equal(np.concatenate([a[i], b[i]]), full[i])


def test_plain_version_is_the_cpu_route():
    planes, _cell, geo, vu = _planes("n300_k5")
    t = [torch.from_numpy(a.copy()) for a in planes]
    got = cols_select(*t, **geo, chunk=CHUNK)
    want = cols_select_plain(*t, **geo, chunk=CHUNK)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rejects_bad_arguments():
    planes, _cell, geo, _vu = _planes("n300_k5")
    t = [torch.from_numpy(a.copy()) for a in planes]
    with pytest.raises(CwipcError, match="row range"):
        cols_select(*t, **geo, row0=500, nrows=100)
    with pytest.raises(CwipcError, match="rows"):
        cols_select(*(a[:-300] for a in t), **geo)
    with pytest.raises(CwipcError, match="dtype"):
        cols_select(t[0].double(), t[1], t[2], **geo)
    with pytest.raises(CwipcError, match="k >= 1"):
        cols_select(*t, **{**geo, "k": 0})
