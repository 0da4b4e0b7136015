"""Slice parity for the exact outlier path: the port's exact chain and
public ``cwipc_remove_outliers`` / ``cwipc_join`` against the JAX package,
on the CPU, fed the same numpy clouds.

* Exact chain: the kept voxel set and the residual (uncovered) count equal
  the JAX CPU exact chain's; coordinates allclose at the downsample's
  XLA-path tolerance (tests/test_torch_chain.py).  Against a float64
  cKDTree oracle a keep decision may flip only where the oracle's md lies
  within 1e-5 * thr of the threshold; the flips are counted and are 0 at
  this size.
* ``cwipc_remove_outliers``: the same points kept, in the same order, as
  the JAX public op (brute force for n <= 4096; for larger clouds the JAX
  CPU backend takes a float64 KD-tree, the port the column grid through
  kernel 4's plain version), with and without ``perTile``.
* ``cwipc_join``/``cwipc_join_multi``: the same points, timestamp and
  cellsize.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import cwipc_util_tpu as jport
from cwipc_util_tpu.core import buffers as jbuffers
from cwipc_util_tpu.ops import chain as jchain
import cwipc_util_tpu_torch as port
from cwipc_util_tpu_torch.models.synthetic import _generate_host
from cwipc_util_tpu_torch.ops import chain, voxelize

H = 200  # 40,000 points
CAP = 1 << 16
CELL = 2.0 / H * 2.0
OCAP = 12288
K, MULT = 30, 1.0
XLA_ATOL = 1e-6 * 2.0  # the JAX CPU downsample's drift on the 2.0-high axis


@pytest.fixture(scope="module")
def cloud():
    pts = _generate_host(H, H, 0.5)
    return jbuffers.buffer_from_numpy(pts, CAP), port.buffer_from_numpy(pts, CAP, device="cpu")


@pytest.fixture(scope="module")
def down(cloud):
    """The port's downsampled rows and the column-grid buckets for them:
    (y, z) extents in cells rounded up to 8, cap the fullest column's
    count rounded up to 4."""
    x, y, z, rgba, cnt = voxelize.downsample_cm(cloud[1], CELL, OCAP)
    n = int(cnt)
    xyz = torch.stack([x, y, z], -1).numpy()[:n]
    cell = np.float32(CELL)
    v = np.floor(xyz * (np.float32(1.0) / cell)).astype(np.int64)
    v -= v.min(0)
    gy, gz = (int(-(-(v[:, a].max() + 1) // 8) * 8) for a in (1, 2))
    _, per_col = np.unique(v[:, 1] * gz + v[:, 2], return_counts=True)
    cap = int(-(-per_col.max() // 4) * 4)
    return xyz, rgba.numpy()[:n], dict(gy=gy, gz=gz, cap=cap)


def _port_exact(cloud, down, tile):
    return chain.downsample_outliers_tilefilter_exact(cloud[1], CELL, K, MULT, tile, OCAP, **down[2])


@pytest.mark.parametrize("tile", [0, 1])
def test_exact_chain_matches_jax_exact_chain(cloud, down, tile):
    jout, jres = jchain.downsample_outliers_tilefilter_exact(
        cloud[0], jnp.float32(CELL), k=K, mult=jnp.float32(MULT), tile=jnp.uint32(tile),
        out_capacity=OCAP, **down[2],
    )
    pout, pres = _port_exact(cloud, down, tile)
    assert int(pres) == int(jres) > 0
    m = int(jout.count)
    assert int(pout.count) == m > 1000
    np.testing.assert_array_equal(pout.rgba.numpy().view(np.uint32), np.asarray(jout.rgba))
    np.testing.assert_allclose(pout.xyz.numpy(), np.asarray(jout.xyz), rtol=0, atol=XLA_ATOL)
    assert not pout.xyz[m:].any()


@pytest.mark.parametrize("tile", [0, 1])
def test_exact_chain_matches_float64_oracle(cloud, down, tile):
    xyz, rgba, _ = down
    pts = xyz.astype(np.float64)
    dist, _ = cKDTree(pts).query(pts, k=K + 1)
    md = dist[:, 1:].mean(axis=1)
    n = len(md)
    thr = md.mean() + MULT * np.sqrt(max(((md * md).sum() - md.sum() ** 2 / n) / (n - 1), 0.0))
    in_tile = tile == 0 or (((rgba.view(np.uint32) >> 24) & 0xFF) == tile)
    want = (md <= thr) & in_tile
    pout, _ = _port_exact(cloud, down, tile)
    # the output is the downsampled rows compacted in order: find each
    # kept row by its coordinates' bits
    row_of = {r.tobytes(): i for i, r in enumerate(xyz)}
    got = np.zeros(n, bool)
    got[[row_of[r.tobytes()] for r in pout.xyz.numpy()[: int(pout.count)]]] = True
    flips = got != want
    assert np.all(np.abs(md[flips] - thr) <= 1e-5 * thr)
    assert flips.sum() == 0 and want.sum() > 1000


def _pair(pts, cellsize=0.0, ts=1234):
    jpc = jport.cwipc_from_numpy_array(pts, ts)
    jpc._set_cellsize(cellsize)
    ppc = port.cwipc_pointcloud_wrapper(None, ts, cellsize, _host_points=pts.copy(), device="cpu")
    return jpc, ppc


@pytest.fixture(scope="module")
def clouds_for_op():
    """n <= 4096: a raw 3,600-point body.  n > 4096: a 22,500-point body
    downsampled at 1 cm by the port (19,332 points), its cellsize set."""
    small = _generate_host(60, 60, 0.5)
    big = port.cwipc_pointcloud_wrapper(None, 0, 0.0, _host_points=_generate_host(150, 150, 0.5),
                                        device="cpu")
    big_down = port.cwipc_downsample(big, 0.01)
    arr = big_down.get_numpy_array()
    for pc in (big, big_down):
        pc.free()
    return {"brute": (small, 0.0), "cols": (arr, 0.01)}


@pytest.mark.parametrize("route", ["brute", "cols"])
@pytest.mark.parametrize("per_tile", [False, True])
def test_remove_outliers_matches_jax(clouds_for_op, route, per_tile):
    pts, cellsize = clouds_for_op[route]
    assert (len(pts) <= 4096) == (route == "brute")
    jpc, ppc = _pair(pts, cellsize)
    jout = jport.cwipc_remove_outliers(jpc, K, MULT, per_tile)
    pout = port.cwipc_remove_outliers(ppc, K, MULT, per_tile)
    a, b = pout.get_numpy_array(), jout.get_numpy_array()
    assert 0 < len(a) == len(b) < len(pts)
    np.testing.assert_array_equal(a, b)
    assert (pout.timestamp(), pout.cellsize()) == (jout.timestamp(), jout.cellsize()) == (1234, cellsize)
    for pc in (jpc, ppc, jout, pout):
        pc.free()


def test_join_matches_jax():
    pts = _generate_host(40, 40, 0.5)
    parts = [pts[:700], pts[700:1000], pts[1000:]]
    jpcs = [jport.cwipc_from_numpy_array(p, 100 + i) for i, p in enumerate(parts)]
    ppcs = [port.cwipc_pointcloud_wrapper(None, 100 + i, 0.0, _host_points=p.copy(), device="cpu")
            for i, p in enumerate(parts)]
    for pc, c in zip(jpcs + ppcs, (0.03, 0.01, 0.02) * 2):
        pc._set_cellsize(c)
    jj, pj = jport.cwipc_join(jpcs[1], jpcs[0]), port.cwipc_join(ppcs[1], ppcs[0])
    np.testing.assert_array_equal(pj.get_numpy_array(), jj.get_numpy_array())
    assert (pj.count(), pj.timestamp(), pj.cellsize()) == (jj.count(), 100, 0.01)
    assert pj._access_buffer().capacity == jj._access_buffer().capacity == 1024
    jm, pm = jport.cwipc_join_multi(jpcs), port.cwipc_join_multi(ppcs)
    np.testing.assert_array_equal(pm.get_numpy_array(), pts)
    np.testing.assert_array_equal(pm.get_numpy_array(), jm.get_numpy_array())
    for pc in [jj, pj, jm, pm] + jpcs + ppcs:
        pc.free()


def test_pointcloud_setters_and_matrix_match_jax():
    pts = _generate_host(30, 30, 0.5)
    jpc, ppc = _pair(pts)
    np.testing.assert_array_equal(ppc.get_numpy_matrix(), jpc.get_numpy_matrix())
    np.testing.assert_array_equal(ppc.get_numpy_matrix(True), jpc.get_numpy_matrix(True))
    for pc in (jpc, ppc):
        pc._set_cellsize(-1)  # the reference's guess: min distance to the first point
        pc._set_timestamp(77)
    assert ppc.cellsize() == jpc.cellsize() > 0 and ppc.timestamp() == 77
    for pc in (jpc, ppc):
        pc.free()


@pytest.mark.parametrize("method", ["exact", "window"])
def test_remove_outliers_methods_match_jax(method):
    """ops.outliers.remove_outliers on a buffer: the brute force against
    the JAX brute force (md allclose, so the same survivors on this cloud),
    the window method (kernel 2's route) against the JAX XLA window."""
    from cwipc_util_tpu.ops import outliers as joutliers
    from cwipc_util_tpu_torch.ops import outliers

    pts = _generate_host(50, 50, 0.5)  # 2,500 points in capture order
    jbuf = jbuffers.buffer_from_numpy(pts, 4096)
    pbuf = port.buffer_from_numpy(pts, 4096, device="cpu")
    jout = joutliers.remove_outliers(jbuf, 12, jnp.float32(MULT), method=method)
    pout = outliers.remove_outliers(pbuf, 12, MULT, method=method)
    m = int(jout.count)
    assert int(pout.count) == m and 0 < m < len(pts)
    np.testing.assert_array_equal(pout.xyz.numpy(), np.asarray(jout.xyz))
    np.testing.assert_array_equal(pout.rgba.numpy().view(np.uint32), np.asarray(jout.rgba))
