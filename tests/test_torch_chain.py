"""Slice parity: the port's downsample, fused chain and public wrappers
against the JAX package, on the CPU, fed the same numpy synthetic cloud.

* Downsample: bit-equal to the JAX chip path (the Pallas reduce, here in
  interpret mode), allclose to the JAX XLA CPU path.  The two JAX paths
  round differently: the chip path builds (v + sum(frac)/cnt) * cell from
  exact sums, the CPU path sums f32 (v + frac) * cell per point, which
  drifts by up to ~1e-6 on the 2.0-high axis (XLA_ATOL below).
* Chain: the window kNN md is allclose (summation order), so a point's keep
  decision may flip only where its md lies within 1e-5 * thr of the
  threshold; the output otherwise matches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cwipc_util_tpu as jport
from cwipc_util_tpu.core import buffers as jbuffers
from cwipc_util_tpu.ops import chain as jchain
from cwipc_util_tpu.ops import outliers as joutliers
from cwipc_util_tpu.ops import voxelize as jvoxelize
import cwipc_util_tpu_torch as port
from cwipc_util_tpu_torch.models.synthetic import _generate_host
from cwipc_util_tpu_torch.ops import chain, outliers, voxelize

H = 200  # 40,000 points
CAP = 1 << 16
CELL = 2.0 / H * 2.0  # bench.py's ratio: cells of two point spacings
OCAP = 12288
EXTENT = 2.0  # the body's height, its widest axis
# The XLA CPU path sums f32 (v + frac) * cell per point; on this cloud its
# centroids sit up to 1.07e-6 from the port's (and 1.0e-6 from a float64
# reference), on the 2.0-high y axis only.
XLA_ATOL = 1e-6 * EXTENT


@pytest.fixture(scope="module")
def cloud():
    pts = _generate_host(H, H, 0.5)
    return pts, jbuffers.buffer_from_numpy(pts, CAP), port.buffer_from_numpy(pts, CAP, device="cpu")


@pytest.fixture(scope="module")
def port_down(cloud):
    return voxelize.downsample_cm(cloud[2], CELL, OCAP)


def _bits(t):
    return np.asarray(t).view(np.uint32)


def test_downsample_bit_equal_to_jax_chip_path(cloud, port_down, monkeypatch):
    """The JAX package's own front and sort, with the platform dispatch's
    CPU branch pointed at the chip path's reduce (_reduce_runs_pallas_cm,
    whose Pallas kernel runs in interpret mode on the CPU)."""
    monkeypatch.setattr(jvoxelize, "_reduce_runs_xla_cm", jvoxelize._reduce_runs_pallas_cm)
    jx, jy, jz, jrgba, jcnt = jvoxelize.downsample_cm(cloud[1], jnp.float32(CELL), OCAP)
    x, y, z, rgba, cnt = port_down
    assert int(cnt) == int(jcnt) > 1000
    for mine, theirs in ((x, jx), (y, jy), (z, jz)):
        np.testing.assert_array_equal(_bits(mine.numpy()), _bits(theirs))
    np.testing.assert_array_equal(_bits(rgba.numpy()), np.asarray(jrgba))


def test_downsample_allclose_to_jax_xla_path(cloud, port_down):
    jx, jy, jz, jrgba, jcnt = jvoxelize.downsample_cm(cloud[1], jnp.float32(CELL), OCAP)
    x, y, z, rgba, cnt = port_down
    assert int(cnt) == int(jcnt)
    for mine, theirs in ((x, jx), (y, jy), (z, jz)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=0, atol=XLA_ATOL)
    np.testing.assert_array_equal(_bits(rgba.numpy()), np.asarray(jrgba))


def test_downsample_centroids_match_float64(cloud, port_down):
    """Each centroid is within 1e-7 * extent of the float64 mean of its
    voxel's quantized points: the port (like the JAX chip path) rounds a
    few times per voxel, where the XLA path rounds once per point."""
    pts = cloud[0]
    cell = np.float32(CELL)
    inv = np.float32(1.0) / cell
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1)
    v = np.floor(xyz * inv).astype(np.int64)
    q = np.clip(((xyz * inv - v.astype(np.float32)) * np.float32(1024)).astype(np.int32), 0, 1023)
    exact = (v + (q + 0.5) / 1024.0) * np.float64(cell)
    cells, which = np.unique(v, axis=0, return_inverse=True)
    which = which.ravel()
    n = np.bincount(which)
    mean = np.stack([np.bincount(which, exact[:, a]) / n for a in range(3)], -1)
    x, y, z, rgba, cnt = port_down
    m = int(cnt)
    got = torch.stack([x, y, z], -1).numpy()[:m]
    gv = np.floor(got.astype(np.float64) / np.float64(cell)).astype(np.int64)
    lookup = {tuple(c): i for i, c in enumerate(cells)}
    idx = np.array([lookup[tuple(c)] for c in gv])
    assert len(set(idx.tolist())) == m == len(cells)
    np.testing.assert_allclose(got, mean[idx], rtol=0, atol=1e-7 * EXTENT)


def test_chain_matches_jax_cpu_chain(cloud, port_down):
    k, window, mult, tile = 30, 16, 1.0, 1
    jout = jchain.downsample_outliers_tilefilter(
        cloud[1], jnp.float32(CELL), k=k, mult=jnp.float32(mult), tile=jnp.uint32(tile),
        window=window, out_capacity=OCAP,
    )
    pout = chain.downsample_outliers_tilefilter(
        cloud[2], CELL, k=k, mult=mult, tile=tile, window=window, out_capacity=OCAP
    )
    # keep decisions on both sides, from the same downsampled rows
    x, y, z, rgba, cnt = port_down
    n = int(cnt)
    valid = torch.arange(OCAP) < n
    md = outliers._mean_knn_dist_window(torch.stack([x, y, z], -1), cnt, k, window)
    jmd = np.asarray(joutliers._mean_knn_dist_window(
        jnp.asarray(torch.stack([x, y, z], -1).numpy()), jnp.int32(n), k, window=window))
    np.testing.assert_allclose(md.numpy(), jmd, rtol=1e-6, atol=0)
    mdv = md.numpy()[:n].astype(np.float64)
    thr = float(outliers._threshold(mult, valid.sum(dtype=torch.float32), md.sum(), (md * md).sum()))
    in_tile = ((rgba.numpy()[:n].view(np.uint32) >> 24) & 0xFF) == tile
    keep = chain.keep_mask(md, rgba, cnt, mult, tile).numpy()[:n]
    jkeep = (jmd[:n] <= thr) & in_tile
    flips = keep != jkeep
    assert np.all(np.abs(mdv[flips] - thr) <= 1e-5 * thr)
    assert int(pout.count) == int(keep.sum())
    assert abs(int(pout.count) - int(jout.count)) <= flips.sum()
    if not flips.any():
        m = int(jout.count)
        assert int(pout.count) == m
        np.testing.assert_array_equal(_bits(pout.rgba.numpy()), np.asarray(jout.rgba))
        np.testing.assert_allclose(pout.xyz.numpy(), np.asarray(jout.xyz), rtol=0, atol=XLA_ATOL)
        assert not pout.xyz[m:].any()


def test_public_wrappers_match_jax(cloud):
    """cwipc_downsample and cwipc_tilefilter through the wrapper objects."""
    pts = cloud[0]
    jpc = jport.cwipc_from_numpy_array(pts, 1234)
    ppc = port.cwipc_pointcloud_wrapper(None, 1234, 0.0, _host_points=pts.copy(), device="cpu")
    jdown = jport.cwipc_downsample(jpc, CELL)
    pdown = port.cwipc_downsample(ppc, CELL)
    assert pdown.count() == jdown.count()
    assert pdown.cellsize() == jdown.cellsize() and pdown.timestamp() == 1234
    a, b = pdown.get_numpy_array(), jdown.get_numpy_array()
    for f in ("r", "g", "b", "tile"):
        np.testing.assert_array_equal(a[f], b[f])
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=XLA_ATOL)
    for tile in (0, 2):
        jt = jport.cwipc_tilefilter(jdown, tile)
        pt = port.cwipc_tilefilter(pdown, tile)
        assert pt.count() == jt.count()
        b = jt.get_numpy_array()
        a = pt.get_numpy_array()
        np.testing.assert_array_equal(a[["r", "g", "b", "tile"]], b[["r", "g", "b", "tile"]])
        for f in ("x", "y", "z"):
            np.testing.assert_allclose(a[f], b[f], rtol=0, atol=XLA_ATOL)
        pt.free()
        jt.free()
    # a scene 1023 cells wide takes the exact-key path in both packages:
    # the same voxels and colours, centroids within the same tolerance
    jwide = jport.cwipc_downsample(jpc, 2.0 / 1100)
    pwide = port.cwipc_downsample(ppc, 2.0 / 1100)
    a, b = pwide.get_numpy_array(), jwide.get_numpy_array()
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a[["r", "g", "b", "tile"]], b[["r", "g", "b", "tile"]])
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=XLA_ATOL)
    for pc in (jpc, ppc, jdown, pdown, jwide, pwide):
        pc.free()
