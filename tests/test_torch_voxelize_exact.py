"""The exact-key downsample: the port's ``voxelize.downsample(exact_keys=
True)`` in both forms against the JAX package's, and ``cwipc_downsample``
on scenes 1023 cells or wider.

Equalities certified: the voxel count, every rgba word (mean colours
truncated, tile OR) and the output order are equal; centroids are allclose
with rtol 1e-6 and atol 1e-6 times the scene's half-width: both packages
sum a voxel's f32 coordinates, in an order that may differ (XLA's segment
sum against ``index_add_`` after a stable sort).  The port accepts
``merged_exact`` for the JAX signature and ignores it, so its two calls are
bit-equal; the JAX package's two forms are each held against it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cwipc_util_tpu as jcwipc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.core.buffers import PointBuffer as JaxBuffer
from cwipc_util_tpu.ops import voxelize as jvox
from cwipc_util_tpu_torch.ops import voxelize as pvox


def _wide_scene(seed=3, n=5000, half=100.0):
    """tests/test_ops.py TestWideScene: 200 m wide (4000 cells at 5 cm)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-half, half, size=(n, 3)).astype(np.float32)
    rgba = ((rng.integers(1, 3, n).astype(np.uint32) << 24)
            | rng.integers(0, 1 << 24, n, dtype=np.uint64).astype(np.uint32))
    return xyz, rgba


def _merged_scene(seed=5, n=7000):
    """tests/test_ops.py test_downsample_merged_exact_matches_full_exact:
    50 m wide (5000 cells at 1 cm), random rgba words."""
    rng = np.random.default_rng(seed)
    xyz = (rng.random((n, 3)) * 50.0 - 25.0).astype(np.float32)
    rgba = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return xyz, rgba


def _clustered_scene(seed=9, nclusters=8, per=2000, half=100.0):
    """Dense blobs 20 cm across, spread over 200 m: many points a voxel at
    5 cm, so the sums, the truncated means and the tile OR are exercised."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-half, half, (nclusters, 3))
    xyz = (np.repeat(centres, per, 0) + rng.uniform(-0.1, 0.1, (nclusters * per, 3))).astype(np.float32)
    n = xyz.shape[0]
    rgba = ((np.uint32(1) << rng.integers(0, 8, n).astype(np.uint32))
            << 24) | rng.integers(0, 1 << 24, n, dtype=np.uint64).astype(np.uint32)
    return xyz, rgba


SCENES = {"wide 5cm": (_wide_scene, 0.05, 100.0), "merged 1cm": (_merged_scene, 0.01, 25.0),
          "clusters 5cm": (_clustered_scene, 0.05, 100.0)}


def _padded(xyz, rgba, cap):
    n = xyz.shape[0]
    x = np.zeros((cap, 3), np.float32)
    r = np.zeros(cap, np.uint32)
    x[:n], r[:n] = xyz, rgba
    return x, r, n


def _both(xyz, rgba, cell, merged, cap):
    x, r, n = _padded(xyz, rgba, cap)
    jbuf = JaxBuffer(xyz=jnp.asarray(x), rgba=jnp.asarray(r), count=jnp.int32(n))
    j = jvox.downsample(jbuf, jnp.float32(cell), exact_keys=True, merged_exact=merged)
    p = pvox.downsample(port.buffer_from_arrays(x, r, n, device="cpu"), cell, exact_keys=True, merged_exact=merged)
    return (np.asarray(j.xyz), np.asarray(j.rgba), int(j.count)), p.to_numpy_arrays()


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("scene", list(SCENES))
def test_matches_jax(scene, merged):
    make, cell, half = SCENES[scene]
    xyz, rgba = make()
    (jx, jr, jn), (px, pr, pn) = _both(xyz, rgba, cell, merged, cap=1 << 15)
    assert pn == jn > 0
    np.testing.assert_array_equal(pr, jr)  # order, truncated colours and tile OR
    np.testing.assert_allclose(px[:pn], jx[:jn], rtol=1e-6, atol=1e-6 * half)
    assert not px[pn:].any() and not pr[pn:].any()
    # the voxel set is the numpy oracle's
    inv = np.float32(1.0) / np.float32(cell)
    want = np.unique(np.floor(xyz * inv).astype(np.int64), axis=0)
    assert pn == want.shape[0]


@pytest.mark.parametrize("scene", list(SCENES))
def test_merged_bit_equal_to_unmerged(scene):
    make, cell, _ = SCENES[scene]
    x, r, n = _padded(*make(), 1 << 15)
    a, b = (pvox.downsample(port.buffer_from_arrays(x, r, n, device="cpu"), cell, exact_keys=True,
                            merged_exact=m).to_numpy_arrays() for m in (True, False))
    assert a[2] == b[2]
    np.testing.assert_array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
    np.testing.assert_array_equal(a[1], b[1])


def test_out_capacity_drops_voxels():
    """Voxels past out_capacity are dropped, as in the JAX package."""
    xyz, rgba = _clustered_scene()
    x, r, n = _padded(xyz, rgba, 1 << 15)
    jbuf = JaxBuffer(xyz=jnp.asarray(x), rgba=jnp.asarray(r), count=jnp.int32(n))
    j = jvox.downsample(jbuf, jnp.float32(0.05), out_capacity=256, exact_keys=True, merged_exact=True)
    p = pvox.downsample(port.buffer_from_arrays(x, r, n, device="cpu"), 0.05, out_capacity=256,
                        exact_keys=True, merged_exact=True)
    assert int(p.count) == int(j.count) == 256 and p.capacity == 256
    np.testing.assert_array_equal(p.rgba.numpy().view(np.uint32), np.asarray(j.rgba))


def _points(xyz, rgba):
    pts = np.zeros(xyz.shape[0], port.POINT_DTYPE)
    pts["x"], pts["y"], pts["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    pts["r"], pts["g"], pts["b"] = (rgba >> 16) & 0xFF, (rgba >> 8) & 0xFF, rgba & 0xFF
    pts["tile"] = rgba >> 24
    return pts


@pytest.mark.parametrize("half,cell", [(100.0, 0.05), (200.0, 0.01)])
def test_cwipc_downsample_wide(half, cell):
    """4,000 cells (the JAX merged form) and 40,000 cells (its three-key
    form): the public op no longer raises and gives the JAX package's cloud."""
    pts = _points(*_wide_scene(seed=4, n=4000, half=half))
    jout = jcwipc.cwipc_downsample(jcwipc.cwipc_from_numpy_array(pts, 7), cell)
    pout = port.cwipc_downsample(port.cwipc_from_numpy_array(pts, 7, device="cpu"), cell)
    ja, pa = jout.get_numpy_array(), pout.get_numpy_array()
    assert pout.count() == jout.count() == 4000
    for f in ("r", "g", "b", "tile"):
        np.testing.assert_array_equal(pa[f], ja[f])
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(pa[f], ja[f], rtol=1e-6, atol=1e-6 * half)
    assert pout.timestamp() == 7 and pout.cellsize() == pytest.approx(cell)


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact-key"])
def test_tensor_cell_size_bit_equal_to_float(exact):
    """A cell size given as a 0-dim f32 tensor (as the codec computes its
    step on the device) and as a Python float: the same bits on both
    downsample forms (count, every coordinate and rgba word).  The cell is
    not an f32 number, so its rounding and 1/cell's are exercised."""
    xyz, rgba = _clustered_scene(nclusters=4, per=500, half=1.0)
    x, r, n = _padded(xyz, rgba, 4096)
    buf = port.buffer_from_arrays(x, r, n, device="cpu")
    cell = 0.0123
    a = pvox.downsample(buf, cell, exact_keys=exact).to_numpy_arrays()
    b = pvox.downsample(buf, torch.tensor(cell, dtype=torch.float32), exact_keys=exact).to_numpy_arrays()
    assert a[2] == b[2] > 100
    np.testing.assert_array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
    np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(port.CwipcError, match="0-dim"):
        pvox.downsample(buf, torch.tensor([cell]), exact_keys=exact)
