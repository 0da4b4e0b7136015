"""The rest of the public op surface: tilemap, crop, colormap and
transform44, the grid outlier method and the KD-tree route of
``cwipc_remove_outliers``, each against the JAX package on the same numpy
inputs.

Equalities certified: tilemap, crop and colormap bit-equal (whole point
records); transform44 allclose (rtol 1e-6, atol 1e-6: both run a full-f32
3x3 product, whose rounding order may differ); the grid method's md
allclose (rtol 1e-5, atol 1e-7: XLA on the CPU may contract d2 into FMAs)
and its keep mask equal; the KD-tree route keeps the same points."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cwipc_util_tpu as jcwipc
import cwipc_util_tpu_torch as port
import cwipc_util_tpu_torch.ops as port_ops
from cwipc_util_tpu.core.buffers import PointBuffer as JaxBuffer
from cwipc_util_tpu.ops import compaction as jcomp
from cwipc_util_tpu.ops import outliers as jout
from cwipc_util_tpu_torch import CwipcError
from cwipc_util_tpu_torch.ops import compaction as pcomp
from cwipc_util_tpu_torch.ops import outliers as pout


def random_points(rng, n, scale=1.0):
    """tests/test_fuzz_ops.py's random cloud."""
    arr = np.zeros(n, port.POINT_DTYPE)
    xyz = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    for ch in ("r", "g", "b"):
        arr[ch] = rng.integers(0, 256, size=n)
    arr["tile"] = rng.integers(0, 8, size=n)
    return arr


def both(arr, ts=5):
    return jcwipc.cwipc_from_numpy_array(arr, ts), port.cwipc_from_numpy_array(arr, ts, device="cpu")


@pytest.fixture(scope="module")
def synthetic():
    """The JAX synthetic source's default cloud, as test_reference_suite uses it."""
    gen = jcwipc.cwipc_synthetic()
    gen.start()
    arr = gen.get().get_numpy_array()
    gen.stop()
    return arr


def same(jpc, ppc):
    ja, pa = jpc.get_numpy_array(), ppc.get_numpy_array()
    assert ja.tobytes() == pa.tobytes()
    assert jpc.timestamp() == ppc.timestamp() and jpc.cellsize() == ppc.cellsize()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tilemap_crop_colormap_random(seed):
    rng = np.random.default_rng(seed)
    arr = random_points(rng, int(rng.integers(1, 3000)))
    jpc, ppc = both(arr)
    lut = rng.integers(0, 256, size=256).astype(np.uint8)
    same(jcwipc.cwipc_tilemap(jpc, bytes(lut)), port.cwipc_tilemap(ppc, bytes(lut)))
    same(jcwipc.cwipc_tilemap(jpc, list(lut)), port.cwipc_tilemap(ppc, list(lut)))
    bbox = sorted(rng.uniform(-1, 1, 2).tolist()) + sorted(rng.uniform(-1, 1, 2).tolist()) + sorted(
        rng.uniform(-1, 1, 2).tolist())
    same(jcwipc.cwipc_crop(jpc, bbox), port.cwipc_crop(ppc, bbox))
    clear, setb = int(rng.integers(0, 2**32)), int(rng.integers(0, 2**32))
    same(jcwipc.cwipc_colormap(jpc, clear, setb), port.cwipc_colormap(ppc, clear, setb))


def test_reference_suite_cases(synthetic):
    """tests/test_reference_suite.py's tilemap, colormap and crop cases."""
    jpc, ppc = both(synthetic)
    same(jcwipc.cwipc_tilemap(jpc, {1: 5, 2: 6}), port.cwipc_tilemap(ppc, {1: 5, 2: 6}))
    pc2 = port.cwipc_colormap(ppc, 0xFFFFFFFF, 0x010203)
    same(jcwipc.cwipc_colormap(jpc, 0xFFFFFFFF, 0x010203), pc2)
    a = pc2.get_numpy_array()
    assert (a["r"] == 1).all() and (a["g"] == 2).all() and (a["b"] == 3).all() and (a["tile"] == 0).all()
    for box in ([-999, 0, -999, 999, -999, 999], [0, 999, -999, 999, -999, 999], (-0.1, 0.1, 0.5, 1.0, -0.2, 0.2)):
        same(jcwipc.cwipc_crop(jpc, box), port.cwipc_crop(ppc, box))


def test_tilemap_errors():
    _, ppc = both(random_points(np.random.default_rng(4), 100))
    with pytest.raises(CwipcError):
        port.cwipc_tilemap(ppc, {300: 1})
    with pytest.raises(CwipcError):
        port.cwipc_tilemap(ppc, {1: -1})
    with pytest.raises(CwipcError):
        port.cwipc_tilemap(ppc, bytes(255))


def test_colormap_copies_metadata():
    _, ppc = both(random_points(np.random.default_rng(6), 100))
    ppc.access_metadata()._add("test-angle", "k=v", b"\x01\x02")
    out = port.cwipc_colormap(ppc, 0, 0xFF)
    md = out.access_metadata()
    assert md.count() == 1 and md.name(0) == "test-angle" and md.data(0) == b"\x01\x02"
    assert port.cwipc_crop(ppc, [-1, 1, -1, 1, -1, 1])._metadata is None


def test_padding_reads_zero():
    """Slots past the count are zero after tilemap and colormap."""
    arr = random_points(np.random.default_rng(8), 100)
    buf = port.buffer_from_numpy(arr, device="cpu")
    buf.rgba[100:] = -1
    for out in (pcomp.tilemap(buf, list(range(256))), pcomp.colormap(buf, 0, 0xFFFFFFFF)):
        assert not out.rgba[100:].any() and int(out.count) == 100


def test_transform44(synthetic):
    rng = np.random.default_rng(12)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.identity(4)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-1, 1, 3)
    buf = port.buffer_from_numpy(synthetic, device="cpu")
    xyz, rgba, n = buf.to_numpy_arrays()
    jbuf = JaxBuffer(xyz=jnp.asarray(xyz), rgba=jnp.asarray(rgba), count=jnp.int32(n))
    j = jcomp.transform44(jbuf, jnp.asarray(m, jnp.float32))
    p = pcomp.transform44(buf, m)
    np.testing.assert_allclose(p.xyz.numpy(), np.asarray(j.xyz), rtol=1e-6, atol=1e-6)
    assert torch.equal(p.rgba, buf.rgba) and int(p.count) == n
    assert not p.xyz[n:].any()


@pytest.fixture(scope="module")
def downsampled():
    """The synthetic body at 20k points downsampled at c = 2 cm."""
    gen = jcwipc.cwipc_synthetic(0, 20000)
    gen.start()
    pc = jcwipc.cwipc_downsample(gen.get(), 0.02)
    gen.stop()
    return pc.get_numpy_array()


def test_grid_method(downsampled):
    """md allclose and keep equal to the JAX _mean_knn_dist_grid at cell 3c,
    cap 32, k 12; remove_outliers(method="grid") keeps the same points."""
    cell, k, mult = 0.06, 12, 1.0
    buf = port.buffer_from_numpy(downsampled, device="cpu")
    xyz, rgba, n = buf.to_numpy_arrays()
    assert n > 1000
    jbuf = JaxBuffer(xyz=jnp.asarray(xyz), rgba=jnp.asarray(rgba), count=jnp.int32(n))
    jmd = np.asarray(jout._mean_knn_dist_grid(jbuf.xyz, jbuf.count, jnp.float32(cell), k, cell_cap=32))
    pmd = pout._mean_knn_dist_grid(buf.xyz, buf.count, cell, k, cell_cap=32)
    np.testing.assert_allclose(pmd.numpy(), jmd, rtol=1e-5, atol=1e-7)
    valid = buf.valid_mask()
    jkeep = np.asarray(jout._keep_from_mean_dists(jnp.asarray(jmd), jnp.asarray(valid.numpy()), jnp.float32(mult)))
    pkeep = pout._keep_from_mean_dists(pmd, valid, mult)
    np.testing.assert_array_equal(pkeep.numpy(), jkeep)
    jres = jout.remove_outliers(jbuf, k, jnp.float32(mult), method="grid", cell=jnp.float32(cell), cell_cap=32)
    pres = pout.remove_outliers(buf, k, mult, method="grid", cell=cell, cell_cap=32)
    assert int(pres.count) == int(jres.count) < n
    np.testing.assert_array_equal(pres.xyz.numpy(), np.asarray(jres.xyz))
    # JAX's parameter order: a caller passing cell and cell_cap by position
    ppos = pout.remove_outliers(buf, k, mult, "grid", cell, 32)
    np.testing.assert_array_equal(ppos.xyz.numpy(), pres.xyz.numpy())
    assert (list(inspect.signature(pout.remove_outliers).parameters)
            == list(inspect.signature(jout.remove_outliers).parameters))
    with pytest.raises(ValueError):
        pout.remove_outliers(buf, k, mult, method="grid")


@pytest.mark.parametrize("per_tile", [False, True])
def test_kdtree_route(monkeypatch, per_tile):
    """A cloud of more than 4,096 points with no column grid: the host
    cKDTree route keeps what the JAX package's CPU route (a cKDTree) keeps."""
    gen = jcwipc.cwipc_synthetic(0, 40000)
    gen.start()
    arr = jcwipc.cwipc_downsample(gen.get(), 0.008).get_numpy_array()
    gen.stop()
    assert len(arr) > 4096
    calls = []

    def no_grid(*a, **kw):
        calls.append(a[1])
        return None

    monkeypatch.setattr(port_ops, "_cols_grid_params", no_grid)
    jpc, ppc = both(arr)
    want = jcwipc.cwipc_remove_outliers(jpc, 30, 1.0, per_tile)
    got = port.cwipc_remove_outliers(ppc, 30, 1.0, per_tile)
    assert calls, "the column-grid choice was not consulted"
    same(want, got)
    assert got.count() < len(arr)
