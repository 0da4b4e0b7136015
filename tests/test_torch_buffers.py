"""Port core parity: buffers, converters, rgba packing, the synthetic
generator, the package's import boundary and the kernel loader."""

import ast
import pathlib

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cwipc_util_tpu_torch as port
from cwipc_util_tpu.core import buffers as jbuffers
from cwipc_util_tpu.models import synthetic as jsynthetic
from cwipc_util_tpu_torch import _kernels
from cwipc_util_tpu_torch.core import buffers as pbuffers
from cwipc_util_tpu_torch.models import synthetic as psynthetic
from cwipc_util_tpu_torch.ops.compact_kernel import compact_kernel_cm
from cwipc_util_tpu_torch.ops.segment_reduce import segment_reduce_sorted
from cwipc_util_tpu_torch.ops.window_knn import window_knn_mean_distance_cm

PKG = pathlib.Path(port.__file__).parent


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = np.zeros(n, pbuffers.POINT_DTYPE)
    for f in ("x", "y", "z"):
        pts[f] = rng.standard_normal(n).astype(np.float32)
    for f in ("r", "g", "b", "tile"):
        pts[f] = rng.integers(0, 256, n)
    return pts


@pytest.mark.parametrize("n,capacity", [(1000, None), (0, None), (4096, 8192)])
def test_numpy_roundtrip(n, capacity):
    """numpy -> port buffer -> numpy and bytes -> buffer -> bytes are
    identities, and the padding is zero."""
    pts = _points(n, n)
    buf = port.buffer_from_numpy(pts, capacity=capacity, device="cpu")
    assert buf.capacity == (capacity or pbuffers.bucket_capacity(n))
    assert int(buf.count) == n
    assert buf.rgba.dtype == torch.int32 and buf.xyz.dtype == torch.float32
    back = port.buffer_to_numpy(buf)
    assert back.tobytes() == pts.tobytes()
    assert not buf.xyz[n:].any() and not buf.rgba[n:].any()
    again = port.buffer_from_bytes(port.buffer_to_bytes(buf), device="cpu")
    assert bytes(port.buffer_to_bytes(again)) == pts.tobytes()


def test_state_from_jax_buffer():
    """The JAX buffer's fields, as numpy, build the same cloud in the port,
    and to_numpy_arrays hands back exactly those arrays."""
    pts = _points(3000, 7)
    jb = jbuffers.buffer_from_numpy(pts)
    xyz, rgba, count = np.asarray(jb.xyz), np.asarray(jb.rgba), int(jb.count)
    pb = port.buffer_from_arrays(xyz, rgba, count, device="cpu")
    got_xyz, got_rgba, got_count = pb.to_numpy_arrays()
    assert got_rgba.dtype == np.uint32
    np.testing.assert_array_equal(got_xyz.view(np.uint32), xyz.view(np.uint32))
    np.testing.assert_array_equal(got_rgba, rgba)
    assert got_count == count
    assert port.buffer_to_numpy(pb).tobytes() == jbuffers.buffer_to_numpy(jb).tobytes()
    assert pb.capacity == jb.capacity
    np.testing.assert_array_equal(pb.valid_mask().numpy(), np.asarray(jb.valid_mask()))


def test_pack_rgba_bit_patterns():
    """pack_rgba/unpack_rgba give the JAX package's uint32 bit pattern,
    tile 255 (the sign bit of the int32 carrier) included."""
    rng = np.random.default_rng(3)
    ch = rng.integers(0, 256, (4, 500)).astype(np.int32)
    ch[:, :2] = 255
    ch[3, 2] = 128
    ch[:, 3] = 0
    want = np.asarray(jbuffers.pack_rgba(*(jnp.asarray(c) for c in ch)))
    got = pbuffers.pack_rgba(*(torch.from_numpy(c) for c in ch))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert got.numpy().view(np.uint32)[0] == 0xFFFFFFFF
    for a, b in zip(pbuffers.unpack_rgba(got), ch):
        np.testing.assert_array_equal(a.numpy(), b)


def test_generate_host_equals_jax_twin():
    """The copied numpy generator is bit-equal to the JAX package's."""
    for hsteps, angle in ((100, 0.5), (37, 2.25)):
        a = psynthetic._generate_host(hsteps, hsteps, angle)
        b = jsynthetic._generate_host(hsteps, hsteps, angle)
        assert a.tobytes() == b.tobytes()


def test_generate_torch_matches_host_twin():
    """The torch generator draws the same body; trig may differ in the final
    ulps, so coordinates are allclose and colors within one step."""
    h = 120
    buf = psynthetic._generate(h, h, 16384, 0.5, "cpu")
    host = psynthetic._generate_host(h, h, 0.5)
    got = port.buffer_to_numpy(buf)
    assert got.shape == host.shape
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(got[f], host[f], atol=2e-6)
    for f in ("r", "g", "b"):
        assert np.abs(got[f].astype(int) - host[f].astype(int)).max() <= 1
    mismatch = (got["tile"] != host["tile"]).sum()
    assert mismatch <= 2  # only where z rounds across 0


def test_synthetic_source_and_wrapper():
    src = port.cwipc_synthetic(0, 10000, device="cpu")
    assert src.start()
    before = port.cwipc_dangling_allocations(False)
    pc = src.get()
    src.stop()
    assert pc.count() == 10000
    assert pc.cellsize() == pytest.approx(2.0 / 100)
    assert len(pc.get_bytes()) == 16 * 10000
    assert len(pc.get_points()) == 10000
    clone = pc.clone()
    assert clone.get_numpy_array().tobytes() == pc.get_numpy_array().tobytes()
    assert pc._access_buffer().device == torch.device("cpu")
    assert port.cwipc_dangling_allocations(False) == before + 2
    clone.free()
    pc.free()
    assert port.cwipc_dangling_allocations(False) == before
    with pytest.raises(port.CwipcError):
        pc._access_buffer()


def test_default_device_needs_cuda(monkeypatch):
    """Without CUDA, an unnamed device raises instead of using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(port.CwipcError, match="no CUDA device"):
        pbuffers.resolve_device(None)
    with pytest.raises(port.CwipcError):
        port.cwipc_synthetic(0, 1000)
    with pytest.raises(port.CwipcError):
        port.buffer_from_numpy(_points(10, 1))
    assert pbuffers.resolve_device("cpu") == torch.device("cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_package_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package; the walk covers every subpackage, registration/ and filters/
    included."""
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    assert {"core", "ops", "filters", "registration", "utils"} <= {p.parent.name for p in files}
    files.append(PKG.parent / "chip_smoke.py")
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "cwipc_util_tpu"), f"{path}: imports {mod}"


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc anywhere, the build raises; it does not fall back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_kernels, "NVCC_FALLBACK_DIRS", (str(tmp_path / "none"),))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_lib", None)
    with pytest.raises(port.CwipcError, match="nvcc"):
        _kernels.load()
    assert _kernels._lib is None
    assert not (tmp_path / "build").exists()


def test_wrappers_check_arguments():
    """Wrong dtype, shape or device raise; a device with no kernel raises
    rather than falling back to the plain version."""
    i32 = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(port.CwipcError, match="dtype"):
        segment_reduce_sorted(i32.float(), i32, i32, 16)
    with pytest.raises(port.CwipcError, match="shape"):
        segment_reduce_sorted(i32, i32[:10], i32, 16)
    meta = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(port.CwipcError, match="no kernel"):
        segment_reduce_sorted(meta, meta, meta, 16)
    f = torch.zeros(64)
    with pytest.raises(port.CwipcError, match="contiguous"):
        compact_kernel_cm(torch.zeros(128)[::2], f, f, i32, i32 > 0, torch.tensor(3, dtype=torch.int32))
    before = (segment_reduce_sorted.launches, compact_kernel_cm.launches)
    compact_kernel_cm(f, f, f, i32, i32 > 0, torch.tensor(3, dtype=torch.int32))
    assert (segment_reduce_sorted.launches, compact_kernel_cm.launches) == before


def test_window_knn_wrapper_checks_arguments():
    """Kernel 2's one-pass checks raise on what the per-argument checks
    raised on: a wrong dtype, shape, contiguity, count, window or device."""
    f = torch.zeros(64)
    c = torch.tensor(60, dtype=torch.int32)
    cases = [
        ("dtype", (f.double(), f, f, c, 30, 16)),
        ("shape", (f, f[:10], f, c, 30, 16)),
        ("contiguous", (f, torch.zeros(128)[::2], f, c, 30, 16)),
        ("count has dtype", (f, f, f, c.long(), 30, 16)),
        ("count has shape", (f, f, f, c[None], 30, 16)),
        ("window", (f, f, f, c, 30, 33)),
        ("window", (f, f, f, c, 0, 16)),
        ("several devices", (f, f, f, torch.zeros((), dtype=torch.int32, device="meta"), 30, 16)),
        ("several devices", (f, f.to("meta"), f, c, 30, 16)),
    ]
    meta = f.to("meta")
    cases.append(("no kernel", (meta, meta, meta, c.to("meta"), 30, 16)))
    for match, args in cases:
        with pytest.raises(port.CwipcError, match=match):
            window_knn_mean_distance_cm(*args)
    before = window_knn_mean_distance_cm.launches
    assert window_knn_mean_distance_cm(f, f, f, c, 30, 16).shape == (64,)
    assert window_knn_mean_distance_cm.launches == before
