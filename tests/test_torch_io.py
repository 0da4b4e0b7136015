"""Slice parity: the port's cloud I/O and the rest of the cloud wrapper
against the JAX package, on the CPU.

Equalities asserted: PLY files (binary and ascii), cwipcdump files and
packets written by the two packages are equal byte for byte, and each
package reads the other's into equal point records, timestamps and cell
sizes; ``parse_skeleton_collection`` gives equal fields; the native twin
of ``as_cwipc_p`` reads back equal points through the native getters.
Every cloud is made from a seed with numpy, with tiles of 0x80 and above.
"""

import ctypes
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

import cwipc_util_tpu as jcwipc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu import util as jutil
from cwipc_util_tpu_torch import util as putil

N = 600


def _points(n=N, seed=11):
    rng = np.random.default_rng(seed)
    pts = np.zeros(n, port.POINT_DTYPE)
    for f in ("x", "y", "z"):
        pts[f] = (rng.standard_normal(n) * 0.7).astype(np.float32)
    for f in ("r", "g", "b"):
        pts[f] = rng.integers(0, 256, n)
    pts["tile"] = rng.choice(np.array([1, 2, 0x80, 0x81, 0xFF], np.uint8), n)
    return pts


def _pair(pts, ts=1234, cellsize=0.25):
    j = jcwipc.cwipc_from_numpy_array(pts, ts)
    p = port.cwipc_from_numpy_array(pts, ts, device="cpu")
    j._set_cellsize(cellsize)
    p._set_cellsize(cellsize)
    return j, p


@pytest.mark.parametrize("flags", [0, 1], ids=["ascii", "binary"])
def test_ply_written_by_either_package_reads_in_the_other(tmp_path, flags):
    """Equal file bytes; each package reads the other's file into equal records."""
    pts = _points()
    j, p = _pair(pts)
    jf, pf = tmp_path / "j.ply", tmp_path / "p.ply"
    assert port.CWIPC_FLAGS_BINARY == jcwipc.CWIPC_FLAGS_BINARY == 1
    jcwipc.cwipc_write(str(jf), j, flags)
    port.cwipc_write(str(pf), p, flags)
    assert jf.read_bytes() == pf.read_bytes()
    got = port.cwipc_read(str(jf), 99, device="cpu")
    assert got._device.type == "cpu" and got.timestamp() == 99
    np.testing.assert_array_equal(got.get_numpy_array(), pts)
    np.testing.assert_array_equal(jcwipc.cwipc_read(str(pf), 99).get_numpy_array(), pts)


def test_ply_read_superset_agrees(tmp_path):
    """A foreign layout (double xyz, packed rgba, a face element before the
    vertices) reads into equal records in both packages."""
    pts = _points(40)
    rgba = ((pts["tile"].astype(np.uint32) << 24) | (pts["r"].astype(np.uint32) << 16)
            | (pts["g"].astype(np.uint32) << 8) | pts["b"].astype(np.uint32))
    body = np.zeros(40, [("x", "<f8"), ("y", "<f8"), ("z", "<f8"), ("rgba", "<u4")])
    for f in "xyz":
        body[f] = pts[f]
    body["rgba"] = rgba
    hdr = ("ply\nformat binary_little_endian 1.0\nelement face 1\nproperty uchar a\n"
           "element vertex 40\nproperty double x\nproperty double y\nproperty double z\n"
           "property uint rgba\nend_header\n").encode()
    f = tmp_path / "foreign.ply"
    f.write_bytes(hdr + b"\x07" + body.tobytes())
    mine = port.cwipc_read(str(f), 0, device="cpu").get_numpy_array()
    np.testing.assert_array_equal(mine, jcwipc.cwipc_read(str(f), 0).get_numpy_array())
    np.testing.assert_array_equal(mine, pts)


def test_packets_and_dumps_cross_read(tmp_path):
    """Equal packet and dump bytes; each package reads the other's."""
    pts = _points()
    j, p = _pair(pts, ts=777, cellsize=0.125)
    jpk, ppk = bytes(j.get_packet()), bytes(p.get_packet())
    assert jpk == ppk
    assert port.CWIPC_CWIPCDUMP_HEADER == jcwipc.CWIPC_CWIPCDUMP_HEADER
    assert port.CWIPC_CWIPCDUMP_VERSION == jcwipc.CWIPC_CWIPCDUMP_VERSION
    for reader, packet in ((port.cwipc_from_packet, jpk), (jcwipc.cwipc_from_packet, ppk)):
        kw = {"device": "cpu"} if reader is port.cwipc_from_packet else {}
        got = reader(packet, **kw)
        assert (got.timestamp(), got.cellsize()) == (777, 0.125)
        np.testing.assert_array_equal(got.get_numpy_array(), pts)
    jf, pf = tmp_path / "j.cwipcdump", tmp_path / "p.cwipcdump"
    jcwipc.cwipc_write_debugdump(str(jf), j)
    port.cwipc_write_debugdump(str(pf), p)
    assert jf.read_bytes() == pf.read_bytes() == jpk
    np.testing.assert_array_equal(port.cwipc_read_debugdump(str(jf), device="cpu").get_numpy_array(), pts)
    np.testing.assert_array_equal(jcwipc.cwipc_read_debugdump(str(pf)).get_numpy_array(), pts)
    with pytest.raises(port.CwipcError, match="bad header"):
        port.cwipc_from_packet(b"xxxx" + ppk[4:], device="cpu")
    with pytest.raises(port.CwipcError, match="inconsistent size"):
        port.cwipc_from_packet(ppk[:-3], device="cpu")
    with pytest.raises(port.CwipcError, match="cwipc_read_debugdump"):
        port.cwipc_read_debugdump(str(tmp_path / "missing.cwipcdump"), device="cpu")


def test_converters_and_constants_agree():
    """cwipc_from_points (tuples, bytes, a point array), the o3d converter
    on a duck-typed cloud, the version and the API constants."""
    tuples = [(1.0, 2.0, 3.0, 10, 20, 30, 0x81), (4.0, 5.0, 6.0, 40, 50, 60, 2)]
    j = jcwipc.cwipc_from_points(tuples, 5).get_numpy_array()
    for values in (tuples, bytes(port.cwipc_point_array(values=tuples)), port.cwipc_point_array(values=tuples)):
        np.testing.assert_array_equal(port.cwipc_from_points(values, 5, device="cpu").get_numpy_array(), j)

    class Duck:
        points = np.array([[0.5, 1.0, -1.0], [2.0, 0.0, 0.25]])
        colors = np.array([[0.1, 0.5, 0.99], [0.0, 1.0 - 1e-9, 0.25]])

    np.testing.assert_array_equal(port.cwipc_from_o3d_pointcloud(Duck, 3, device="cpu").get_numpy_array(),
                                  jcwipc.cwipc_from_o3d_pointcloud(Duck, 3).get_numpy_array())
    assert port.cwipc_get_version() == jcwipc.cwipc_get_version()
    for name in ("CWIPC_API_VERSION", "CWIPC_POINT_PACKETHEADER_MAGIC"):
        assert getattr(port, name) == getattr(jcwipc, name)
    assert port.cwipc_point_numpy_dtype == jcwipc.cwipc_point_numpy_dtype


def test_skeleton_collection_parses_alike():
    rng = np.random.default_rng(3)
    n_sk, n_j = 2, 5
    joints = np.zeros(n_sk * n_j, [("confidence", "<u4")] + [(f, "<f4") for f in
                                                               ("x", "y", "z", "q_w", "q_x", "q_y", "q_z")])
    joints["confidence"] = rng.integers(0, 4, n_sk * n_j)
    for f in joints.dtype.names[1:]:
        joints[f] = rng.standard_normal(n_sk * n_j)
    blob = np.array([n_sk, n_j], "<u4").tobytes() + joints.tobytes()
    pn, pj, pjoints = port.parse_skeleton_collection(blob)
    jn, jj, jjoints = jcwipc.parse_skeleton_collection(blob)
    assert (pn, pj) == (jn, jj) == (n_sk, n_j)
    fields = [f for f, _ in port.cwipc_skeleton_joint._fields_]
    assert fields == [f for f, _ in jcwipc.cwipc_skeleton_joint._fields_] == list(joints.dtype.names)
    for a, b in zip(pjoints, jjoints):
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]


def test_as_cwipc_p_reads_back_through_native_getters():
    """The port's native twin (its own build of the shim) holds the points,
    timestamp and cell size; detach hands it on (test_parity_surface.py's
    handoff test)."""
    pts = _points(50)
    _, pc = _pair(pts, ts=4321, cellsize=0.5)
    handle = pc.as_cwipc_p()
    assert handle and pc.as_cwipc_p() is handle
    dll = putil.cwipc_util_dll_load()
    assert os.path.dirname(dll._name) == str(putil.NATIVE_BUILD)
    dll.cwipc_pointcloud_count.restype = ctypes.c_int
    dll.cwipc_pointcloud_count.argtypes = [ctypes.c_void_p]
    dll.cwipc_pointcloud_timestamp.restype = ctypes.c_uint64
    dll.cwipc_pointcloud_timestamp.argtypes = [ctypes.c_void_p]
    dll.cwipc_pointcloud_cellsize.restype = ctypes.c_float
    dll.cwipc_pointcloud_cellsize.argtypes = [ctypes.c_void_p]
    dll.cwipc_pointcloud_copy_uncompressed.restype = ctypes.c_int
    dll.cwipc_pointcloud_copy_uncompressed.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    assert dll.cwipc_pointcloud_count(handle) == 50
    assert dll.cwipc_pointcloud_timestamp(handle) == 4321
    assert dll.cwipc_pointcloud_cellsize(handle) == 0.5
    back = np.zeros(50, port.POINT_DTYPE)
    assert dll.cwipc_pointcloud_copy_uncompressed(handle, back.ctypes.data, back.nbytes) == 50
    np.testing.assert_array_equal(back, pts)
    detached = pc.detach()
    assert pc._native_handle is None and detached._native_handle is handle
    assert detached._device.type == "cpu"
    np.testing.assert_array_equal(detached.get_numpy_array(), pts)
    detached.free()
    assert detached._native_handle is None


def test_native_loader_builds_its_own_library(monkeypatch, tmp_path):
    """The shim builds into the port's _build/native/ and never into the
    JAX package's native/build/; without make the build raises."""
    lib = putil.build_native()
    assert lib == putil.NATIVE_BUILD / putil.LIBNAME and lib.exists()
    assert putil.NATIVE_SRC == pathlib.Path(jutil.__file__).parent / "native"
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(putil, "NATIVE_BUILD", tmp_path / "native")
    with pytest.raises(port.CwipcError, match="make"):
        putil.build_native()
    assert not (tmp_path / "native").exists()


def test_open3d_gate():
    """open3d is optional: the accessor imports it only when called."""
    pc = port.cwipc_from_points([(0.0, 0.0, 0.0, 1, 2, 3, 1)], 0, device="cpu")
    try:
        import open3d  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            pc.get_o3d_pointcloud()
    else:
        assert len(pc.get_o3d_pointcloud().points) == 1


def test_vectors_agree():
    from cwipc_util_tpu.utils import vectors as jvec
    from cwipc_util_tpu_torch.utils import vectors as pvec

    a, b = (1.5, -2.0, 0.25), (0.5, 4.0, -3.0)
    for name in ("add_vectors", "diff_vectors", "dot_vectors", "cross_vectors"):
        assert getattr(pvec, name)(a, b) == getattr(jvec, name)(a, b)
    for name in ("len_vector", "norm_vector", "euclidean_length", "unit_vector"):
        assert getattr(pvec, name)(a) == getattr(jvec, name)(a)
    assert pvec.mult_vector(3.0, a) == jvec.mult_vector(3.0, a)


_ISOLATED = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cwipc_util_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import cwipc_util_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, "cwipc_util_tpu_torch."):
    importlib.import_module(info.name)
from cwipc_util_tpu_torch import codec
import numpy as np
pts = np.zeros(500, port.POINT_DTYPE)
pts["x"] = np.linspace(0, 1, 500, dtype=np.float32)
pts["tile"] = 0x81
enc = codec.cwipc_new_encoder()
enc.feed(port.cwipc_from_numpy_array(pts, 1, device="cpu"))
dec = codec.cwipc_new_decoder(device="cpu")
dec.feed(enc.get_bytes())
out = dec.get()
assert out.count() > 0 and (out.get_numpy_array()["tile"] == 0x81).all()
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cwipc_util_tpu")]
print("isolated ok", len(sys.modules))
"""


def test_port_imports_and_encodes_where_jax_cannot_be_imported():
    """Every module of the port imports, and a cloud round-trips the codec,
    in a process where jax and the JAX package cannot be imported."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    rv = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=root, env=env, capture_output=True, text=True,
                        timeout=120)
    assert rv.returncode == 0, rv.stderr[-2000:]
    assert "isolated ok" in rv.stdout
