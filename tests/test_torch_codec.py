"""Slice parity: the port's codec and its in-process sinks against the JAX
package, on the CPU.

The JAX device program runs jitted on the CPU with its chip path's
downsample reduce (``_reduce_runs_pallas_cm``, the Pallas kernel 1 in
interpret mode) in place of the CPU path's XLA reduce: the port mirrors
the chip path, whose centroids the XLA path rounds differently.  jax's
caches are cleared around that patch, so no trace of either form reaches
another test.  Each test states the equality it asserts.  The clouds are
made from a seed with numpy (the synthetic body, 8,100 points), with a
third of the tiles raised to 0x80 and above, so the int32 rgba words of
the port go negative.
"""

import struct

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import cwipc_util_tpu as jcwipc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu import codec as jcodec
from cwipc_util_tpu.core import buffers as jbuffers
from cwipc_util_tpu.ops import voxelize as jvoxelize
from cwipc_util_tpu_torch import codec as pcodec
from cwipc_util_tpu_torch.models.synthetic import _generate_host
from cwipc_util_tpu_torch.net.sink_encoder import cwipc_sink_encoder
from cwipc_util_tpu_torch.net.sink_passthrough import cwipc_sink_passthrough
from cwipc_util_tpu_torch.net.source_decoder import cwipc_source_decoder
from cwipc_util_tpu_torch.net.source_passthrough import cwipc_source_passthrough

H = 90  # 8,100 points: capacity 8192 in both packages
STATIC = ("octree_bits", "exp_factor", "voxelsize", "tilemask")
# (octree_bits, tilenumber): kernel 1; kernels 3 and 1; the exact-key form
DEVICE_CASES = [(9, 0), (9, 1), (10, 0)]


@pytest.fixture(scope="module")
def pts():
    p = _generate_host(H, H, 0.5)
    rng = np.random.default_rng(7)
    p["tile"] = np.where(rng.random(len(p)) < 1 / 3, p["tile"] | 0x80, p["tile"])
    return p


@pytest.fixture(scope="module")
def jax_program():
    """The JAX device program with the chip path's reduce, jitted."""
    real = jvoxelize._reduce_runs_xla_cm
    jax.clear_caches()
    jvoxelize._reduce_runs_xla_cm = jvoxelize._reduce_runs_pallas_cm

    def program(*args, **kw):
        return jcodec._encode_device_impl(*args, **kw)

    try:
        yield jax.jit(program, static_argnames=STATIC)
    finally:
        jvoxelize._reduce_runs_xla_cm = real
        jax.clear_caches()


def _params(bits, tile, quality=85):
    return dict(octree_bits=bits, tilenumber=tile, jpeg_quality=quality)


def _port_stream(pc, route, **params):
    enc = pcodec.cwipc_new_encoder(params=pcodec.cwipc_encoder_params(**params))
    {"feed": enc.feed, "device": enc._feed_device, "host": enc._feed_host}[route](pc)
    return enc.get_bytes()


def _jax_stream(pc, **params):
    enc = jcodec.cwipc_new_encoder(params=jcodec.cwipc_encoder_params(**params))
    enc.feed(pc)
    return enc.get_bytes()


def _decode(codec, blob, **kw):
    dec = codec.cwipc_new_decoder(**kw)
    dec.feed(blob)
    return dec.get()


@pytest.mark.parametrize("bits,tile", DEVICE_CASES)
def test_device_program_bit_equal_to_jax(pts, jax_program, bits, tile):
    """Count, every delta and rgba word, the step and vmin: bit-equal, over
    the whole capacity."""
    kw = dict(octree_bits=bits, exp_factor=1.0, voxelsize=0.0, tilemask=tile)
    jb = jbuffers.buffer_from_numpy(pts, 8192)
    pb = port.buffer_from_numpy(pts, 8192, device="cpu")
    jcount, jdeltas, jrgba, jstep, jvmin = jax.device_get(jax_program(jb.xyz, jb.rgba, jb.count, **kw))
    count, deltas, rgba, step, vmin = pcodec._encode_device_impl(pb.xyz, pb.rgba, pb.count, **kw)
    assert int(count) == int(jcount) > 1000
    np.testing.assert_array_equal(deltas.numpy().view(np.uint32), np.asarray(jdeltas).view(np.uint32))
    np.testing.assert_array_equal(rgba.numpy().view(np.uint32), np.asarray(jrgba))
    assert step.numpy().view(np.uint32) == np.asarray(jstep).view(np.uint32)
    np.testing.assert_array_equal(vmin.numpy(), np.asarray(jvmin))
    m = int(count)
    if tile:
        assert np.all(((rgba.numpy()[:m].view(np.uint32) >> 24) & tile) != 0)
    assert np.any(rgba.numpy()[:m] < 0)  # tiles of 0x80 and above survive


@pytest.mark.parametrize("bits,tile", [(9, 0), (9, 1)])
def test_geometry_host_bit_equal_to_jax(pts, bits, tile):
    """The host twin: count, keys, drgba, step and vmin equal."""
    kw = dict(octree_bits=bits, exp_factor=1.0, voxelsize=0.0, tilemask=tile)
    got = pcodec._geometry_host(port.cwipc_from_numpy_array(pts, 0, device="cpu"), **kw)
    want = jcodec._geometry_host(jcwipc.cwipc_from_numpy_array(pts, 0), **kw)
    assert got[0] == want[0] > 1000 and got[3] == want[3]
    for a, b in zip(got[1:3] + got[4:], want[1:3] + want[4:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits,tile,quality", [(9, 0, 85), (9, 1, 85), (10, 0, 85), (7, 2, 100), (12, 1, 85)])
def test_host_stream_byte_equal_to_jax(pts, monkeypatch, bits, tile, quality):
    """A CPU cloud through the port's encoder against the JAX encoder on its
    CPU backend: byte-equal streams; each package decodes the other's to
    equal records."""
    monkeypatch.setenv("CWIPC_CODEC_HOST", "1")
    params = _params(bits, tile, quality)
    mine = _port_stream(port.cwipc_from_numpy_array(pts, 42, device="cpu"), "feed", **params)
    theirs = _jax_stream(jcwipc.cwipc_from_numpy_array(pts, 42), **params)
    assert mine == theirs
    a = _decode(pcodec, theirs, device="cpu")
    b = _decode(jcodec, mine)
    assert a.timestamp() == b.timestamp() == 42 and a.cellsize() == b.cellsize()
    np.testing.assert_array_equal(a.get_numpy_array(), b.get_numpy_array())
    if tile:
        assert np.all((a.get_numpy_array()["tile"] & tile) != 0)


@pytest.mark.parametrize("bits,tile", DEVICE_CASES)
def test_device_stream_byte_equal_to_jax(pts, jax_program, monkeypatch, bits, tile):
    """The port's device route on a CPU cloud (the kernels' plain versions)
    against the JAX encoder's device route (CWIPC_CODEC_HOST=0): byte-equal
    streams, each decoded by the other package to equal records."""
    monkeypatch.setenv("CWIPC_CODEC_HOST", "0")
    monkeypatch.setattr(jcodec, "_ENCODE_DEVICE", jax_program)
    params = _params(bits, tile)
    mine = _port_stream(port.cwipc_from_numpy_array(pts, 43, device="cpu"), "device", **params)
    theirs = _jax_stream(jcwipc.cwipc_from_numpy_array(pts, 43), **params)
    assert mine == theirs
    np.testing.assert_array_equal(_decode(pcodec, theirs, device="cpu").get_numpy_array(),
                                  _decode(jcodec, mine).get_numpy_array())


def test_host_and_device_routes_agree(pts):
    """test_pipeline.py's contract for the two routes: equal counts, colors
    and tiles, positions within one step."""
    pc = port.cwipc_from_numpy_array(pts, 1, device="cpu")
    out, step = {}, None
    for route in ("host", "device"):
        blob = _port_stream(pc, route, **_params(9, 0, 100))
        step = struct.unpack("<f", blob[20:24])[0]
        out[route] = _decode(pcodec, blob, device="cpu").get_numpy_array()
    a, b = out["host"], out["device"]
    assert a.shape == b.shape
    for f in ("x", "y", "z"):
        assert float(np.abs(a[f] - b[f]).max()) <= step * 1.0001
    for f in ("r", "g", "b", "tile"):
        np.testing.assert_array_equal(a[f], b[f])


def test_device_route_reads_the_host_once(pts, monkeypatch):
    """One host read a frame on the device route (the solo encoder and the
    group's shared pass), none on the host route (test_pipeline.py:214)."""
    calls = []
    real = pcodec._readback
    monkeypatch.setattr(pcodec, "_readback", lambda t: (calls.append(t.numel()), real(t))[1])
    pc = port.cwipc_from_numpy_array(pts, 1, device="cpu")
    assert _port_stream(pc, "device", **_params(9, 1))
    assert len(calls) == 1 and calls[0] == 5 + 2 * 8192
    assert _port_stream(pc, "host", **_params(9, 1))
    group = pcodec.cwipc_new_encodergroup()
    for bits in (9, 8, 7):
        group.addencoder(params=pcodec.cwipc_encoder_params(octree_bits=bits))
    group.feed(pc)
    assert len(calls) == 1
    monkeypatch.setattr(pcodec, "_on_device", lambda pc: True)  # the route a CUDA cloud takes
    group.feed(pc)
    assert len(calls) == 2


@pytest.mark.parametrize("route", ["host", "device"])
def test_group_shares_one_pass_and_its_deepest_member_equals_a_solo_encode(pts, jax_program, monkeypatch,
                                                                            route):
    """A group {9, 8, 7}: one shared geometry pass; the deepest member
    byte-equal to a solo encode at 9; every member byte-equal to the JAX
    group's on the same route; each member decodes within its own step of
    the cloud.  The device route is taken on a CPU cloud by the routing
    function's answer for a CUDA cloud."""
    monkeypatch.setenv("CWIPC_CODEC_HOST", "1" if route == "host" else "0")
    monkeypatch.setattr(jcodec, "_ENCODE_DEVICE", jax_program)
    monkeypatch.setattr(pcodec, "_on_device", lambda pc: route == "device")
    pc = port.cwipc_from_numpy_array(pts, 5, device="cpu")
    mine, theirs = pcodec.cwipc_new_encodergroup(), jcodec.cwipc_new_encodergroup()
    encs = [mine.addencoder(params=pcodec.cwipc_encoder_params(octree_bits=b)) for b in (9, 8, 7)]
    jencs = [theirs.addencoder(params=jcodec.cwipc_encoder_params(octree_bits=b)) for b in (9, 8, 7)]
    calls = []
    real = pcodec._readback
    monkeypatch.setattr(pcodec, "_readback", lambda t: (calls.append(1), real(t))[1])
    mine.feed(pc)
    assert len(calls) == (route == "device")  # one shared pass, on the device route only
    theirs.feed(jcwipc.cwipc_from_numpy_array(pts, 5))
    blobs = [e.get_bytes() for e in encs]
    assert blobs == [e.get_bytes() for e in jencs]
    assert blobs[0] == _port_stream(pc, route, **_params(9, 0))
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1).astype(np.float64)
    for blob in blobs:
        out = _decode(pcodec, blob, device="cpu").get_numpy_matrix(onlyGeometry=True)
        step = struct.unpack("<f", blob[20:24])[0]
        d = np.sqrt(((out[:200, None, :] - xyz[None, :, :]) ** 2).sum(-1)).min(axis=1)
        assert (d <= step).all()


def test_wide_keys_roundtrip(pts):
    """octree_bits 12 (45-bit keys): every decoded point within one fine
    step of the cloud (test_pipeline.py's bound)."""
    pc = port.cwipc_from_numpy_array(pts, 0, device="cpu")
    out = _decode(pcodec, _port_stream(pc, "feed", **_params(12, 0)), device="cpu").get_numpy_matrix(True)
    a = pc.get_numpy_matrix(onlyGeometry=True)
    step = (a.max(axis=0) - a.min(axis=0)).max() / (1 << 12)
    d = np.sqrt(((out[:200, None, :] - a[None, :, :]) ** 2).sum(-1)).min(axis=1)
    assert (d <= step).all()


def test_empty_frame_on_both_routes():
    """test_pipeline.py's empty cloud: the header-only stream of the JAX
    package on both routes, decoded host-backed to 0 points with the
    timestamp; a tile mask that keeps nothing gives the same."""
    want = _jax_stream(jcwipc.cwipc_from_points([], 7), **_params(9, 0))
    pc = port.cwipc_from_points([], 7, device="cpu")
    for route in ("feed", "device"):
        assert _port_stream(pc, route, **_params(9, 0)) == want
    out = _decode(pcodec, want, device="cpu")
    assert out.count() == 0 and out.timestamp() == 7 and out._buffer is None
    one = port.cwipc_from_points([(0.0, 0.0, 0.0, 1, 2, 3, 2)], 7, device="cpu")
    assert _port_stream(one, "device", **_params(9, 1)) == want


def test_small_and_legacy_width_streams(pts):
    """test_pipeline.py's widths: bits 4, 9 and 12 round-trip; a small
    cloud takes the delta-stream form (no octree flag), which both
    packages decode to equal records."""
    pc = port.cwipc_from_numpy_array(pts, 0, device="cpu")
    for bits in (4, 9, 12):
        assert _decode(pcodec, _port_stream(pc, "feed", **_params(bits, 0)), device="cpu").count() > 0
    small = pts[::1600]
    blob = _port_stream(port.cwipc_from_numpy_array(small, 0, device="cpu"), "feed", **_params(9, 0, 100))
    assert not blob[5] & pcodec._FLAG_OCTREE and blob[5] & pcodec._FLAG_WIDTH_MASK in (0, 2)
    assert blob == _jax_stream(jcwipc.cwipc_from_numpy_array(small, 0), **_params(9, 0, 100))
    np.testing.assert_array_equal(_decode(pcodec, blob, device="cpu").get_numpy_array(),
                                  _decode(jcodec, blob).get_numpy_array())


def test_corrupt_and_foreign_streams_raise(pts):
    blob = _port_stream(port.cwipc_from_numpy_array(pts, 0, device="cpu"), "feed", **_params(9, 0))
    for bad, what in ((blob[:10], "too short"), (b"MPEG" + blob[4:], "not a CTC1 stream"),
                      (blob[:40] + b"\0" * 40 + blob[80:], "corrupt|inconsistent")):
        with pytest.raises(port.CwipcError, match=what):
            _decode(pcodec, bad, device="cpu")


def test_native_shim_equals_numpy_twins(pts, monkeypatch):
    """The shim's geometry stage, octree pack/unpack and decode tail equal
    their numpy twins (tests/test_native.py:573): equal arrays, and equal
    streams and records with the twins alone."""
    assert pcodec.native_loaded()
    pc = port.cwipc_from_numpy_array(pts, 3, device="cpu")
    for tile in (0, 1):
        kw = dict(octree_bits=9, exp_factor=1.0, voxelsize=0.0, tilemask=tile)
        nat, twin = pcodec._geometry_host(pc, **kw), pcodec._geometry_numpy(pc.get_numpy_array(), **kw)
        assert nat[0] == twin[0] and nat[3] == twin[3]
        for a, b in zip(nat[1:3] + nat[4:], twin[1:3] + twin[4:]):
            np.testing.assert_array_equal(a, b)
    keys = nat[1]
    occ = pcodec._octree_pack(keys, 9)
    np.testing.assert_array_equal(occ, pcodec._octree_pack_numpy(keys, 9))
    np.testing.assert_array_equal(pcodec._octree_unpack(occ, 9, len(keys)),
                                  pcodec._octree_unpack_numpy(occ, 9, len(keys)))
    cases = [(9, 0), (11, 0), (9, 1)]
    with_shim = {c: _port_stream(pc, "feed", **_params(*c)) for c in cases}
    monkeypatch.setattr(pcodec, "_native", lambda name: None)
    for c in cases:
        assert _port_stream(pc, "feed", **_params(*c)) == with_shim[c]
    twin_out = _decode(pcodec, with_shim[(9, 0)], device="cpu").get_numpy_array()
    monkeypatch.undo()
    np.testing.assert_array_equal(_decode(pcodec, with_shim[(9, 0)], device="cpu").get_numpy_array(), twin_out)


def test_sink_encoder_feeds_source_decoder(pts):
    """10 frames through cwipc_sink_encoder -> an in-memory link ->
    cwipc_source_decoder: every frame arrives, in order, with the count and
    records a solo decoder gives."""
    link = chip_smoke.MemoryLink()
    sink = cwipc_sink_encoder(link, nodrop=True)
    src = cwipc_source_decoder(link, device="cpu")
    assert link.fourcc == "cwi1"
    src.start()
    sink.start()
    frames = [port.cwipc_from_numpy_array(pts[i * 100:], i, device="cpu") for i in range(10)]
    want = [_decode(pcodec, _port_stream(f, "feed", **_params(9, 0)), device="cpu") for f in frames]
    for f in frames:
        sink.feed(f.clone())
    sink.stop()
    got = chip_smoke.drain(src, 10)
    src.stop()
    assert not sink.is_alive() and not src.is_alive()
    assert [pc.timestamp() for pc in got] == list(range(10))
    for a, b in zip(got, want):
        assert a.count() == b.count() > 0 and a._device.type == "cpu"
        np.testing.assert_array_equal(a.get_numpy_array(), b.get_numpy_array())


def test_passthrough_pair_roundtrips_packets(pts):
    """cwipc_sink_passthrough -> an in-memory link ->
    cwipc_source_passthrough: packets equal to get_packet(), clouds equal."""
    link = chip_smoke.MemoryLink()
    sink = cwipc_sink_passthrough(link, nodrop=True)
    src = cwipc_source_passthrough(link, device="cpu")
    assert link.fourcc == "cwi0"
    frames = [port.cwipc_from_numpy_array(pts[: 500 + i], i, device="cpu") for i in range(4)]
    packets = [bytes(f.get_packet()) for f in frames]
    sink.start()
    for f in frames:
        sink.feed(f.clone())
    sink.stop()
    assert list(link.packets.queue)[:4] == packets
    src.start()
    got = chip_smoke.drain(src, 4)
    src.stop()
    assert [pc.timestamp() for pc in got] == [0, 1, 2, 3]
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a.get_numpy_array(), b.get_numpy_array())


def test_decoder_cloud_device():
    """Decoded clouds are host-backed on the decoder's device: the buffer
    is built there at first use."""
    blob = _port_stream(port.cwipc_from_points([(0.5, 0.5, 0.5, 9, 9, 9, 1)], 0, device="cpu"), "feed",
                        **_params(9, 0))
    out = _decode(pcodec, blob, device="cpu")
    assert out._buffer is None
    assert out._access_buffer().xyz.device == torch.device("cpu")
