"""Slice parity: the port's DASH pair (``net/sink_lldpkg.py``,
``net/source_lldplay.py``) and the commands that use it, against the JAX
package's, on the CPU, over the fake SIGNALS libraries
(``cwipc_util_tpu/native/fake_signals.c``, a file-system loopback with the
real SMD ABI) that ``util.build_fake_signals`` builds into the port's
``_build/native/``.  Both packages load those same libraries.

Equalities asserted:

* The packager: the same pushes through either package's sink leave the
  same files, byte for byte (stream descriptors with the SRD tile
  normals, frames); without SIGNALS both factories raise ``CwipcError``.
* The player: discovery, tile grouping, quality selection, the single-
  stream view, signed normals and the pump's error as EOF, as the JAX
  tests (tests/test_lldash.py) hold them; tile info equal to the JAX
  player's.
* Frames through the loopback: encoded by the port, pushed, played back
  through ``--lldplay``'s source and decoded, bit-equal to the JAX
  decoder's decode of the JAX encoder's stream of the same clouds (the
  streams byte-equal too).
* The commands: ``forward --lldpkg`` of a recording writes the JAX
  command's files byte for byte; ``view --lldplay`` displays its 3 frames
  and ``view --mt-lldplay`` (tiled) fuses the tiles' streams.

Two faults of the JAX package's DASH path are repaired in the port, each
with a test here that fails on the JAX package's behaviour: the decoder
source started its thread before its source, so ``view --lldplay``
decoded no frame; a tile view's ``get`` waited for ever once the session
stopped.
"""

import os
import time

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
from test_torch_cli import _cli_start, _cli_wait, _jax_main

import cwipc_util_tpu as jc
import cwipc_util_tpu.net.sink_lldpkg as jsink_mod
import cwipc_util_tpu.net.source_lldplay as jsrc_mod
import cwipc_util_tpu_torch as port
import cwipc_util_tpu_torch.net.sink_lldpkg as sink_mod
import cwipc_util_tpu_torch.net.source_lldplay as src_mod
from cwipc_util_tpu import codec as jcodec
from cwipc_util_tpu.scripts import cwipc_forward as j_forward
from cwipc_util_tpu_torch import codec, util
from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.net import source_decoder
from cwipc_util_tpu_torch.net.abstract import cwipc_activerawsource_abstract
from cwipc_util_tpu_torch.scripts import _scriptsupport

_CACHES = ((sink_mod, "_lldpkg_dll_reference"), (src_mod, "_lldplay_dll_reference"),
           (jsink_mod, "_lldpkg_dll_reference"), (jsrc_mod, "_lldplay_dll_reference"))


@pytest.fixture()
def fake_signals(monkeypatch):
    """The fake SIGNALS libraries, built into the port's _build/native/;
    SIGNALS_SMD_PATH names them and the DLL caches are reset around each
    test."""
    build = util.build_fake_signals()
    assert build == util.NATIVE_BUILD and all((build / n).exists() for n in util.FAKE_SIGNALS)
    monkeypatch.setenv("SIGNALS_SMD_PATH", str(build))
    for mod, name in _CACHES:
        monkeypatch.setattr(mod, name, None)
    yield build
    for mod, name in _CACHES:
        setattr(mod, name, None)


def test_factories_require_signals(monkeypatch, tmp_path):
    monkeypatch.setenv("SIGNALS_SMD_PATH", str(tmp_path / "nonexistent"))
    for mod, name in _CACHES:
        monkeypatch.setattr(mod, name, None)
    with pytest.raises(CwipcError, match="lldash_packager"):
        sink_mod.cwipc_sink_lldpkg("http://example.invalid/stream/")
    with pytest.raises(CwipcError, match="lldash_play"):
        src_mod.cwipc_multisource_lldplay("http://example.invalid/stream/").start()


def _push(mod, url):
    sink = mod.cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi1")
    s0 = sink.add_stream(tilenum=1, tiledesc={"normal": {"x": 0.0, "y": 0.0, "z": 1.0}, "cameraMask": 1})
    s1 = sink.add_stream(tilenum=2, tiledesc={"normal": {"x": -0.5, "y": 0.25, "z": -1.0}, "cameraMask": 2})
    assert (s0, s1) == (0, 1)
    sink.start()
    assert sink.feed(b"frame-zero", s0) and sink.feed(b"frame-one", s1) and sink.feed(b"frame-two", s0)
    assert not sink.feed(b"", s0)  # a zero-length frame is rejected at the source
    assert sink.get_media_time(0) >= 0
    sink.stop()
    sink.statistics()
    assert not sink.feed(b"late", s0)


def test_lldpkg_push_equals_the_jax_sink(fake_signals, tmp_path):
    for name, mod in (("port", sink_mod), ("jax", jsink_mod)):
        _push(mod, str(tmp_path / name) + "/live.mpd")
    files = {name: {p.name: p.read_bytes() for p in (tmp_path / name).iterdir()} for name in ("port", "jax")}
    assert files["port"] == files["jax"]
    ingest = files["port"]
    streams = ingest["streams.txt"].decode().splitlines()
    assert streams[0].strip() == "2"
    assert streams[1].split()[1:5] == ["1", "0", "0", "1000"]
    assert streams[2].split()[1:5] == ["2", str((-500) & 0xFFFFFFFF), "250", str((-1000) & 0xFFFFFFFF)]
    assert "live.name" in ingest
    assert ingest["s0_00000000.frame"] == b"frame-zero" and ingest["s0_00000001.frame"] == b"frame-two"
    assert ingest["s1_00000000.frame"] == b"frame-one"
    src, jsrc = src_mod.cwipc_multisource_lldplay(str(tmp_path / "port")), jsrc_mod.cwipc_multisource_lldplay(
        str(tmp_path / "jax"))
    assert src.start() and jsrc.start()
    infos = [src.get_tileinfo_dict(t) for t in range(2)]
    assert infos == [jsrc.get_tileinfo_dict(t) for t in range(2)]
    assert infos[1]["normal"] == {"x": -0.5, "y": 0.25, "z": -1.0}  # signed, as the JAX player decodes
    src.stop()
    jsrc.stop()
    with pytest.raises(CwipcError, match="cannot play"):
        src_mod.cwipc_multisource_lldplay(str(tmp_path / "nothing-here")).start()


def test_lldash_loopback_with_quality_switch(fake_signals, tmp_path):
    """Tiled streams: 4 streams group into 3 tiles, the middle one with 2
    qualities; each tile's view gets its frames; the quality switch
    reaches the library."""
    url = str(tmp_path / "cdn") + "/"
    sink = sink_mod.cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi1")
    descs = {t: {"normal": {"x": 0.0, "y": 0.0, "z": float(t)}} for t in (1, 2, 3)}
    streams = [sink.add_stream(tilenum=t, tiledesc=descs[t]) for t in (1, 2, 2, 3)]
    sink.start()
    payloads = {s: [f"s{s}f{i}".encode() for i in range(3)] for s in streams}
    for s, frames in payloads.items():
        for frame in frames:
            assert sink.feed(frame, s)
    sink.stop()
    src = src_mod.cwipc_multisource_lldplay(url)
    assert src.start()
    assert src.get_tile_count() == 3
    assert [len(q) for q in src.get_description()] == [1, 2, 1]
    info = src.get_tileinfo_dict(1)
    assert info["cameraMask"] == 2 and info["nquality"] == 2 and info["normal"]["z"] == 2.0
    got, want = {i: [] for i in range(3)}, {0: 3, 1: 6, 2: 3}
    deadline = time.time() + 10
    while time.time() < deadline and any(len(got[i]) < want[i] for i in got):
        for i in range(3):
            view = src.get_tile_source(i)
            if view.available(wait=False):
                data = view.get()
                if data:
                    got[i].append(data)
        time.sleep(0.01)
    src.select_tile_quality(1, 1)
    src.stop()
    src.statistics()
    assert got[0] == payloads[0] and got[2] == payloads[3]
    assert sorted(got[1]) == sorted(payloads[1] + payloads[2])
    assert (tmp_path / "cdn" / "quality_t1.txt").read_text().strip() == "1"


def test_lldplay_pump_error_surfaces_as_eof(fake_signals, tmp_path):
    """A failure in the pump thread ends as EOF and an error condition, so
    consumers wake up (tests/test_lldash.py:291)."""
    url = str(tmp_path / "cdn-err") + "/"
    sink = sink_mod.cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi0")
    sink.add_stream(tilenum=0)
    sink.start()
    assert sink.feed(b"frame", 0)
    sink.stop()
    src = src_mod.cwipc_multisource_lldplay(url)

    def boom():
        raise RuntimeError("synthetic pump failure")

    src._pump_inner = boom
    assert src.start()
    deadline = time.time() + 5
    while time.time() < deadline and not src.stopped:
        time.sleep(0.01)
    assert src.stopped and src.error_condition
    view = src.get_tile_source(0)
    assert view.eof() and view.get() is None
    src.stop()


def _frames(n=3, npoints=3000, seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pts = np.zeros(npoints, port.POINT_DTYPE)
        for f in ("x", "y", "z"):
            pts[f] = rng.uniform(-1, 1, npoints)
        for f in ("r", "g", "b"):
            pts[f] = rng.integers(0, 256, npoints)
        pts["tile"] = rng.choice(np.array([1, 2], np.uint8), npoints)
        out.append((pts, 5000 + 33 * i))
    return out


def test_frames_through_the_loopback_decode_to_the_jax_points(fake_signals, tmp_path):
    """Port-encoded frames pushed through the port's packager, played by
    ``--lldplay``'s source (a single-stream view and a decoder on the CPU):
    each decoded cloud bit-equal to the JAX decoder's decode of the JAX
    encoder's stream of the same cloud, and the streams byte-equal."""
    url = str(tmp_path / "single") + "/"
    sink = sink_mod.cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi1")
    sink.add_stream(tilenum=0)
    sink.start()
    want = []
    for pts, ts in _frames():
        enc = codec.cwipc_new_encoder(octree_bits=9)
        enc.feed(port.cwipc_from_numpy_array(pts, ts, device="cpu"))
        blob = enc.get_bytes()
        jenc = jcodec.cwipc_new_encoder(octree_bits=9)
        jenc.feed(jc.cwipc_from_numpy_array(pts, ts))
        assert blob == jenc.get_bytes()
        jdec = jcodec.cwipc_new_decoder()
        jdec.feed(blob)
        want.append(jdec.get().get_numpy_array())
        assert sink.feed(blob, 0)
    sink.stop()
    args = _scriptsupport.ArgumentParser().parse_args(["--lldplay", url, "--device", "cpu"])
    src = _scriptsupport.activesource_factory_from_args(args)()
    assert src.start()
    got, deadline = [], time.time() + 20
    while len(got) < len(want) and time.time() < deadline:
        if src.available(True):
            got.append(src.get())
    src.stop()
    assert [pc._device.type for pc in got] == ["cpu"] * len(want)
    for pc, w in zip(got, want, strict=True):
        assert pc.get_numpy_array().tobytes() == w.tobytes()


def test_forward_lldpkg_equals_the_jax_command_and_view_plays_it(fake_signals, tmp_path, monkeypatch):
    """``forward --lldpkg`` of a 3-frame recording writes the JAX command's
    files byte for byte; ``view --lldplay`` plays them; ``forward --tiled
    --lldpkg`` then ``view --mt-lldplay`` fuses the two tiles' streams."""
    os.makedirs(tmp_path / "rec")
    for i, (pts, ts) in enumerate(_frames()):
        port.cwipc_write(str(tmp_path / "rec" / f"pointcloud-{i:04d}.ply"),
                         port.cwipc_from_numpy_array(pts, ts, device="cpu"), port.CWIPC_FLAGS_BINARY)
    fwd = ("--playback", "rec", "--count", "3", "--nodrop", "--seg_dur", "2000", "--timeshift_buffer", "5000")
    proc = _cli_start(tmp_path, "forward", *fwd, "--device", "cpu", "--lldpkg", str(tmp_path / "p" / "live.mpd"),
                      "--then", "view", "--lldplay", str(tmp_path / "p"), "--nodisplay", "--count", "3", "-v",
                      "--device", "cpu",
                      "--then", "forward", "--synthetic", "--npoints", "1000", "--count", "5", "--fps", "10",
                      "--tiled", "--lldpkg", str(tmp_path / "t" / "live.mpd"), "--device", "cpu",
                      "--then", "view", "--mt-lldplay", str(tmp_path / "t"), "--nodisplay", "--count", "2", "-v",
                      "--device", "cpu")
    assert _jax_main(j_forward, tmp_path, monkeypatch, *fwd, "--lldpkg", str(tmp_path / "j" / "live.mpd")) == 0
    rv = _cli_wait(proc, timeout=300)
    assert rv.returncode == 0, rv.stderr[-1500:]
    assert rv.stdout.count("=== exit 0") == 4, rv.stdout[-1500:]
    files = {d: {p.name: p.read_bytes() for p in (tmp_path / d).iterdir()} for d in ("p", "j")}
    assert files["p"] == files["j"] and len(files["p"]) == 5
    played, tiled = rv.stdout.split("=== exit 0")[1], rv.stdout.split("=== exit 0")[3]
    assert "display_pointcount: count=3" in played
    assert (tmp_path / "t" / "streams.txt").read_text().splitlines()[0].strip() == "2"
    assert "fused_tiles" in tiled


class _LateSource(cwipc_activerawsource_abstract):
    """An active raw source with nothing to get until ``start`` has run (as
    a DASH player before its stream discovery), then one frame."""

    def __init__(self, blob):
        self.blob, self.started, self.fourcc = blob, False, None

    def set_fourcc(self, fourcc):
        self.fourcc = fourcc

    def start(self):
        time.sleep(0.2)
        self.started = True
        return True

    def stop(self):
        self.started = False

    def eof(self):
        return self.blob is None

    def available(self, wait=False):
        return self.started and self.blob is not None

    def get(self):
        if not self.started:
            return None
        blob, self.blob = self.blob, None
        return blob

    def statistics(self):
        pass


def test_decoder_starts_its_source_before_reading():
    pts, ts = _frames(1)[0]
    enc = codec.cwipc_new_encoder(octree_bits=9)
    enc.feed(port.cwipc_from_numpy_array(pts, ts, device="cpu"))
    dsrc = source_decoder.cwipc_activesource_decoder(_LateSource(enc.get_bytes()), device="cpu")
    assert dsrc.start()
    deadline = time.time() + 5
    while not dsrc.available(False) and time.time() < deadline:
        time.sleep(0.01)
    pc = dsrc.get()
    dsrc.stop()
    assert pc is not None and pc.timestamp() == ts and pc.count() > 0


def test_tile_view_get_wakes_when_the_session_stops(fake_signals, tmp_path):
    import threading

    url = str(tmp_path / "quiet") + "/"
    sink = sink_mod.cwipc_sink_lldpkg(url)
    sink.add_stream(tilenum=0)
    sink.start()
    sink.stop()
    src = src_mod.cwipc_multisource_lldplay(url)
    assert src.start()
    got = []
    waiter = threading.Thread(target=lambda: got.append(src.get_tile_source(0).get()), daemon=True)
    waiter.start()
    time.sleep(0.2)
    src.stop()
    waiter.join(timeout=2)
    assert not waiter.is_alive() and got == [None]
