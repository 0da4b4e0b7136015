"""Slice parity: the port's capture and streaming commands (``grab``,
``join``, ``timing``, ``timing_tests``, ``netserver``, ``toproxy``,
``forward`` with ``net/sink_netingest.py``) against the JAX package's, on
the CPU.

Every port command runs with ``--device cpu`` in a subprocess where jax and
the JAX package cannot be imported (``test_torch_cli._cli_start``); the
file commands of one test run one after another in one such process, the
JAX commands in this process through their scripts' ``main``.  The
receiver of every network test is the port's ``source_netclient`` (with
its decoder, passthrough or tile synchronizer) in this process on the CPU.
Each subprocess has a time limit, each socket a timeout, and each server
is stopped in ``finally``; a command's port is waited for in the kernel's
table of listening sockets (``chip_smoke.listening``), not by connecting
to it.
Tolerances:

* ``join``: the joined points equal the JAX command's, record for record;
* ``grab --compress`` (and with ``--compress_param octree_bits=8
  --incore``) from the same playback recording: each file byte-equal to
  the JAX command's (the codec's two routes are byte-equal to the JAX
  package's; PERF.md section 2); plain ``grab`` writes the recording the
  join reads; ``--nopointclouds`` writes none; ``--incore`` without
  ``--count`` and a missing output directory fail as in the JAX package;
* ``timing`` on that recording: the CSV rows equal the JAX command's,
  apart from the wall-clock columns ``received_ms`` and ``latency_ms``;
* ``timing_tests 2000``: every step of the JAX harness is timed;
* the relay's shutdown: a client that reads only after the producer has
  gone gets every relayed packet, byte for byte;
* the relay (``netserver --oneshot``, ``forward --forward``), ``toproxy``
  into the port's proxy, and ``forward`` raw, compressed, tiled and
  multi-quality (with a runtime quality switch): at least the JAX tests'
  frame counts arrive, each with the sender's point count (raw: the
  frame's; compressed: a solo decode's of the same frame).
"""

import csv
import os
import re
import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
from chip_smoke import drain, listening
from test_scripts import _free_port, _free_port_block
from test_torch_cli import _cli_start, _cli_wait, _jax_main

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu.scripts import cwipc_grab as j_grab
from cwipc_util_tpu.scripts import cwipc_join as j_join
from cwipc_util_tpu.scripts import cwipc_timing as j_timing
from cwipc_util_tpu_torch import codec
from cwipc_util_tpu_torch.net import proxy, source_decoder, source_netclient, source_passthrough
from cwipc_util_tpu_torch.net.source_synchronizer import cwipc_source_synchronizer

TIMEOUT = 120


def _commands(*commands):
    """The port's commands, one after another in one process."""
    args = []
    for argv in commands:
        args += [*(("--then",) if args else ()), *argv, "--device", "cpu"]
    return args


def _exits(stdout):
    return [int(c) for c in re.findall(r"^=== exit (-?\d+)$", stdout, re.M)]


def _recording(d):
    d.mkdir()
    gen = port.cwipc_synthetic(0, 1000, device="cpu")
    gen.start()
    for i in range(3):
        port.cwipc_write(str(d / f"pointcloud-{i:04d}.ply"), gen.get())
    gen.stop()
    return d


def test_grab_join_and_timing_match_the_jax_cli(tmp_path, monkeypatch):
    rec = _recording(tmp_path / "rec")
    for sub in ("pgrab", "jgrab", "pcomp", "jcomp", "pcomp8", "jcomp8", "nopc"):
        (tmp_path / sub).mkdir()
    plys = [str(rec / f"pointcloud-{i:04d}.ply") for i in range(2)]
    proc = _cli_start(tmp_path, *_commands(
        ("grab", "--synthetic", "--npoints", "1000", "--count", "2", "--fpattern", "count", "pgrab"),
        ("join", "pjoined.ply", *plys),
        ("grab", "--playback", "rec", "--compress", "--fpattern", "count", "pcomp"),
        ("grab", "--playback", "rec", "--compress", "--compress_param", "octree_bits=8", "--fpattern", "count",
         "--incore", "--count", "3", "pcomp8"),
        ("grab", "--synthetic", "--npoints", "1000", "--count", "2", "--nopointclouds", "nopc"),
        ("grab", "--synthetic", "--incore", "nopc"),
        ("timing", "--playback", "rec", "--count", "3", "--output", "ptiming.csv"),
        ("grab", "--synthetic", "--count", "1")))
    for argv in (("join", "jjoined.ply", *plys),
                 ("grab", "--playback", "rec", "--compress", "--fpattern", "count", "jcomp"),
                 ("grab", "--playback", "rec", "--compress", "--compress_param", "octree_bits=8", "--fpattern",
                  "count", "--incore", "--count", "3", "jcomp8"),
                 ("timing", "--playback", "rec", "--count", "3", "--output", "jtiming.csv")):
        module = {"join": j_join, "grab": j_grab, "timing": j_timing}[argv[0]]
        assert _jax_main(module, tmp_path, monkeypatch, *argv[1:]) == 0  # while the port's run
    rv = _cli_wait(proc, TIMEOUT)
    assert _exits(rv.stdout) == [0, 0, 0, 0, 0, -1, 0, 2], rv.stderr[-1500:]
    assert "the following arguments are required: outputdir" in rv.stderr
    assert "--incore requires --count" in rv.stdout
    assert sorted(os.listdir(tmp_path / "pgrab")) == ["pointcloud-0000.ply", "pointcloud-0001.ply"]
    assert "join: 1922 points -> pjoined.ply" in rv.stdout
    np.testing.assert_array_equal(port.cwipc_read(str(tmp_path / "pjoined.ply"), 0, device="cpu").get_numpy_array(),
                                  jc.cwipc_read(str(tmp_path / "jjoined.ply"), 0).get_numpy_array())
    for ours, theirs in (("pcomp", "jcomp"), ("pcomp8", "jcomp8")):
        names = sorted(os.listdir(tmp_path / ours))
        assert names == sorted(os.listdir(tmp_path / theirs)) == [f"pointcloud-{i:04d}.cwicpc" for i in range(3)]
        for name in names:
            assert (tmp_path / ours / name).read_bytes() == (tmp_path / theirs / name).read_bytes(), (ours, name)
    assert (tmp_path / "pcomp8" / "pointcloud-0000.cwicpc").stat().st_size < \
        (tmp_path / "pcomp" / "pointcloud-0000.cwicpc").stat().st_size
    assert not os.listdir(tmp_path / "nopc")
    rows = []
    for name in ("ptiming.csv", "jtiming.csv"):
        with open(tmp_path / name) as fp:
            rows.append([{k: v for k, v in r.items() if k not in ("received_ms", "latency_ms")}
                         for r in csv.DictReader(fp)])
    assert rows[0] == rows[1] and len(rows[0]) == 3 and rows[0][0]["pointcount"] == "961"


def test_timing_tests_harness_runs(tmp_path):
    rv = _cli_wait(_cli_start(tmp_path, "2000", "--device", "cpu",
                              module="cwipc_util_tpu_torch.benchmarks.timing_tests"), TIMEOUT)
    assert rv.returncode == 0, rv.stderr[-1500:]
    steps = re.findall(r"^(.+): (\d+\.\d+) seconds per operation \((\d+) iterations\)$", rv.stdout, re.M)
    assert [s for s, _, _ in steps] == [
        "get_bytes", "get_packet", "get_points", "get_numpy_array", "get_numpy_matrix", "get_bytes+from_points",
        "get_packet+from_packet", "get_numpy_array+from_numpy_array", "get_numpy_matrix+from_numpy_matrix",
        "downsample(2x cellsize)", "tilefilter(1)"]
    assert all(int(n) >= 1 for _, _, n in steps)
    assert "cloud of 1936 points on cpu" in rv.stdout


def _frame_counts(npoints, streams=((0, 9),)):
    """The points a frame of the synthetic source has, and a decode of each
    (tile mask, octree bits) stream of an encoder group over it, as
    ``cwipc_sink_encoder`` builds the group (its geometry is the same in
    every frame)."""
    gen = port.cwipc_synthetic(0, npoints, device="cpu")
    gen.start()
    pc = gen.get()
    gen.stop()
    group = codec.cwipc_new_encodergroup()
    members = [group.addencoder(params=codec.cwipc_encoder_params(octree_bits=bits, tilenumber=tile))
               for tile, bits in streams]
    group.feed(pc)
    decoded = []
    for enc in members:
        dec = codec.cwipc_new_decoder("cpu")
        dec.feed(enc.get_bytes())
        decoded.append(dec.get().count())
    return pc.count(), decoded


def _receive(source, n):
    source.start()
    try:
        return [pc.count() for pc in drain(source, n, timeout=90)]
    finally:
        source.stop()


def test_relay_and_toproxy(tmp_path):
    """The JAX tests' relay (netserver --oneshot <- forward --forward, a
    netclient on the serve port) and toproxy into a proxy source."""
    n_frame, _ = _frame_counts(1000)
    ingest, serve, proxy_port = _free_port(), _free_port(), _free_port()
    relay = _cli_start(tmp_path, "netserver", "--oneshot", "--port", str(ingest), "--serveport", str(serve))
    src = proxy.cwipc_proxy_source("127.0.0.1", proxy_port, device="cpu")
    got_proxy = []

    def consume():
        deadline = time.monotonic() + 90
        while len(got_proxy) < 2 and time.monotonic() < deadline:
            if src.available(True):
                pc = src.get()
                if pc is not None:
                    got_proxy.append(pc.count())

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    procs = [relay]
    try:
        # --fps 2: the proxy keeps only its latest frame, so frames sent
        # back to back can replace each other before a loaded consumer wakes
        procs.append(_cli_start(tmp_path, "toproxy", "localhost", str(proxy_port), "--synthetic", "--npoints", "1000",
                                "--count", "3", "--fps", "2", "--device", "cpu"))
        listening(serve, relay)
        listening(ingest, relay)
        client = source_passthrough.cwipc_source_passthrough(
            source_netclient.cwipc_source_netclient(f"127.0.0.1:{serve}"), device="cpu")
        client.start()
        # --nodrop: a producer that outruns its sink waits instead of dropping frames
        procs.append(_cli_start(tmp_path, "forward", "--forward", f"localhost:{ingest}", "--synthetic",
                                "--npoints", "1000", "--count", "8", "--noencode", "--nodrop", "--device", "cpu"))
        try:
            got = [pc.count() for pc in drain(client, 5, timeout=90)]
        finally:
            client.stop()
        for p in procs[1:] + procs[:1]:
            rv = _cli_wait(p, TIMEOUT)
            assert rv.returncode == 0, rv.stderr[-1500:]
        consumer.join(timeout=30)
        assert not consumer.is_alive()
    finally:
        for p in procs:
            p.kill()
        src.stop()
    assert len(got) >= 5 and set(got) == {n_frame}, got
    assert len(got_proxy) >= 2 and set(got_proxy) == {n_frame}, got_proxy


def test_netserver_oneshot_sends_what_its_clients_still_hold():
    """The relay of ``netserver --oneshot``: a client that reads only after
    the producer has gone still gets every relayed packet, byte for byte
    (the port sends what a client's queue holds before it stops; the JAX
    script drops it).  Six packets of 4 MiB outgrow the loopback sockets'
    buffers, so most of them wait in the relay's queue."""
    import socket
    import struct

    from cwipc_util_tpu_torch.net.sink_netserver import HEADER_FORMAT
    from cwipc_util_tpu_torch.scripts.cwipc_netserver import Relay

    ingest, serve = _free_port(), _free_port()
    relay = Relay(ingest, serve, oneshot=True)
    runner = threading.Thread(target=relay.run, daemon=True)
    runner.start()
    size = 4 << 20
    packets = [struct.pack(HEADER_FORMAT, 0x30303030, size, i) + bytes([i]) * size for i in range(6)]
    consumer = socket.create_connection(("127.0.0.1", serve), timeout=30)
    try:
        deadline = time.monotonic() + 30
        while not relay.state.clients and time.monotonic() < deadline:
            time.sleep(0.01)
        with socket.create_connection(("127.0.0.1", ingest), timeout=30) as producer:
            for packet in packets:
                producer.sendall(packet)
        assert relay.done.wait(30), "the relay did not see its producer go"
        got = bytearray()
        while chunk := consumer.recv(1 << 20):
            got += chunk
        runner.join(timeout=30)
        assert not runner.is_alive()
    finally:
        consumer.close()
        relay.done.set()
    assert len(got) == len(packets) * len(packets[0]) and bytes(got) == b"".join(packets)


def test_forward_raw_compressed_tiled_and_multiquality(tmp_path):
    """The JAX tests' forward pipelines (tests/test_scripts.py:95-160) and
    the runtime quality switch over TCP (:584)."""
    n_frame, (n_decoded,) = _frame_counts(1000)
    raw, comp = _free_port(), _free_port()
    tiled, multi = _free_port_block(2), _free_port_block(4)
    common = ("--synthetic", "--npoints", "1000", "--nodrop", "--device", "cpu")
    procs = [
        _cli_start(tmp_path, "forward", *common, "--count", "10", "--noencode", "--port", str(raw)),
        _cli_start(tmp_path, "forward", *common, "--count", "10", "--port", str(comp)),
        _cli_start(tmp_path, "forward", *common, "--count", "40", "--fps", "10", "--tiled", "--port", str(tiled)),
        _cli_start(tmp_path, "forward", *common, "--count", "3000", "--fps", "30", "--tiled", "--octree_bits", "8",
                   "--octree_bits", "10", "--port", str(multi)),
    ]
    try:
        listening(raw, procs[0])
        got_raw = _receive(source_passthrough.cwipc_source_passthrough(
            source_netclient.cwipc_source_netclient(f"127.0.0.1:{raw}"), device="cpu"), 5)
        listening(comp, procs[1])
        got_comp = _receive(source_decoder.cwipc_activesource_decoder(
            source_netclient.cwipc_source_netclient(f"127.0.0.1:{comp}"), device="cpu"), 5)
        for p in (tiled, tiled + 1):
            listening(p, procs[2])
        rdr = source_netclient.cwipc_multisource_netclient(f"127.0.0.1:{tiled}", 2, 1)
        got_tiled = _receive(cwipc_source_synchronizer(
            rdr, [source_decoder.cwipc_source_decoder(rdr.get_tile_source(i), device="cpu") for i in range(2)]), 3)
        for p in range(multi, multi + 4):
            listening(p, procs[3])
        rdr = source_netclient.cwipc_multisource_netclient(f"127.0.0.1:{multi}", 2, 2)
        sync = cwipc_source_synchronizer(
            rdr, [source_decoder.cwipc_source_decoder(rdr.get_tile_source(i), device="cpu") for i in range(2)])
        sync.start()
        try:
            before = [pc.count() for pc in drain(sync, 3, timeout=90)]
            assert sync.select_next_tile_quality() == 1
            # frames already sent at quality 0 arrive first; then 3 at quality 1
            after, deadline = [], time.monotonic() + 90
            while len(after) < 3 or after[-3:] != [after[-1]] * 3 or after[-1] == before[-1]:
                assert time.monotonic() < deadline, after
                after += [pc.count() for pc in drain(sync, 1, timeout=30)]
        finally:
            sync.stop()
        for p in procs[:3]:
            rv = _cli_wait(p, TIMEOUT)
            assert rv.returncode == 0, rv.stderr[-1500:]
    finally:
        for p in procs:
            p.kill()
    assert len(got_raw) == 5 and set(got_raw) == {n_frame}, got_raw
    assert len(got_comp) == 5 and set(got_comp) == {n_decoded}, got_comp
    # each fused frame: the two tiles' decodes (the octree is per tile)
    _, tiles = _frame_counts(1000, ((1, 9), (2, 9)))
    assert len(got_tiled) == 3 and set(got_tiled) == {sum(tiles)}, (got_tiled, tiles)
    _, (t1_8, t1_10, t2_8, t2_10) = _frame_counts(1000, ((1, 8), (1, 10), (2, 8), (2, 10)))
    assert len(before) == 3 and set(before) == {t1_8 + t2_8}, (before, t1_8 + t2_8)
    assert after[-1] == t1_10 + t2_10 != t1_8 + t2_8, (after, t1_10 + t2_10)
