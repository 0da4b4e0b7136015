"""Slice parity: the port's socket sources and sinks (netserver, netclient,
proxy) and the tile synchronizer against the JAX package, on the CPU.

Every server binds a free port on 127.0.0.1 (never a fixed one), and every
thread a test starts is joined with a timeout.  Equalities asserted:

* packets go from a port netserver to a JAX netclient, and from a JAX
  netserver to a port netclient, byte for byte, in order; ``pack_frame``
  gives the same bytes in both packages;
* clouds go cwipc_sink_encoder -> port netserver -> port netclient ->
  decoder with the counts of a solo decoder, and a JAX decoder reads the
  same stream;
* the port proxy passes the JAX tests' cases (tests/test_net_utils_extras.py:
  ack, latest wins, bad magic), its clouds on the device it was given and
  equal to the records sent;
* the synchronizer passes the JAX test's case (tests/test_pipeline.py:
  two tiles fused at matching timestamps) and fuses equal to the JAX
  synchronizer on the same clouds.
"""

import socket
import struct
import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

import cwipc_util_tpu as jc
import cwipc_util_tpu_torch as port
from cwipc_util_tpu import codec as jcodec
from cwipc_util_tpu.net import sink_netserver as j_server
from cwipc_util_tpu.net import source_netclient as j_client
from cwipc_util_tpu.net import source_synchronizer as j_sync
from cwipc_util_tpu_torch import codec
from cwipc_util_tpu_torch.net import proxy, sink_encoder, sink_netserver, source_decoder, source_netclient
from cwipc_util_tpu_torch.net import source_synchronizer

TIMEOUT = 20.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = np.zeros(n, port.POINT_DTYPE)
    for f in ("x", "y", "z"):
        pts[f] = rng.uniform(-1, 1, n).astype(np.float32)
    for f in ("r", "g", "b"):
        pts[f] = rng.integers(0, 256, n)
    pts["tile"] = rng.choice(np.array([1, 2], np.uint8), n)
    return pts


def _drain(src, n):
    got = []
    deadline = time.time() + TIMEOUT
    while len(got) < n and time.time() < deadline:
        if src.available(True):
            item = src.get()
            if item is not None:
                got.append(item)
    return got


@pytest.mark.parametrize("direction", ["port server, jax client", "jax server, port client"])
def test_packets_cross_byte_for_byte(direction):
    assert sink_netserver.pack_frame(0x31697763, b"abc", 77) == j_server.pack_frame(0x31697763, b"abc", 77)
    server_mod, client_mod = (sink_netserver, j_client) if direction.startswith("port") else (j_server, source_netclient)
    port_no = _free_port()
    server = server_mod.cwipc_sink_netserver(port_no, nodrop=True)
    server.set_fourcc("cwi1")
    server.start()
    client = client_mod.cwipc_source_netclient(f"127.0.0.1:{port_no}")
    client.set_fourcc("cwi1")
    client.start()
    rng = np.random.default_rng(5)
    packets = [rng.bytes(int(n)) for n in (1, 17, 4096, 100000, 3)]
    feeder = threading.Thread(target=lambda: [server.feed(p) for p in packets])
    try:
        feeder.start()
        got = _drain(client, len(packets))
    finally:
        feeder.join(timeout=TIMEOUT)
        client.stop()
        server.stop()
    assert not feeder.is_alive() and not client.is_alive()
    assert got == packets


def test_encoded_clouds_cross_the_socket_pair():
    pts = [_points(4000, seed) for seed in range(3)]
    port_no = _free_port()
    rawsink = sink_netserver.cwipc_sink_netserver(port_no, nodrop=True)
    sink = sink_encoder.cwipc_sink_encoder(rawsink, nodrop=True)
    sink.set_encoder_params([{}], octree_bits=9)
    done = threading.Event()

    class Producer:
        ident = 1

        def is_alive(self):
            return not done.is_set()

    sink.set_producer(Producer())
    sink.start()
    source = source_decoder.cwipc_activesource_decoder(
        source_netclient.cwipc_source_netclient(f"127.0.0.1:{port_no}"), device="cpu")
    source.start()
    try:
        for i, p in enumerate(pts):
            sink.feed(port.cwipc_from_numpy_array(p, 1000 + i, device="cpu"))
        got = _drain(source, len(pts))
    finally:
        done.set()
        source.stop()
        sink.stop()
    assert len(got) == len(pts)
    for i, (pc, p) in enumerate(zip(got, pts)):
        enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=9))
        enc.feed(port.cwipc_from_numpy_array(p, 1000 + i, device="cpu"))
        blob = enc.get_bytes()
        solo = codec.cwipc_new_decoder(device="cpu")
        solo.feed(blob)
        want = solo.get()
        assert pc._device.type == "cpu" and pc.timestamp() == 1000 + i
        assert pc.count() == want.count() and pc.get_bytes() == want.get_bytes()
        jdec = jcodec.cwipc_new_decoder()
        jdec.feed(blob)
        assert jdec.get().get_bytes() == want.get_bytes()


def _proxy_packet(records, ts, cellsize=0.05):
    payload = b"".join(struct.pack("<fffBBBB", *r) for r in records)
    return struct.pack("<IIQfI", proxy.CWIPC_POINT_PACKETHEADER_MAGIC, len(payload), ts, cellsize, 0) + payload


def test_proxy_ack_latest_wins_and_bad_magic():
    port_no = _free_port()
    src = port.cwipc_proxy("127.0.0.1", port_no, device="cpu")
    try:
        conn = socket.create_connection(("127.0.0.1", port_no), timeout=5)
        records = {ts: [(1.0, 2.0, 3.0, 10, 20, 30, ts % 5), (-0.5, 0.25, 4.0, 1, 2, 3, 7)] for ts in (1111, 2222)}
        for ts in (1111, 2222):  # the second cloud replaces the first
            conn.sendall(_proxy_packet(records[ts], ts))
            assert struct.unpack("<Q", conn.recv(8))[0] == ts
        assert src.available(True)
        pc = src.get()
        assert pc.timestamp() == 2222 and pc.count() == 2 and pc._device.type == "cpu"
        assert np.isclose(pc.cellsize(), 0.05)
        assert pc.get_bytes() == b"".join(struct.pack("<fffBBBB", *r) for r in records[2222])
        conn.close()
        conn = socket.create_connection(("127.0.0.1", port_no), timeout=5)
        conn.sendall(struct.pack("<IIQfI", 0xDEADBEEF, 16, 1, 0.0, 0))
        conn.settimeout(5)
        assert conn.recv(8) == b""  # the server drops the connection
        conn.close()
        assert not src.available(False)
    finally:
        src.stop()
    assert not src.is_alive()


class ListSource:
    def __init__(self, pcs):
        self.pcs = list(pcs)

    def start(self):
        return True

    def stop(self):
        pass

    def eof(self):
        return not self.pcs

    def available(self, wait=False):
        return bool(self.pcs)

    def get(self):
        return self.pcs.pop(0) if self.pcs else None

    def statistics(self):
        pass


def test_synchronizer_fuses_as_jax():
    pts = _points(3000, 9)
    fused = {}
    for name, pkg, mod, kw in (("port", port, source_synchronizer, {"device": "cpu"}), ("jax", jc, j_sync, {})):
        def tile_pc(ts, tile):
            pc = pkg.cwipc_tilefilter(pkg.cwipc_from_numpy_array(pts, 0, **kw), tile)
            pc._set_timestamp(ts)
            return pc

        sync = mod.cwipc_source_synchronizer(None, [ListSource([tile_pc(100, 1), tile_pc(200, 1)]),
                                                    ListSource([tile_pc(100, 2), tile_pc(200, 2)])])
        sync.start()
        try:
            fused[name] = _drain(sync, 2)
        finally:
            sync.stop()
        assert not sync.is_alive()
    assert len(fused["port"]) == len(fused["jax"]) == 2
    for got, want in zip(fused["port"], fused["jax"]):
        assert got.timestamp() == want.timestamp() and got.count() == len(pts)
        assert got.get_bytes() == want.get_bytes()
        assert set(np.unique(got.get_numpy_array()["tile"])) == {1, 2}
    assert fused["port"][0].timestamp() == 100
