"""TCP serving rawsink: listen, accept N clients, fan every packet out.

The port of cwipc_util_tpu/net/sink_netserver.py, host code copied
unchanged: the frames on the wire are the JAX package's, byte for byte.

Re-implementation of the reference's netserver sink
(reference: python/cwipc/net/sink_netserver.py): a select() loop accepts
connections and sends every fed packet to all connected clients, dropping
broken sockets but continuing to serve the rest (the failure-tolerance
contract, SURVEY.md §5.3).  Wire format: 16-byte ``=LLQ`` frame header
(fourcc, length, timestamp_ms) + payload (sink_netserver.py:161-165).

The multi-stream variant serves stream i on port base+i (one listening
socket per (tile, quality) stream, source_netclient.py:203-218 reads them).
"""

from __future__ import annotations

import select
import socket
import struct
import threading
import time
from typing import List, Optional, Union

from ..utils.stats import Stats
from .abstract import (
    VRT_4CC,
    cwipc_quality_description,
    cwipc_rawsink_abstract,
    cwipc_tileinfo_dict,
    vrt_fourcc_type,
)

HEADER_FORMAT = "<LLQ"
HEADER_SIZE = struct.calcsize(HEADER_FORMAT)
assert HEADER_SIZE == 16


def pack_frame(fourcc: int, payload: Union[bytes, bytearray], timestamp_ms: int = 0) -> bytes:
    return struct.pack(HEADER_FORMAT, fourcc, len(payload), timestamp_ms) + bytes(payload)


class _SingleServer(threading.Thread):
    """One listening port; fans packets out to all connected clients."""

    SELECT_TIMEOUT = 0.1

    def __init__(self, port: int, verbose: bool = False,
                 any_client: Optional[threading.Event] = None):
        super().__init__(daemon=True)
        self.name = f"cwipc_util_tpu_torch._Sink_NetServer:{port}"
        self.port = port
        self.verbose = verbose
        self.stopped = False
        self.clients: List[socket.socket] = []
        self.had_client = False
        # shared across the streams of one multi-server: set when ANY
        # stream accepts its first consumer
        self.any_client = any_client if any_client is not None else threading.Event()
        self.queue_lock = threading.Lock()
        self.pending: List[bytes] = []
        self.nodrop = False
        self.stats = Stats(f"netserver:{port}")
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("", port))
        self.sock.listen(4)
        self.sock.setblocking(False)
        # self-pipe: send() pokes the select() so a queued packet flushes
        # immediately instead of waiting out the 0.1 s poll (up to 100 ms
        # added latency per frame otherwise)
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)  # a full pipe means a wake is already queued

    def run(self) -> None:
        while not self.stopped:
            rlist = [self.sock, self._wake_r]
            select.select(rlist, [], [], self.SELECT_TIMEOUT)
            try:
                self._wake_r.recv(4096)
            except OSError:
                pass
            # accept any waiting connections
            while True:
                try:
                    conn, addr = self.sock.accept()
                    conn.setblocking(True)
                    self.clients.append(conn)
                    self.had_client = True
                    self.any_client.set()
                    if self.verbose:
                        print(f"netserver: accepted connection from {addr}")
                except (BlockingIOError, OSError):
                    break
            self._flush()
        for c in self.clients:
            try:
                c.close()
            except OSError:
                pass
        self.sock.close()
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _flush(self) -> None:
        if self.nodrop and not self.clients and not self.had_client:
            # nodrop stream that never had a consumer: hold the (bounded)
            # backlog so a late subscriber still gets the early frames —
            # draining here would silently discard them
            return
        with self.queue_lock:
            packets, self.pending = self.pending, []
        for packet in packets:
            t0 = time.time()
            dead: List[socket.socket] = []
            for c in self.clients:
                try:
                    c.sendall(packet)
                except OSError:
                    dead.append(c)
            for c in dead:
                if self.verbose:
                    print("netserver: dropping broken client connection")
                self.clients.remove(c)
                try:
                    c.close()
                except OSError:
                    pass
            if self.clients:
                self.stats.add("send_duration", time.time() - t0)
                self.stats.add("packetsize", len(packet), isInt=True)

    RING = 64  # late-subscriber backlog for nodrop streams without a consumer

    def send(self, packet: bytes) -> bool:
        if self.nodrop:
            # nodrop semantics: block until the FIRST consumer of the whole
            # sink connects (startup backlog for every stream), then apply
            # backpressure only on streams with a live consumer.  Streams
            # nobody subscribes to (e.g. unselected qualities of a
            # multi-quality encoder) must NOT block the producer: they keep
            # a bounded ring of the newest packets, which _flush() holds
            # until a late subscriber arrives (the reference's server
            # drains its queue once consumers exist, sink_netserver.py:85-158).
            while not self.stopped and not self.any_client.is_set():
                time.sleep(0.05)
            while not self.stopped and self.clients and len(self.pending) >= 8:
                time.sleep(0.05)
            if self.stopped:
                return False
            with self.queue_lock:
                if not self.clients and not self.had_client and len(self.pending) >= self.RING:
                    self.pending.pop(0)  # bounded ring: keep the newest
                self.pending.append(packet)
            self._wake()
            return True
        with self.queue_lock:
            if len(self.pending) >= 2:
                self.stats.add("dropped", 1, isInt=True)
                return False
            self.pending.append(packet)
        self._wake()
        return True

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def stop(self) -> None:
        self.stopped = True
        self._wake()


class _Sink_NetServer(cwipc_rawsink_abstract):
    """Rawsink serving one or more streams over TCP ports base..base+n-1."""

    def __init__(self, port: int, verbose: bool = False, nodrop: bool = False):
        self.base_port = port
        self.verbose = verbose
        self.nodrop = nodrop
        self.fourcc: int = 0
        self.producer = None
        self.servers: List[_SingleServer] = []
        self.started = False
        self._any_client = threading.Event()

    def set_fourcc(self, fourcc: vrt_fourcc_type) -> None:
        self.fourcc = VRT_4CC(fourcc)

    def set_producer(self, producer) -> None:
        self.producer = producer

    def add_stream(
        self,
        tilenum: Optional[int] = None,
        tiledesc: Optional[cwipc_tileinfo_dict] = None,
        qualitydesc: Optional[cwipc_quality_description] = None,
    ) -> int:
        index = len(self.servers)
        server = _SingleServer(self.base_port + index, self.verbose,
                               any_client=self._any_client)
        server.nodrop = self.nodrop
        self.servers.append(server)
        if self.started:
            server.start()
        return index

    def start(self) -> None:
        if not self.servers:
            self.add_stream()
        for s in self.servers:
            if not s.is_alive():
                s.start()
        self.started = True

    def stop(self) -> None:
        for s in self.servers:
            s.stop()
        for s in self.servers:
            if s.is_alive():
                s.join(timeout=2)

    def feed(self, buffer: Union[bytes, bytearray], stream_index: Optional[int] = None) -> bool:
        idx = stream_index or 0
        if idx >= len(self.servers):
            return False
        packet = pack_frame(self.fourcc, buffer, int(time.time() * 1000))
        return self.servers[idx].send(packet)

    def statistics(self) -> None:
        for s in self.servers:
            s.stats.print()


def cwipc_sink_netserver(port: int, verbose: bool = False, nodrop: bool = False) -> cwipc_rawsink_abstract:
    """Rawsink that serves packets to any client connecting on `port`."""
    return _Sink_NetServer(port, verbose=verbose, nodrop=nodrop)
