"""TCP client rawsource: connect, read 16-byte frames, queue payloads.

The port of cwipc_util_tpu/net/source_netclient.py, host code copied
unchanged: it reads the JAX package's frames, and the JAX netclient reads
the port's.

Re-implementation of the reference's netclient
(reference: python/cwipc/net/source_netclient.py): a thread connects to
host:port, reads the ``=LLQ`` frame header + payload, checks the fourcc and
pushes payloads into a bounded PeekQueue.  Connection-refused counts as EOF
(failure-tolerance contract, source_netclient.py:122-126); switchport()
reconnects for quality switching.

The multi-tile variant opens one client per tile at
port + tile*nQuality + quality (source_netclient.py:201-252).
"""

from __future__ import annotations

import queue
import select
import socket
import struct
import threading
import time
from typing import List, Optional

from ..utils.stats import Stats
from .abstract import (
    VRT_4CC,
    cwipc_activerawmultisource_abstract,
    cwipc_activerawsource_abstract,
    cwipc_multistream_description,
    cwipc_rawsource_abstract,
    vrt_fourcc_type,
)
from .peek_queue import PeekQueue
from .sink_netserver import HEADER_FORMAT, HEADER_SIZE


class _NetClientSource(threading.Thread, cwipc_activerawsource_abstract):
    QUEUE_SIZE = 2

    def __init__(self, address: str, verbose: bool = False):
        threading.Thread.__init__(self, daemon=True)
        self.name = f"cwipc_util_tpu_torch._NetClientSource:{address}"
        host, _, port = address.partition(":")
        self.host = host or "localhost"
        self.port = int(port or 4303)
        self.verbose = verbose
        self.fourcc: int = 0
        self.queue: PeekQueue = PeekQueue(maxsize=self.QUEUE_SIZE)
        self.running = False
        self._eof = False
        self.sock: Optional[socket.socket] = None
        self._switch_lock = threading.Lock()
        self._pending_sock: Optional[socket.socket] = None
        self._pending_port: Optional[int] = None
        # self-pipe so switchport()/stop() can wake the reader's select()
        self._wake_r, self._wake_w = socket.socketpair()
        self.stats = Stats(f"netclient:{self.host}:{self.port}")

    def set_fourcc(self, fourcc: vrt_fourcc_type) -> None:
        self.fourcc = VRT_4CC(fourcc)

    def start(self) -> bool:
        # idempotent: tiled factories start clients for stream discovery and
        # the synchronizer's start cascade reaches them again
        if self.running:
            return True
        self.running = True
        threading.Thread.start(self)
        return True

    def stop(self) -> None:
        self.running = False
        with self._switch_lock:
            for s in (self.sock, self._pending_sock):
                if s:
                    try:
                        s.close()
                    except OSError:
                        pass
            self.sock = None
            self._pending_sock = None
            self._wake()
        if self.is_alive():
            self.join(timeout=2)
        if not self.is_alive():
            for s in (self._wake_r, self._wake_w):
                try:
                    s.close()
                except OSError:
                    pass

    def switchport(self, port: int) -> None:
        """Switch to a different port (quality switching), make-before-break.

        The reference reconnects by closing the live socket and dialing the
        new port from the reader thread (reference:
        python/cwipc/net/source_netclient.py:110-116,246-251), which leaves
        a window where the stream is dark and a loaded host can blow any
        drain deadline.  Here the NEW connection is established first, the
        reader drains BOTH sockets, and cutover happens deterministically on
        the first frame the new socket delivers: the old socket is closed
        and frames older than the last delivered timestamp are dropped at
        the seam, so a switch is an ordered stream event with no gap.
        """
        # Dial OUTSIDE the lock: the reader takes _switch_lock every loop
        # iteration, so a blocking connect under the lock would stall the
        # live stream for up to the 5 s dial timeout — exactly the dark
        # window make-before-break exists to remove.
        with self._switch_lock:
            if port == self.port and self._pending_sock is None:
                return
        try:
            new_sock = socket.create_connection((self.host, port), timeout=5)
            new_sock.settimeout(None)
        except OSError:
            if self.verbose:
                print(f"netclient: switch to port {port} refused; keeping {self.port}")
            return
        with self._switch_lock:
            if port == self.port and self._pending_sock is None:
                # a concurrent cutover landed us on this port already
                try:
                    new_sock.close()
                except OSError:
                    pass
                return
            if self._pending_sock is not None:
                # a switch superseding an un-cut-over switch: replace it
                try:
                    self._pending_sock.close()
                except OSError:
                    pass
            self._pending_sock = new_sock
            self._pending_port = port
            self._wake()

    def _wake(self) -> None:
        """Nudge the reader thread out of its select()."""
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def eof(self) -> bool:
        return self._eof and self.queue.empty()

    def available(self, wait: bool = False) -> bool:
        if not self.queue.empty():
            return True
        if wait and not self._eof:
            return self.queue.dont_get(timeout=2.0) is not None
        return False

    def get(self) -> Optional[bytes]:
        if self.eof():
            return None
        return self.queue.get()

    def _connect(self) -> Optional[socket.socket]:
        try:
            sock = socket.create_connection((self.host, self.port), timeout=5)
            sock.settimeout(None)  # connect timeout only; streams may idle
            return sock
        except OSError:
            return None

    def _recv_all(self, sock: socket.socket, n: int) -> Optional[bytes]:
        chunks = []
        remaining = n
        while remaining > 0:
            chunk = sock.recv(remaining)
            if not chunk:
                return None
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def _read_frame(self, sock: socket.socket):
        """One framed packet off `sock`: (timestamp, payload) or None."""
        try:
            hdr = self._recv_all(sock, HEADER_SIZE)
            if hdr is None:
                return None
            fourcc, length, timestamp = struct.unpack(HEADER_FORMAT, hdr)
            if self.fourcc and fourcc != self.fourcc:
                print(f"netclient: unexpected fourcc 0x{fourcc:08x}")
                return None
            payload = self._recv_all(sock, length)
            if payload is None:
                return None
            return timestamp, payload
        except OSError:
            return None

    def _put_payload(self, payload: bytes) -> bool:
        """Queue put that stays responsive to stop(): an unbounded put()
        could block forever on a stalled consumer, leaving the thread
        unjoinable and _eof never set."""
        while self.running:
            try:
                self.queue.put(payload, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def run(self) -> None:
        try:
            self._run_reader()
        finally:
            self._eof = True
            with self._switch_lock:
                pending = self._pending_sock
                self._pending_sock = None
            for s in (self.sock, pending):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

    def _run_reader(self) -> None:
        sock = self._connect()
        if sock is None:
            # connection refused counts as EOF
            if self.verbose:
                print(f"netclient: connection to {self.host}:{self.port} refused")
            return
        self.sock = sock
        last_ts = 0
        seam_ts = None  # dedup gate, active only across a quality cutover
        while self.running:
            with self._switch_lock:
                pending = self._pending_sock
            waitset = [sock, self._wake_r] + ([pending] if pending else [])
            try:
                readable, _, _ = select.select(waitset, [], [], 1.0)
            except (OSError, ValueError):
                # a superseding switchport() may have closed the pending
                # socket we snapshot — that must not kill the live stream
                with self._switch_lock:
                    superseded = pending is not None and pending is not self._pending_sock
                if superseded:
                    continue
                break
            if self._wake_r in readable:
                try:
                    self._wake_r.recv(4096)
                except OSError:
                    pass
                continue  # re-evaluate pending / running
            if pending and pending in readable:
                # Cutover: the new-quality stream has its first frame —
                # from here on it is the stream.  Frames at or before the
                # last delivered timestamp (still queued in the kernel from
                # the overlap window) are dropped at the seam.
                frame = self._read_frame(pending)
                with self._switch_lock:
                    if pending is not self._pending_sock:
                        # superseded while reading: a newer switch owns the
                        # pending slot now; abandon this socket untouched
                        continue
                    if frame is None:
                        # the new stream died before delivering: drop the
                        # switch, keep the live stream (like a refused dial)
                        self._pending_sock = None
                        self._pending_port = None
                    else:
                        self._pending_sock = None
                        if self._pending_port is not None:
                            self.port = self._pending_port
                            self._pending_port = None
                if frame is None:
                    try:
                        pending.close()
                    except OSError:
                        pass
                    continue
                try:
                    sock.close()
                except OSError:
                    pass
                sock = pending
                self.sock = sock
                seam_ts = last_ts
                ts, payload = frame
                if ts > seam_ts:
                    seam_ts = None
                    last_ts = ts
                    self.stats.add("packetsize", len(payload), isInt=True)
                    self.stats.add("latency", max(0.0, time.time() - ts / 1000.0))
                    if not self._put_payload(payload):
                        break
                continue
            if sock not in readable:
                continue
            frame = self._read_frame(sock)
            if frame is None:
                # current stream ended; if a switch is pending, promote it
                # (make-before-break also covers source-side stream ends)
                with self._switch_lock:
                    pending = self._pending_sock
                    self._pending_sock = None
                    if pending is not None and self._pending_port is not None:
                        self.port = self._pending_port
                        self._pending_port = None
                if pending is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = pending
                    self.sock = sock
                    continue
                break
            ts, payload = frame
            if seam_ts is not None:
                # duplicates of frames already delivered before the
                # cutover (buffered during the overlap window)
                if ts <= seam_ts:
                    continue
                seam_ts = None
            last_ts = ts
            self.stats.add("packetsize", len(payload), isInt=True)
            self.stats.add("latency", max(0.0, time.time() - ts / 1000.0))
            if not self._put_payload(payload):
                break
        self.sock = sock  # the finally block closes the live socket

    def statistics(self) -> None:
        self.stats.print()


class _NetClientMultiSource(cwipc_activerawmultisource_abstract):
    """One netclient per tile; port block = base + tile*nQuality + quality."""

    def __init__(self, address: str, nTile: int, nQuality: int, verbose: bool = False):
        host, _, port = address.partition(":")
        self.host = host or "localhost"
        self.base_port = int(port or 4303)
        self.nTile = nTile
        self.nQuality = nQuality
        self.verbose = verbose
        self.sources: List[_NetClientSource] = [
            _NetClientSource(f"{self.host}:{self.base_port + t * nQuality}", verbose)
            for t in range(nTile)
        ]

    def start(self) -> bool:
        return all(s.start() for s in self.sources)

    def stop(self) -> None:
        for s in self.sources:
            s.stop()

    def get_tile_count(self) -> int:
        return self.nTile

    def get_description(self) -> cwipc_multistream_description:
        return [
            [dict(quality=q) for q in range(self.nQuality)] for _ in range(self.nTile)
        ]

    def get_tile_source(self, tileIdx: int) -> cwipc_rawsource_abstract:
        return self.sources[tileIdx]

    def select_tile_quality(self, tileIdx: int, qualityIdx: int) -> None:
        port = self.base_port + tileIdx * self.nQuality + qualityIdx
        self.sources[tileIdx].switchport(port)

    def statistics(self) -> None:
        for s in self.sources:
            s.statistics()


def cwipc_source_netclient(address: str, verbose: bool = False) -> cwipc_activerawsource_abstract:
    """Rawsource reading frames from a cwipc netserver at host:port."""
    return _NetClientSource(address, verbose=verbose)


def cwipc_multisource_netclient(
    address: str, nTile: int, nQuality: int, verbose: bool = False
) -> cwipc_activerawmultisource_abstract:
    """Tiled rawsource: one TCP stream per tile with quality switching."""
    return _NetClientMultiSource(address, nTile, nQuality, verbose=verbose)
