"""Proxy TCP receiver source (the reference's C-NET component).

The port of cwipc_util_tpu/net/proxy.py.  The 16-byte records of each
packet become a host-backed cloud on the ``device`` the source was given
(``None`` means CUDA), uploaded once when an op first uses it.

Re-implementation of cwipc_proxy (reference: src/cwipc_proxy.cpp:158-336):
binds host:port, a server thread accepts one connection at a time, reads a
24-byte legacy packet header (magic 0x20201016), receives the point
payload, builds a cloud and hands it to the consumer with latest-wins
semantics (an unconsumed cloud is replaced by a newer one), then echoes the
timestamp back as an ack.  After peer disconnect it re-accepts.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

import numpy as np

from ..abstract import cwipc_activesource_abstract
from ..core.buffers import POINT_DTYPE, POINT_SIZE, resolve_device
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper

CWIPC_POINT_PACKETHEADER_MAGIC = 0x20201016
# magic u32, dataCount u32, timestamp u64, cellsize f32, unused u32 = 24 B
_PKT_FMT = "<IIQfI"
_PKT_SIZE = struct.calcsize(_PKT_FMT)
assert _PKT_SIZE == 24


class _ProxySource(threading.Thread, cwipc_activesource_abstract):
    def __init__(self, host: str, port: int, verbose: bool = False, device=None):
        threading.Thread.__init__(self, daemon=True)
        self.device = resolve_device(device)
        self.name = f"cwipc_util_tpu_torch._ProxySource:{port}"
        self.verbose = verbose
        self.running = True
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pc: Optional[cwipc_pointcloud_wrapper] = None
        self._conn: Optional[socket.socket] = None  # accepted peer, for stop()
        try:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.sock.bind((host, port))
            self.sock.listen(1)
            self.sock.settimeout(0.5)
        except OSError as e:
            raise CwipcError(f"cwipc_proxy: cannot bind {host}:{port}: {e}") from e
        threading.Thread.start(self)

    def free(self, *, force: bool = False) -> None:
        self.stop()

    def start(self) -> bool:
        return True

    def stop(self) -> None:
        self.running = False
        try:
            self.sock.close()
        except OSError:
            pass
        # also close the accepted connection: a silent peer would otherwise
        # keep the thread blocked in recv() past the join timeout
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        with self._cond:
            if self._pc is not None:
                self._pc.free()
                self._pc = None
            self._cond.notify_all()
        if self.is_alive():
            self.join(timeout=2)

    def eof(self) -> bool:
        return not self.running

    def available(self, wait: bool = False) -> bool:
        with self._cond:
            if self._pc is not None:
                return True
            if wait and self.running:
                self._cond.wait(timeout=2.0)
                return self._pc is not None
            return False

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        with self._cond:
            while self._pc is None and self.running:
                self._cond.wait(timeout=0.5)
            pc, self._pc = self._pc, None
            return pc

    def _recv_all(self, conn: socket.socket, n: int) -> Optional[bytes]:
        chunks = []
        remaining = n
        while remaining > 0:
            try:
                chunk = conn.recv(remaining)
            except OSError:
                return None
            if not chunk:
                return None
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def run(self) -> None:
        while self.running:
            try:
                conn, addr = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            if self.verbose:
                print(f"proxy: accepted connection from {addr}")
            self._conn = conn
            while self.running:
                hdr = self._recv_all(conn, _PKT_SIZE)
                if hdr is None:
                    break
                magic, dataCount, timestamp, cellsize, _ = struct.unpack(_PKT_FMT, hdr)
                if magic != CWIPC_POINT_PACKETHEADER_MAGIC:
                    if self.verbose:
                        print(f"proxy: bad magic 0x{magic:08x}")
                    break
                payload = self._recv_all(conn, dataCount)
                if payload is None or dataCount % POINT_SIZE != 0:
                    break
                # host-backed: the packet bytes ARE the POINT_DTYPE
                # layout; the device buffer is built on first use
                pts = np.frombuffer(payload, dtype=POINT_DTYPE).copy()
                pc = cwipc_pointcloud_wrapper(
                    None, timestamp, cellsize, _host_points=pts, device=self.device
                )
                with self._cond:
                    if not self.running:
                        # a frame completing after stop() must not publish
                        # a cloud nothing will ever free
                        pc.free()
                        break
                    # latest-wins: replace an unconsumed cloud
                    if self._pc is not None:
                        self._pc.free()
                    self._pc = pc
                    self._cond.notify_all()
                try:
                    conn.sendall(struct.pack("<Q", timestamp))
                except OSError:
                    break
            self._conn = None
            try:
                conn.close()
            except OSError:
                pass

    def seek(self, timestamp: int) -> bool:
        return False

    def maxtile(self) -> int:
        return 1

    def get_tileinfo_dict(self, tilenum: int) -> dict:
        return {}

    def reload_config(self, config) -> None:
        return None

    def get_config(self) -> bytes:
        return b""

    def request_metadata(self, name: str) -> None:
        pass

    def is_metadata_requested(self, name: str) -> bool:
        return False

    def auxiliary_operation(self, op: str, inbuf: bytes, outbuf: bytearray) -> bool:
        return False

    def statistics(self) -> None:
        pass


def cwipc_proxy_source(host: str, port: int, verbose: bool = False, device=None) -> cwipc_activesource_abstract:
    """Source receiving proxy packets on host:port, its clouds on ``device``
    (``None`` means CUDA)."""
    return _ProxySource(host or "", port, verbose=verbose, device=device)
