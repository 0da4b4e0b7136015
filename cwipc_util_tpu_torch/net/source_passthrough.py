"""Uncompressed passthrough source: rawsource "cwi0" packets -> clouds.

Counterpart of sink_passthrough (reference:
python/cwipc/net/source_passthrough.py): deserializes raw cwipc packets
with cwipc_from_packet.

The port of cwipc_util_tpu/net/source_passthrough.py.  Clouds are
host-backed and build their buffer on the ``device`` the factory was given
(``None`` means CUDA).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from ..abstract import cwipc_activesource_abstract
from ..core.buffers import resolve_device
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..io.dump import pointcloud_from_packet
from ..utils.stats import Stats
from .abstract import cwipc_activerawsource_abstract, cwipc_rawsource_abstract


# Module-level stream fourcc (reference module scope)
FOURCC = "cwi0"


class _NetPassthrough(threading.Thread, cwipc_activesource_abstract):
    FOURCC = "cwi0"

    def __init__(self, source: cwipc_rawsource_abstract, verbose: bool = False, device=None):
        threading.Thread.__init__(self, daemon=True)
        self.name = "cwipc_util_tpu_torch._NetPassthrough"
        self.source = source
        self.source.set_fourcc(self.FOURCC)
        self.verbose = verbose
        self.device = resolve_device(device)
        self.running = False
        self.output_queue: "queue.Queue[Optional[cwipc_pointcloud_wrapper]]" = queue.Queue(maxsize=2)
        self.stats = Stats("netpassthrough")

    def free(self, *, force: bool = False) -> None:
        self.stop()

    def start(self) -> bool:
        # idempotent: factories may start sources for discovery before a
        # downstream start cascade reaches them again
        if self.running:
            return True
        self.running = True
        threading.Thread.start(self)
        if isinstance(self.source, cwipc_activerawsource_abstract):
            self.source.start()
        return True

    def stop(self) -> None:
        self.running = False
        if isinstance(self.source, cwipc_activerawsource_abstract):
            self.source.stop()
        try:
            self.output_queue.put(None, block=False)
        except queue.Full:
            pass
        if self.is_alive():
            self.join(timeout=2)

    def eof(self) -> bool:
        # not EOF while decoded clouds are still queued
        return self.output_queue.empty() and (not self.running or self.source.eof())

    def available(self, wait: bool = False) -> bool:
        # queued clouds stay available even after the thread has finished
        if not self.output_queue.empty():
            return True
        if not self.running:
            return False
        return self.source.available(wait)

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        if self.eof():
            return None
        return self.output_queue.get()

    def run(self) -> None:
        try:
            while self.running:
                if self.source.eof():
                    break
                packet = self.source.get()
                if not packet:
                    break
                t0 = time.time()
                pc = pointcloud_from_packet(packet, self.device)
                self.stats.add("parse_duration", time.time() - t0)
                self.stats.add("pointcount", pc.count(), isInt=True)
                if not self._put_bounded(pc):
                    break
        finally:
            # liveness: wake a consumer blocked in get() when this thread
            # exits on its own (EOF), not only via stop()
            self.running = False
            try:
                self.output_queue.put(None, block=False)
            except queue.Full:
                pass

    def _put_bounded(self, pc: cwipc_pointcloud_wrapper) -> bool:
        """put that stays responsive to stop(); frees the cloud when the
        consumer is gone."""
        while self.running:
            try:
                self.output_queue.put(pc, timeout=0.1)
                return True
            except queue.Full:
                continue
        pc.free()
        return False

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
        self.stats.print()
        self.source.statistics()


def cwipc_activesource_passthrough(
    source: cwipc_activerawsource_abstract, verbose: bool = False, device=None
):
    """Active source deserializing raw cwipc packets from an active
    rawsource (reference: net/source_passthrough.py:150-153)."""
    return _NetPassthrough(source, verbose=verbose, device=device)


def cwipc_source_passthrough(source: cwipc_rawsource_abstract, verbose: bool = False, device=None):
    """Source deserializing raw cwipc packets from a rawsource."""
    return _NetPassthrough(source, verbose=verbose, device=device)
