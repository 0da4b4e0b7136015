"""Decoder source: rawsource bytes -> codec decoder -> pointcloud queue.

Re-implementation of the reference's decoder source
(reference: python/cwipc/net/source_decoder.py): a thread pulls compressed
packets from a rawsource, decodes them and queues the clouds; active and
passive factory variants.

The port of cwipc_util_tpu/net/source_decoder.py.  Decoded clouds are
host-backed and build their buffer on the ``device`` the factory was given
(``None`` means CUDA).  ``start`` starts an active source before the
decoding thread, not after it as the JAX package does: a DASH player that
has not started yet returns None from ``get``, which the thread took for
the end of the stream, so ``view --lldplay`` decoded no frame.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from .. import codec
from ..abstract import cwipc_activesource_abstract
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.stats import Stats
from .abstract import cwipc_activerawsource_abstract, cwipc_rawsource_abstract


# Module-level stream fourcc (reference module scope)
FOURCC = "cwi1"


class _NetDecoder(threading.Thread, cwipc_activesource_abstract):
    FOURCC = "cwi1"

    def __init__(self, source: cwipc_rawsource_abstract, verbose: bool = False, device=None):
        threading.Thread.__init__(self, daemon=True)
        self.name = "cwipc_util_tpu_torch._NetDecoder"
        self.source = source
        self.source.set_fourcc(self.FOURCC)
        self.verbose = verbose
        self.running = False
        self.output_queue: "queue.Queue[Optional[cwipc_pointcloud_wrapper]]" = queue.Queue(maxsize=2)
        self.decoder = codec.cwipc_new_decoder(device)
        self.stats = Stats("netdecoder")

    def free(self, *, force: bool = False) -> None:
        self.stop()

    def start(self) -> bool:
        # idempotent: factories may start sources for discovery before a
        # downstream start cascade reaches them again
        if self.running:
            return True
        # the source first: one that has not started has nothing to get
        # yet, and this thread would take its None for the end of the stream
        if isinstance(self.source, cwipc_activerawsource_abstract):
            self.source.start()
        self.running = True
        threading.Thread.start(self)
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
                cpc = self.source.get()
                if not cpc:
                    break
                t0 = time.time()
                self.decoder.feed(cpc)
                pc = self.decoder.get() if self.decoder.available(True) else None
                self.stats.add("decode_duration", time.time() - t0)
                if pc is None:
                    continue
                self.stats.add("pointcount", pc.count(), isInt=True)
                if not self._put_bounded(pc):
                    break
        finally:
            # liveness: a consumer blocked in get() on an empty queue must
            # wake when this thread exits on its own (EOF), not only via
            # stop() — without the sentinel it would wait forever
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

    # tiling/config stubs (decoded streams carry no camera interface)
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


def cwipc_activesource_decoder(source: cwipc_activerawsource_abstract, verbose: bool = False, device=None):
    """Active source decoding compressed packets from an active rawsource."""
    return _NetDecoder(source, verbose=verbose, device=device)


def cwipc_source_decoder(source: cwipc_rawsource_abstract, verbose: bool = False, device=None):
    """Source decoding compressed packets from a (passive) rawsource."""
    return _NetDecoder(source, verbose=verbose, device=device)
