"""Uncompressed passthrough sink: clouds -> raw cwipc packets -> rawsink.

Same shape as the encoder sink but serializes with get_packet() (fourcc
"cwi0"; reference: python/cwipc/net/sink_passthrough.py).

The port of cwipc_util_tpu/net/sink_passthrough.py.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.stats import Stats
from .abstract import cwipc_rawsink_abstract, cwipc_sink_abstract


class _Sink_Passthrough(threading.Thread, cwipc_sink_abstract):
    FOURCC = "cwi0"
    QUEUE_FULL_TIMEOUT = 0.001

    def __init__(self, sink: cwipc_rawsink_abstract, verbose: bool = False, nodrop: bool = False):
        threading.Thread.__init__(self, daemon=True)
        self.name = "cwipc_util_tpu_torch._Sink_Passthrough"
        self.sink = sink
        self.sink.set_fourcc(self.FOURCC)
        self.verbose = verbose
        self.nodrop = nodrop
        self.producer = None
        self.input_queue: "queue.Queue[Optional[cwipc_pointcloud_wrapper]]" = queue.Queue(maxsize=2)
        self.stopped = False
        self.started = False
        self.stats = Stats("passthrough")

    def set_producer(self, producer) -> None:
        self.producer = producer
        self.sink.set_producer(producer)

    def start(self) -> None:
        threading.Thread.start(self)
        self.sink.start()
        self.started = True

    def stop(self) -> None:
        # Drain the backlog before stopping (see sink_encoder.stop).
        if self.started and self.is_alive():
            try:
                self.input_queue.put(None, timeout=30)
            except queue.Full:
                self.stopped = True
            self.join(timeout=120)
        self.stopped = True

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        try:
            if self.nodrop:
                # blocking, but responsive to a dead worker (see
                # sink_encoder.feed): an unbounded put() would deadlock the
                # producer if run() exited on an error
                while not self.stopped and (not self.started or self.is_alive()):
                    try:
                        self.input_queue.put(pc, timeout=0.5)
                        return
                    except queue.Full:
                        continue
                if self.verbose:
                    print("passthrough: worker stopped, dropping cloud")
            else:
                self.input_queue.put(pc, timeout=self.QUEUE_FULL_TIMEOUT)
        except queue.Full:
            if self.verbose:
                print("passthrough: queue full, dropping cloud")

    def run(self) -> None:
        try:
            while not self.stopped:
                producer_done = (
                    self.producer is not None
                    and self.producer.ident is not None  # has started
                    and not self.producer.is_alive()
                )
                if producer_done and self.input_queue.empty():
                    break
                try:
                    pc = self.input_queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if pc is None:
                    break
                t0 = time.time()
                packet = pc.get_packet()
                self.stats.add("serialize_duration", time.time() - t0)
                self.stats.add("packetsize", len(packet), isInt=True)
                self.sink.feed(packet, stream_index=0)
                pc.free()
        finally:
            self.stopped = True
            self.sink.stop()

    def statistics(self) -> None:
        self.stats.print()
        self.sink.statistics()


def cwipc_sink_passthrough(sink: cwipc_rawsink_abstract, verbose: bool = False, nodrop: bool = False) -> "_Sink_Passthrough":
    """Sink that forwards raw (uncompressed) cwipc packets to a rawsink."""
    return _Sink_Passthrough(sink, verbose=verbose, nodrop=nodrop)
