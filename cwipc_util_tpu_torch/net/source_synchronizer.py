"""Tile synchronizer: merge N per-tile cloud streams into one fused stream.

The port of cwipc_util_tpu/net/source_synchronizer.py: the stream-timing
control plane is host code, copied; the fusion is the port's
``cwipc_join``, on the clouds' device, with the counts each cloud already
knows (nothing is read back from the device to join).  ``stop`` stops the
multi-stream reader before the tiles' decoders (the JAX package stops it
after them): a decoder waiting for its tile's next frame then sees the
end of the stream at once, where it held up ``stop`` for its 2 s join.

Re-implementation of the reference's synchronizer
(reference: python/cwipc/net/source_synchronizer.py:106-282): per-tile head
buffers, timestamp matching with a tolerance, discarding of too-late
partials, a prefer_partial_over_unsynced policy, fusion via cwipc_join
(min timestamp/cellsize) and late/desync/missing statistics.  The
multi-quality variant cycles qualities on all tiles.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

from ..abstract import cwipc_activesource_abstract
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..ops import cwipc_join
from ..utils.stats import Stats
from .abstract import cwipc_activerawmultisource_abstract


class _Synchronizer(threading.Thread, cwipc_activesource_abstract):
    TOLERANCE_MS = 1
    MAX_WAIT = 0.5

    def __init__(
        self,
        reader: Optional[cwipc_activerawmultisource_abstract],
        sources: List[cwipc_activesource_abstract],
        verbose: bool = False,
        prefer_partial_over_unsynced: bool = True,
    ):
        threading.Thread.__init__(self, daemon=True)
        self.name = "cwipc_util_tpu_torch._Synchronizer"
        self.reader = reader
        self.sources = sources
        self.verbose = verbose
        self.prefer_partial = prefer_partial_over_unsynced
        self.running = False
        self.heads: List[Optional[cwipc_pointcloud_wrapper]] = [None] * len(sources)
        self.output_queue: "queue.Queue[Optional[cwipc_pointcloud_wrapper]]" = queue.Queue(maxsize=2)
        self.stats = Stats("synchronizer")
        self.n_late = 0
        self.n_partial = 0
        self.n_missing = 0

    def free(self, *, force: bool = False) -> None:
        self.stop()

    def start(self) -> bool:
        # idempotent (see the tiled factories: sources may already run)
        if self.running:
            return True
        self.running = True
        for s in self.sources:
            s.start()
        if self.reader is not None:
            self.reader.start()
        threading.Thread.start(self)
        return True

    def stop(self) -> None:
        self.running = False
        if self.reader is not None:
            self.reader.stop()
        for s in self.sources:
            s.stop()
        try:
            self.output_queue.put(None, block=False)
        except queue.Full:
            pass
        if self.is_alive():
            self.join(timeout=2)

    def eof(self) -> bool:
        if not self.output_queue.empty():
            return False
        return not self.running or all(s.eof() for s in self.sources)

    def available(self, wait: bool = False) -> bool:
        if not self.output_queue.empty():
            return True
        if not wait:
            return False
        deadline = time.time() + self.MAX_WAIT
        while time.time() < deadline and self.running:
            if not self.output_queue.empty():
                return True
            time.sleep(0.005)
        return not self.output_queue.empty()

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        if self.eof():
            return None
        return self.output_queue.get()

    def _fill_heads(self) -> None:
        for i, s in enumerate(self.sources):
            if self.heads[i] is None and s.available(False):
                self.heads[i] = s.get()

    def run(self) -> None:
        try:
            self._run_loop()
        finally:
            self.running = False
            # free parked heads (stragglers at teardown would otherwise
            # leak) and wake any consumer blocked in get() on an empty queue
            for i, pc in enumerate(self.heads):
                if pc is not None:
                    pc.free()
                    self.heads[i] = None
            try:
                self.output_queue.put(None, block=False)
            except queue.Full:
                pass

    def _run_loop(self) -> None:
        while self.running:
            self._fill_heads()
            present = [pc for pc in self.heads if pc is not None]
            if not present:
                if all(s.eof() for s in self.sources):
                    break
                time.sleep(0.005)
                continue
            if len(present) < len(self.sources):
                # Wait a bounded time for stragglers.
                deadline = time.time() + self.MAX_WAIT
                while time.time() < deadline and self.running:
                    self._fill_heads()
                    if all(pc is not None for pc in self.heads):
                        break
                    if all(
                        self.heads[i] is not None or self.sources[i].eof()
                        for i in range(len(self.sources))
                    ):
                        break
                    time.sleep(0.005)
            present_idx = [i for i, pc in enumerate(self.heads) if pc is not None]
            if not present_idx:
                continue
            # Target timestamp: earliest head; fuse all heads within tolerance.
            target = min(self.heads[i].timestamp() for i in present_idx)
            matched = [
                i
                for i in present_idx
                if abs(self.heads[i].timestamp() - target) <= self.TOLERANCE_MS
            ]
            if len(matched) < len(self.sources):
                self.n_partial += 1
                if not self.prefer_partial:
                    # drop the stale earliest head and retry
                    drop = present_idx[0]
                    for i in present_idx:
                        if self.heads[i].timestamp() == target:
                            drop = i
                            break
                    pc = self.heads[drop]
                    if pc is not None:
                        pc.free()
                    self.heads[drop] = None
                    self.n_late += 1
                    continue
            fused: Optional[cwipc_pointcloud_wrapper] = None
            for i in matched:
                pc = self.heads[i]
                self.heads[i] = None
                assert pc is not None
                if fused is None:
                    fused = pc
                else:
                    joined = cwipc_join(fused, pc)
                    fused.free()
                    pc.free()
                    fused = joined
            if fused is None:
                continue
            self.stats.add("fused_pointcount", fused.count(), isInt=True)
            self.stats.add("fused_tiles", len(matched), isInt=True)
            try:
                self.output_queue.put(fused, timeout=self.MAX_WAIT)
            except queue.Full:
                fused.free()

    # -- tiling / config ----------------------------------------------------

    def seek(self, timestamp: int) -> bool:
        return False

    def maxtile(self) -> int:
        return len(self.sources) + 1

    def get_tileinfo_dict(self, tilenum: int) -> dict:
        if tilenum == 0:
            return {"cameraName": "synchronizer", "cameraMask": 0, "ncamera": len(self.sources)}
        return {"cameraName": f"tile-{tilenum}", "cameraMask": 1 << (tilenum - 1), "ncamera": 1}

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
        print(
            f"synchronizer: late={self.n_late}, partial={self.n_partial},"
            f" missing={self.n_missing}"
        )
        self.stats.print()
        for s in self.sources:
            s.statistics()


class _MQSynchronizer(_Synchronizer):
    """Synchronizer with quality cycling over a tiled multisource."""

    def __init__(self, reader, sources, verbose=False):
        super().__init__(reader, sources, verbose=verbose)
        self.qualities: Dict[int, int] = {}

    def select_next_tile_quality(self) -> int:
        """Cycle every tile to its next quality; returns the new quality."""
        assert self.reader is not None
        desc = self.reader.get_description()
        n_quality = max(len(q) for q in desc) if desc else 1
        current = self.qualities.get(0, 0)
        nxt = (current + 1) % n_quality
        for t in range(self.reader.get_tile_count()):
            self.reader.select_tile_quality(t, nxt)
            self.qualities[t] = nxt
        return nxt


def cwipc_source_synchronizer(
    reader: Optional[cwipc_activerawmultisource_abstract],
    sources: List[cwipc_activesource_abstract],
    verbose: bool = False,
) -> cwipc_activesource_abstract:
    """Merge per-tile decoded sources into one synchronized cloud stream."""
    if reader is not None:
        return _MQSynchronizer(reader, sources, verbose=verbose)
    return _Synchronizer(reader, sources, verbose=verbose)
