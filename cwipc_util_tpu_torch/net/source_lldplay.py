"""DASH playout source: receive (tiled) streams from a low-latency DASH CDN.

Re-implementation of the reference's lldplay binding
(reference: python/cwipc/net/source_lldplay.py): a ctypes binding to the
external SIGNALS `lldash_play` shared library with stream discovery, a
per-tile rawsource view, and enable/disable-stream quality selection
(source_lldplay.py:57-163).

The binding uses the REAL SMD ABI (entry points, argument lists and struct
layouts exactly as the reference declares them, source_lldplay.py:80-105),
including the two-phase lldplay_grab_frame protocol (NULL buffer asks the
pending frame's size), so it drives either the real SIGNALS libraries or
the in-repo fake (native/fake_signals.c) interchangeably.  Without either,
the factories raise a clear CwipcError (matching the reference's behavior
on systems without SIGNALS).

The port of cwipc_util_tpu/net/source_lldplay.py: a rawsource of bytes,
whose frames the port's decoders turn into clouds on their device
(``--lldplay``, and ``--mt-lldplay`` with a decoder a tile and the
synchronizer joining them on the card).  ``SIGNALS_SMD_PATH``
selects the library, as in the JAX package.  One change: a tile view's
``get`` returns None when the session stops while it waits (the JAX
package's waits for a frame for ever, so a decoder thread waiting there
held up ``stop``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import queue
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..core.errors import CwipcError
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

LLDASH_PLAYOUT_API_VERSION = 0x20250722


class LLDashPlayoutError(CwipcError):
    """Error from the lldash playout layer (reference source_lldplay.py:15)."""


class lldplay_handle_p(ctypes.c_void_p):
    pass


class FrameInfo(ctypes.Structure):
    """Per-frame metadata filled by lldplay_grab_frame (reference
    source_lldplay.py:23-32)."""

    _fields_ = [
        ("timestamp", ctypes.c_int64),
        ("dsi", ctypes.c_char * 256),
        ("dsi_size", ctypes.c_int),
    ]


class streamDesc(ctypes.Structure):
    """DASH SRD fields re-targeted for pointclouds (reference
    source_lldplay.py:34-50)."""

    _fields_ = [
        ("MP4_4CC", ctypes.c_uint32),
        ("tileNumber", ctypes.c_uint32),
        ("x", ctypes.c_uint32),
        ("y", ctypes.c_uint32),
        ("z", ctypes.c_uint32),
        ("totalWidth", ctypes.c_uint32),
        ("totalHeight", ctypes.c_uint32),
    ]


# Pythonic tuple forms of the structures (reference source_lldplay.py:52-53)
streamDesc_pythonic = Tuple[int, int, int, int, int, int, int]
tileInfo_pythonic = Tuple[int, int, Tuple[int, int, int], int]

LLDashPlayoutErrorCallbackType = ctypes.CFUNCTYPE(
    None, ctypes.c_char_p, ctypes.c_int
)

_lldplay_dll_reference = None


def _lldplay_dll(libname: Optional[str] = None):
    """Load the external lldash_play library and declare the real SMD
    signatures (cached; reference source_lldplay.py:57-105)."""
    global _lldplay_dll_reference
    if _lldplay_dll_reference is not None:
        return _lldplay_dll_reference
    if libname is None:
        libname = os.environ.get("SIGNALS_SMD_PATH")
        if libname and os.path.isdir(libname):
            libname = os.path.join(libname, "liblldash_play.so")
        if not libname:
            libname = ctypes.util.find_library("lldash_play")
    if not libname or not os.path.exists(libname):
        raise CwipcError(
            "lldplay: SIGNALS lldash_play library not found"
            " (set SIGNALS_SMD_PATH to its directory)"
        )
    dll = ctypes.CDLL(libname)
    dll.lldplay_create.argtypes = [
        ctypes.c_char_p, LLDashPlayoutErrorCallbackType, ctypes.c_int,
        ctypes.c_uint64,
    ]
    dll.lldplay_create.restype = lldplay_handle_p
    dll.lldplay_destroy.argtypes = [lldplay_handle_p]
    dll.lldplay_destroy.restype = None
    dll.lldplay_play.argtypes = [lldplay_handle_p, ctypes.c_char_p]
    dll.lldplay_play.restype = ctypes.c_bool
    dll.lldplay_get_stream_count.argtypes = [lldplay_handle_p]
    dll.lldplay_get_stream_count.restype = ctypes.c_int
    dll.lldplay_get_stream_info.argtypes = [
        lldplay_handle_p, ctypes.c_int, ctypes.POINTER(streamDesc),
    ]
    dll.lldplay_get_stream_info.restype = ctypes.c_bool
    dll.lldplay_enable_stream.argtypes = [
        lldplay_handle_p, ctypes.c_int, ctypes.c_int,
    ]
    dll.lldplay_enable_stream.restype = ctypes.c_bool
    dll.lldplay_disable_stream.argtypes = [lldplay_handle_p, ctypes.c_int]
    dll.lldplay_disable_stream.restype = ctypes.c_bool
    dll.lldplay_grab_frame.argtypes = [
        lldplay_handle_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(FrameInfo),
    ]
    dll.lldplay_grab_frame.restype = ctypes.c_size_t
    dll.lldplay_get_version.argtypes = []
    dll.lldplay_get_version.restype = ctypes.c_char_p
    _lldplay_dll_reference = dll
    return dll


class _TileView(cwipc_rawsource_abstract):
    """Per-tile rawsource view over the shared playout session."""

    def __init__(self, parent: "_LLDashPlaySource", tile: int):
        self.parent = parent
        self.tile = tile
        self.queue: PeekQueue = PeekQueue(maxsize=2)
        self.fourcc = 0

    def set_fourcc(self, fourcc: vrt_fourcc_type) -> None:
        self.fourcc = VRT_4CC(fourcc)

    def get(self) -> Optional[bytes]:
        # wait in slices: a consumer waiting here wakes with None once the
        # session stops with nothing queued, instead of waiting for ever
        while not self.eof():
            try:
                return self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def available(self, wait: bool = False) -> bool:
        if not self.queue.empty():
            return True
        if wait and not self.parent.stopped:
            return self.queue.dont_get(timeout=2.0) is not None
        return False

    def eof(self) -> bool:
        return self.parent.stopped and self.queue.empty()

    def statistics(self) -> None:
        pass


class _LLDashPlaySource(cwipc_activerawmultisource_abstract):
    """Shared playout session; pump thread fans frames to per-tile views.

    Streams with identical descriptors form one tile, in first appearance
    order; a tile's stream count is its quality count (the reference's
    _init_tile_info grouping, source_lldplay.py:335-356)."""

    def __init__(self, url: str, verbose: bool = False):
        import threading

        self.dll = _lldplay_dll()
        self.url = url
        self.verbose = verbose
        self.stopped = False
        self.handle: Optional[lldplay_handle_p] = None
        self.tiles: List[_TileView] = []
        self.tile_info: List[tileInfo_pythonic] = []
        self.streamnum_to_tilenum: Dict[int, int] = {}
        self.stats = Stats(f"lldplay:{url}")
        self._thread = threading.Thread(target=self._pump, daemon=True)
        # keep the callback object alive for the handle's lifetime
        self._error_cb = LLDashPlayoutErrorCallbackType(self._on_error)
        self.error_condition = False
        if self.verbose:
            version = self.dll.lldplay_get_version().decode("utf8")
            print(f"lldash_play: native library version: {version}",
                  file=sys.stderr, flush=True)

    def __del__(self):
        self.free(force=True)

    def _on_error(self, cmsg: bytes, level: int) -> None:
        level_name = {0: "error", 1: "warning", 2: "info message",
                      3: "debug message"}.get(level, f"level-{level} message")
        print(f"lldash_play: asynchronous {level_name}: {cmsg.decode('utf8')}",
              file=sys.stderr, flush=True)
        if level == 0:
            self.error_condition = True

    def _srd_info_for_stream(self, num: int) -> streamDesc_pythonic:
        c_desc = streamDesc()
        ok = self.dll.lldplay_get_stream_info(self.handle, num, c_desc)
        if not ok:
            raise LLDashPlayoutError(f"lldplay_get_stream_info({num}) failed")
        return (c_desc.MP4_4CC, c_desc.tileNumber, c_desc.x, c_desc.y,
                c_desc.z, c_desc.totalWidth, c_desc.totalHeight)

    def _init_tile_info(self) -> None:
        counts: Dict[streamDesc_pythonic, int] = {}
        ordered: List[streamDesc_pythonic] = []
        n = self.dll.lldplay_get_stream_count(self.handle)
        for stream_idx in range(n):
            desc = self._srd_info_for_stream(stream_idx)
            if desc not in counts:
                counts[desc] = 1
                ordered.append(desc)
            else:
                counts[desc] += 1
            self.streamnum_to_tilenum[stream_idx] = ordered.index(desc)
        self.tile_info = [
            (d[0], d[1], (d[2], d[3], d[4]), counts[d]) for d in ordered
        ]

    def start(self) -> bool:
        if self.handle is not None:
            # idempotent: the CLI factory starts the session for stream
            # discovery, then the synchronizer's start cascade reaches it
            # again
            return True
        msg_level = 3 if self.verbose else 0
        handle = self.dll.lldplay_create(
            b"cwipc_lldplay", self._error_cb, msg_level,
            LLDASH_PLAYOUT_API_VERSION,
        )
        if not handle:
            raise LLDashPlayoutError("lldplay: cannot create player")
        self.handle = handle
        if not self.dll.lldplay_play(self.handle, self.url.encode("utf8")):
            raise LLDashPlayoutError(f"lldplay: cannot play {self.url}")
        self._init_tile_info()
        self.tiles = [_TileView(self, i) for i in range(max(1, len(self.tile_info)))]
        self._thread.start()
        return True

    def stop(self) -> None:
        self.stopped = True
        if self._thread.is_alive():
            self._thread.join(timeout=2)
        self.free(force=True)

    def free(self, *, force: bool = False) -> None:
        # getattr: __del__ reaches here even when __init__ failed before
        # self.handle was assigned (e.g. the DLL itself failed to load)
        tmp_handle = getattr(self, "handle", None)
        if tmp_handle:
            self.handle = None
            self.dll.lldplay_destroy(tmp_handle)

    def _pump(self) -> None:
        try:
            self._pump_inner()
        except Exception as e:
            print(f"lldash_play: pump thread: {e}", file=sys.stderr, flush=True)
            self.error_condition = True
        finally:
            # Whatever ended the pump (stop(), an async error, a protocol
            # error), consumers must observe EOF instead of waiting for
            # frames that will never arrive: eof()/available() key off
            # stopped (reference closes all tile sources in its finally).
            self.stopped = True

    def _pump_inner(self) -> None:
        frame_info = FrameInfo()
        n_streams = self.dll.lldplay_get_stream_count(self.handle)
        while not self.stopped and not self.error_condition and self.handle:
            got_any = False
            for stream_idx in range(n_streams):
                # two-phase grab: NULL buffer asks the pending frame's size
                length = self.dll.lldplay_grab_frame(
                    self.handle, stream_idx, None, 0, None
                )
                if length == 0:
                    continue
                packet = bytearray(length)
                ptr_char = (ctypes.c_char * length).from_buffer(packet)
                ptr = ctypes.cast(ptr_char, ctypes.c_void_p)
                length2 = self.dll.lldplay_grab_frame(
                    self.handle, stream_idx, ptr, length, frame_info
                )
                if length2 == 0:
                    # select_tile_quality disabled this stream between the
                    # two phases — a benign race, not a protocol error
                    continue
                if length2 != length:
                    raise LLDashPlayoutError(
                        f"lldplay_grab_frame(stream={stream_idx}): promised"
                        f" {length} bytes but got {length2}"
                    )
                view = self.tiles[self.streamnum_to_tilenum.get(stream_idx, 0)]
                payload = bytes(packet)
                # bounded wait, then drop-oldest: a LIVE consumer gets
                # every frame (the short grace covers scheduling jitter),
                # while an unconsumed tile cannot stall the shared pump
                # forever — it degrades to newest-frames-only
                try:
                    view.queue.put(payload, timeout=0.2)
                except queue.Full:
                    while True:
                        try:
                            view.queue.put(payload, block=False)
                            break
                        except queue.Full:
                            try:
                                view.queue.get(block=False)
                            except queue.Empty:
                                continue
                self.stats.add("packetsize", length, isInt=True)
                got_any = True
            if not got_any:
                time.sleep(0.005)

    def get_tile_count(self) -> int:
        return len(self.tiles)

    def get_tileinfo_dict(self, tilenum: int) -> dict:
        """Tile info reconstructed from the repurposed SRD fields
        (reference source_lldplay.py:316-324)."""
        mp4_4cc, tile_number, (x, y, z), quality_count = self.tile_info[tilenum]
        # The sink stores int(component*1000) two's-complement-wrapped into
        # the unsigned SRD field (reference sink_lldpkg.py:205-207); decode
        # SIGNED so back-facing tile normals survive the round trip.  (The
        # reference decodes unsigned at source_lldplay.py:322, turning
        # z=-1.0 into 4294966.296 — a bug, deliberately not preserved.)
        def _signed(v: int) -> float:
            return ctypes.c_int32(v).value / 1000.0

        normal = dict(x=_signed(x), y=_signed(y), z=_signed(z))
        return dict(normal=normal, cameraName=f"tile-{tilenum}",
                    cameraMask=tile_number, nquality=quality_count,
                    mp4_4cc=mp4_4cc)

    def get_description(self) -> cwipc_multistream_description:
        if not self.tile_info:
            return [[{}] for _ in self.tiles]
        return [
            [dict(quality=q) for q in range(info[3])] for info in self.tile_info
        ]

    def get_tile_source(self, tileIdx: int) -> cwipc_rawsource_abstract:
        return self.tiles[tileIdx]

    def select_tile_quality(self, tileIdx: int, qualityIdx: int) -> None:
        if self.handle:
            ok = self.dll.lldplay_enable_stream(self.handle, tileIdx, qualityIdx)
            if not ok:
                print("lldash_play: lldplay_enable_stream failed",
                      file=sys.stderr)
                self.error_condition = True

    def statistics(self) -> None:
        self.stats.print()


class _SingleStreamView(cwipc_activerawsource_abstract):
    """Single-stream adapter over the multisource (the non-tiled factory).

    Consumer threads (e.g. the decoder) may poll before ``start()`` has
    finished stream discovery — every accessor must tolerate the
    not-yet-started state instead of indexing an empty tile list."""

    def __init__(self, url: str, verbose: bool = False):
        self.multi = _LLDashPlaySource(url, verbose)
        self._fourcc: Optional[vrt_fourcc_type] = None

    def set_fourcc(self, fourcc: vrt_fourcc_type) -> None:
        # normal call order is set_fourcc() (decoder construction) BEFORE
        # start() discovers the streams — remember it and apply at start
        self._fourcc = fourcc
        if self.multi.tiles:
            self.multi.tiles[0].set_fourcc(fourcc)

    def start(self) -> bool:
        ok = self.multi.start()
        if ok and self._fourcc is not None and self.multi.tiles:
            self.multi.tiles[0].set_fourcc(self._fourcc)
        return ok

    def stop(self) -> None:
        self.multi.stop()

    def get(self) -> Optional[bytes]:
        if not self.multi.tiles:
            return None
        return self.multi.get_tile_source(0).get()

    def available(self, wait: bool = False) -> bool:
        if not self.multi.tiles:
            return False
        return self.multi.get_tile_source(0).available(wait)

    def eof(self) -> bool:
        if not self.multi.tiles:
            return self.multi.stopped
        return self.multi.get_tile_source(0).eof()

    def statistics(self) -> None:
        self.multi.statistics()


def cwipc_source_lldplay(url: str, verbose: bool = False) -> cwipc_activerawsource_abstract:
    """Rawsource playing a (single-stream) low-latency DASH URL."""
    return _SingleStreamView(url, verbose=verbose)


def cwipc_multisource_lldplay(url: str, verbose: bool = False) -> cwipc_activerawmultisource_abstract:
    """Tiled multi-quality rawsource playing a low-latency DASH URL."""
    return _LLDashPlaySource(url, verbose=verbose)
