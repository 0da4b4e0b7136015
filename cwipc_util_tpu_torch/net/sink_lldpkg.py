"""DASH packager sink: push streams to a low-latency DASH ingest server.

Re-implementation of the reference's lldpkg binding
(reference: python/cwipc/net/sink_lldpkg.py): a ctypes binding to the
external SIGNALS `lldash_packager` shared library (found via the
SIGNALS_SMD_PATH environment variable), exposing the rawsink interface with
one DASH stream per (tile, quality); tile geometry rides in the stream
descriptor's repurposed SRD fields (sink_lldpkg.py:25-38).

The binding uses the REAL SMD ABI (entry points, argument lists and struct
layouts exactly as the reference declares them, sink_lldpkg.py:62-78), so
it drives either the real SIGNALS libraries or the in-repo fake
(native/fake_signals.c) interchangeably.  When neither is installed the
factory raises a clear CwipcError (same behavior as the reference on a
system without SIGNALS).

The port of cwipc_util_tpu/net/sink_lldpkg.py, copied unchanged: a
rawsink of bytes, fed by the port's encoder sink (which encodes each
cloud on its device).  ``SIGNALS_SMD_PATH`` selects the library, as in
the JAX package; ``util.build_fake_signals`` builds the fake into the
port's ``_build/native/``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys
import time
import urllib.parse
from typing import Any, List, Optional, Tuple, Union

from ..core.errors import CwipcError
from ..utils.stats import Stats
from .abstract import (
    VRT_4CC,
    cwipc_quality_description,
    cwipc_rawsink_abstract,
    cwipc_tileinfo_dict,
    vrt_fourcc_type,
)

LLDASH_PACKAGER_API_VERSION = 0x20250724


class LLDashPackagerError(CwipcError):
    """Error from the lldash packager layer (reference sink_lldpkg.py:14)."""


class lldpkg_handle_p(ctypes.c_void_p):
    pass


class FrameInfo(ctypes.Structure):
    _fields_ = [("timestamp", ctypes.c_longlong)]


class streamDesc(ctypes.Structure):
    """DASH SRD fields re-targeted for pointclouds: tileNumber carries the
    tile, (x, y, z) the scaled tile normal (reference sink_lldpkg.py:25-38)."""

    _fields_ = [
        ("MP4_4CC", ctypes.c_uint32),
        ("tileNumber", ctypes.c_uint32),  # official DASH: objectX
        ("x", ctypes.c_uint32),  # official DASH: objectY
        ("y", ctypes.c_uint32),  # official DASH: objectWidth
        ("z", ctypes.c_uint32),  # official DASH: objectHeight
        ("totalWidth", ctypes.c_uint32),
        ("totalHeight", ctypes.c_uint32),
    ]

    def __init__(self, fourcc: vrt_fourcc_type, *args: Any):
        super().__init__(VRT_4CC(fourcc), *args)


LLDashPackagerErrorCallbackType = ctypes.CFUNCTYPE(
    None, ctypes.c_char_p, ctypes.c_int
)

_lldpkg_dll_reference = None


def _lldpkg_dll(libname: Optional[str] = None):
    """Load the external lldash_packager library and declare the real SMD
    signatures (cached; reference sink_lldpkg.py:41-80)."""
    global _lldpkg_dll_reference
    if _lldpkg_dll_reference is not None:
        return _lldpkg_dll_reference
    if libname is None:
        libname = os.environ.get("SIGNALS_SMD_PATH")
        if libname and os.path.isdir(libname):
            libname = os.path.join(libname, "liblldash_packager.so")
        if not libname:
            libname = ctypes.util.find_library("lldash_packager")
    if not libname or not os.path.exists(libname):
        raise CwipcError(
            "lldpkg: SIGNALS lldash_packager library not found"
            " (set SIGNALS_SMD_PATH to its directory)"
        )
    dll = ctypes.CDLL(libname)
    dll.lldpkg_create.argtypes = [
        ctypes.c_char_p,
        LLDashPackagerErrorCallbackType,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(streamDesc),
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint64,
    ]
    dll.lldpkg_create.restype = lldpkg_handle_p
    dll.lldpkg_destroy.argtypes = [lldpkg_handle_p, ctypes.c_bool]
    dll.lldpkg_destroy.restype = None
    dll.lldpkg_push_buffer.argtypes = [
        lldpkg_handle_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
    ]
    dll.lldpkg_push_buffer.restype = ctypes.c_bool
    dll.lldpkg_get_media_time.argtypes = [
        lldpkg_handle_p, ctypes.c_int, ctypes.c_int,
    ]
    dll.lldpkg_get_media_time.restype = ctypes.c_int64
    dll.lldpkg_get_version.argtypes = []
    dll.lldpkg_get_version.restype = ctypes.c_char_p
    _lldpkg_dll_reference = dll
    return dll


class _LLDashPackagerSink(cwipc_rawsink_abstract):
    """Rawsink pushing each stream to a DASH ingest URL."""

    def __init__(
        self,
        url: str,
        seg_dur_ms: int = 10000,
        timeshift_buffer_ms: int = 30000,
        verbose: bool = False,
    ):
        self.dll = _lldpkg_dll()
        self.url = url
        self.seg_dur_ms = seg_dur_ms
        self.timeshift_buffer_ms = timeshift_buffer_ms
        self.verbose = verbose
        self.fourcc = 0
        self.producer = None
        self.handle: Optional[lldpkg_handle_p] = None
        self.streamDescs: List[streamDesc] = []
        self.stats = Stats(f"lldpkg:{url}")
        # keep the callback object alive for the handle's lifetime
        self._error_cb = LLDashPackagerErrorCallbackType(self._on_error)
        if self.verbose:
            version = self.dll.lldpkg_get_version().decode("utf8")
            print(f"lldash_packager: native library version: {version}",
                  file=sys.stderr, flush=True)

    def __del__(self):
        self.free(force=True)

    def _on_error(self, cmsg: bytes, level: int) -> None:
        level_name = {0: "error", 1: "warning", 2: "info message",
                      3: "debug message"}.get(level, f"level-{level} message")
        print(f"lldash_packager: asynchronous {level_name}:"
              f" {cmsg.decode('utf8')}", file=sys.stderr, flush=True)

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
        # Tile geometry rides in the repurposed SRD fields of the stream
        # descriptor: the tile normal scaled to integers (reference
        # sink_lldpkg.py:195-210; qualitydesc is ignored there too).  The
        # reference REQUIRES tiledesc, which makes its own invent-a-stream
        # start() path unreachable — we accept a missing tiledesc as a
        # zero normal instead.
        if tilenum is None:
            raise LLDashPackagerError("sink_lldpkg: add_stream: tilenum is required")
        normal = (tiledesc or {}).get("normal", dict(x=0, y=0, z=0))
        x, y, z = normal["x"], normal["y"], normal["z"]
        if not isinstance(x, int):
            x = int(x * 1000)
        if not isinstance(y, int):
            y = int(y * 1000)
        if not isinstance(z, int):
            z = int(z * 1000)
        if not self.fourcc:
            self.fourcc = VRT_4CC("cwi1")
        self.streamDescs.append(streamDesc(self.fourcc, tilenum, x, y, z))
        return len(self.streamDescs) - 1

    def _urlsplit(self, url: str) -> Tuple[str, str]:
        """(baseurl, mpdbasename); the URL must name a .mpd (or end in a
        slash, defaulting to cwipc_lldpkg.mpd) — reference
        sink_lldpkg.py:168-180."""
        split = urllib.parse.urlsplit(url)
        basepath, mpdname = os.path.split(split.path)
        if basepath and basepath[-1] != "/":
            basepath = basepath + "/"
        if not mpdname:
            mpdname = "cwipc_lldpkg.mpd"
        mpdbasename, ext = os.path.splitext(mpdname)
        if ext != ".mpd":
            raise LLDashPackagerError(
                f"lldash_packager: URL {url} does not end with .mpd"
            )
        baseurl = urllib.parse.urlunsplit(
            (split.scheme, split.netloc, basepath, split.query, split.fragment)
        )
        return baseurl, mpdbasename

    def start(self) -> None:
        if not self.streamDescs:
            # Single default stream so an un-tiled pipeline needs no setup.
            self.add_stream(0)
        count = len(self.streamDescs)
        c_descs = (streamDesc * count)(*self.streamDescs)
        baseurl, mpdname = self._urlsplit(self.url)
        msg_level = 3 if self.verbose else 0
        self.handle = self.dll.lldpkg_create(
            mpdname.encode("utf8"),
            self._error_cb,
            msg_level,
            count,
            c_descs,
            baseurl.encode("utf8"),
            self.seg_dur_ms,
            self.timeshift_buffer_ms,
            LLDASH_PACKAGER_API_VERSION,
        )
        if not self.handle:
            raise LLDashPackagerError(f"lldpkg_create({self.url}) failed")

    def stop(self) -> None:
        self.free(force=True)

    def free(self, *, force: bool = False) -> None:
        # getattr: __del__ reaches here even when __init__ failed before
        # self.handle was assigned (e.g. the DLL itself failed to load)
        tmp_handle = getattr(self, "handle", None)
        if tmp_handle:
            self.handle = None
            self.dll.lldpkg_destroy(tmp_handle, True)

    def feed(
        self, buffer: Union[bytes, bytearray], stream_index: Optional[int] = None
    ) -> bool:
        if self.handle is None:
            return False
        data = bytes(buffer)
        t0 = time.time()
        ok = self.dll.lldpkg_push_buffer(
            self.handle, stream_index or 0, data, len(data)
        )
        self.stats.add("push_duration", time.time() - t0)
        self.stats.add("packetsize", len(data), isInt=True)
        return bool(ok)

    def get_media_time(self, stream_index: int = 0, timescale: int = 1000) -> int:
        """Media clock of a stream in the given timescale (reference
        binding lldpkg_get_media_time, sink_lldpkg.py:74-75)."""
        if self.handle is None:
            return -1
        return int(self.dll.lldpkg_get_media_time(self.handle, stream_index, timescale))

    def statistics(self) -> None:
        self.stats.print()


def cwipc_sink_lldpkg(url: str, verbose: bool = False, **kwargs) -> cwipc_rawsink_abstract:
    """Rawsink pushing multi-stream DASH to a low-latency ingest server."""
    return _LLDashPackagerSink(url, verbose=verbose, **kwargs)
