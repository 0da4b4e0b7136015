"""Abstract interfaces (duck types) for point clouds, sources and sinks.

The same contract as the JAX package's ``abstract.py`` (itself mirroring
the reference's python/cwipc/abstract.py:4-108), copied so that this
package never imports the JAX one: the abstract classes, the raw tile info
of an active source (``get_tileinfo_raw``, through the ctypes structs of
``util.py``) and the wrapper shells ``cwipc_source_wrapper``,
``cwipc_activesource_wrapper`` and ``cwipc_sink_wrapper``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional


# Tile info as a Python dict (reference abstract.py:55)
cwipc_tileinfo_dict = Dict[str, Any]


class cwipc_pointcloud_abstract(ABC):
    @abstractmethod
    def free(self, *, force: bool = False) -> None: ...

    @abstractmethod
    def timestamp(self) -> int: ...

    @abstractmethod
    def cellsize(self) -> float: ...

    @abstractmethod
    def count(self) -> int: ...

    @abstractmethod
    def get_uncompressed_size(self) -> int: ...

    @abstractmethod
    def get_points(self) -> Any: ...

    @abstractmethod
    def get_bytes(self) -> bytearray: ...

    @abstractmethod
    def get_packet(self) -> bytearray: ...

    @abstractmethod
    def access_metadata(self) -> Any: ...


class cwipc_source_abstract(ABC):
    @abstractmethod
    def free(self, *, force: bool = False) -> None: ...

    @abstractmethod
    def eof(self) -> bool: ...

    @abstractmethod
    def available(self, wait: bool) -> bool: ...

    @abstractmethod
    def get(self) -> Optional[cwipc_pointcloud_abstract]: ...

    def statistics(self) -> None:
        pass


class cwipc_activesource_abstract(cwipc_source_abstract):
    @abstractmethod
    def start(self) -> bool: ...

    @abstractmethod
    def stop(self) -> None: ...

    @abstractmethod
    def seek(self, timestamp: int) -> bool: ...

    @abstractmethod
    def maxtile(self) -> int: ...

    @abstractmethod
    def get_tileinfo_dict(self, tilenum: int) -> dict: ...

    def get_tileinfo_raw(self, tilenum: int):
        """Tile info as a ctypes cwipc_tileinfo struct, or None
        (reference: util.py:846-853).  Built from get_tileinfo_dict, so
        every active source provides it."""
        try:
            info = self.get_tileinfo_dict(tilenum)
        except Exception:
            return None
        if not info:
            return None
        from .util import cwipc_tileinfo, cwipc_vector

        raw = cwipc_tileinfo()
        normal = info.get("normal", {}) or {}
        raw.normal = cwipc_vector(
            float(normal.get("x", 0.0)),
            float(normal.get("y", 0.0)),
            float(normal.get("z", 0.0)),
        )
        name = info.get("cameraName", b"") or b""
        raw.cameraName = name if isinstance(name, bytes) else str(name).encode("utf8")
        raw.ncamera = int(info.get("ncamera", 0))
        raw.cameraMask = int(info.get("cameraMask", 0))
        return raw

    @abstractmethod
    def reload_config(self, config) -> None: ...

    @abstractmethod
    def get_config(self) -> bytes: ...

    @abstractmethod
    def request_metadata(self, name: str) -> None: ...

    @abstractmethod
    def is_metadata_requested(self, name: str) -> bool: ...

    @abstractmethod
    def auxiliary_operation(self, op: str, inbuf: bytes, outbuf: bytearray) -> bool: ...


class cwipc_sink_abstract(ABC):
    @abstractmethod
    def free(self, *, force: bool = False) -> None: ...

    @abstractmethod
    def feed(self, pc: Optional[cwipc_pointcloud_abstract], clear: bool) -> bool: ...

    def caption(self, caption: str) -> None:
        pass

    def interact(self, prompt: Optional[str], responses: Optional[str], millis: int) -> str:
        return ""


# ---------------------------------------------------------------------------
# Wrapper-class aliases.  The reference exposes its ctypes wrapper classes
# as cwipc_source_wrapper / cwipc_activesource_wrapper / cwipc_sink_wrapper
# (python/cwipc/util.py:742-944); in this framework sources are Python
# objects already, so the "wrapper" names are constructible shells kept for
# API compatibility (user code does `cwipc.cwipc_source_wrapper()` in
# tests/teardown paths).
# ---------------------------------------------------------------------------


class cwipc_source_wrapper(cwipc_source_abstract):
    """Empty source shell (API-compatibility constructor)."""

    def __init__(self, wrapped: Optional[cwipc_source_abstract] = None):
        self._wrapped = wrapped

    def free(self, *, force: bool = False) -> None:
        if self._wrapped:
            self._wrapped.free(force=force)

    def eof(self) -> bool:
        return self._wrapped.eof() if self._wrapped else True

    def available(self, wait: bool) -> bool:
        return self._wrapped.available(wait) if self._wrapped else False

    def get(self):
        return self._wrapped.get() if self._wrapped else None

    def detach(self) -> "cwipc_source_wrapper":
        """Hand the wrapped source to a new wrapper; this one is emptied
        and no longer frees it (reference: util.py:772-784)."""
        rv = type(self)(self._wrapped)
        self._wrapped = None
        return rv

    def as_cwipc_source_p(self):
        """ctypes-compatible handle (reference: util.py as_cwipc_source_p).
        Sources in this framework are Python objects; only a source wrapping
        a native-backed implementation carries a handle."""
        handle = getattr(self._wrapped, "_native_handle", None) if self._wrapped else None
        if handle:
            return handle
        from .core.errors import CwipcError

        raise CwipcError(
            "cwipc_source: this source is Python-native and has no C handle"
        )


class cwipc_activesource_wrapper(cwipc_source_wrapper, cwipc_activesource_abstract):
    """Delegating active-source shell (API-compatibility constructor):
    forwards the FULL active-source surface, so type-dispatching code sees
    an active source and every accessor works."""

    def start(self) -> bool:
        return self._wrapped.start() if self._wrapped else False

    def stop(self) -> None:
        if self._wrapped:
            self._wrapped.stop()

    def seek(self, timestamp: int) -> bool:
        return self._wrapped.seek(timestamp) if self._wrapped else False

    def maxtile(self) -> int:
        return self._wrapped.maxtile() if self._wrapped else 0

    def get_tileinfo_dict(self, tilenum: int) -> dict:
        return self._wrapped.get_tileinfo_dict(tilenum) if self._wrapped else {}

    def reload_config(self, config) -> None:
        if self._wrapped:
            self._wrapped.reload_config(config)

    def get_config(self):
        return self._wrapped.get_config() if self._wrapped else None

    def request_metadata(self, name: str) -> None:
        if self._wrapped:
            self._wrapped.request_metadata(name)

    def is_metadata_requested(self, name: str) -> bool:
        return self._wrapped.is_metadata_requested(name) if self._wrapped else False

    def auxiliary_operation(self, op: str, inbuf: bytes, outbuf: bytearray) -> bool:
        return (
            self._wrapped.auxiliary_operation(op, inbuf, outbuf)
            if self._wrapped
            else False
        )


class cwipc_sink_wrapper(cwipc_sink_abstract):
    """Empty sink shell (API-compatibility constructor)."""

    def __init__(self, wrapped=None):
        self._wrapped = wrapped

    def free(self, *, force: bool = False) -> None:
        if self._wrapped:
            self._wrapped.free(force=force)

    def feed(self, pc, clear: bool) -> bool:
        return self._wrapped.feed(pc, clear) if self._wrapped else False

    def detach(self) -> "cwipc_sink_wrapper":
        """Hand the wrapped sink to a new wrapper; this one is emptied and
        no longer frees it (reference: util.py:913-925)."""
        rv = type(self)(self._wrapped)
        self._wrapped = None
        return rv

    def as_cwipc_sink_p(self):
        """ctypes-compatible handle (reference: util.py as_cwipc_sink_p).
        Sinks in this framework are Python objects; only a sink wrapping a
        native-backed implementation carries a handle."""
        handle = getattr(self._wrapped, "_native_handle", None) if self._wrapped else None
        if handle:
            return handle
        from .core.errors import CwipcError

        raise CwipcError(
            "cwipc_sink: this sink is Python-native and has no C handle"
        )
