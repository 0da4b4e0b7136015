"""Abstract interfaces (duck types) for point clouds, sources and sinks.

The same contract as the JAX package's ``abstract.py`` (itself mirroring
the reference's python/cwipc/abstract.py:4-108), copied so that this
package never imports the JAX one.
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
