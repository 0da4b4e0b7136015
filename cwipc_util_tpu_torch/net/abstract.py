"""Pipeline ABCs for raw-data sources/sinks and pointcloud sinks.

Same duck types as the reference's net layer
(reference: python/cwipc/net/abstract.py:11-204): rawsources produce byte
blocks (one logical frame each), rawsinks consume them, multisources manage
per-tile streams with quality selection, and VRT_4CC converts fourcc
spellings.

Copied from cwipc_util_tpu/net/abstract.py.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Union

from ..abstract import cwipc_activesource_abstract, cwipc_source_abstract
from ..core.pointcloud import cwipc_pointcloud_wrapper

vrt_fourcc_type = Union[int, bytes, str]
cwipc_quality_description = Dict[str, Any]
cwipc_tileinfo_dict = Dict[str, Any]


def VRT_4CC(code: vrt_fourcc_type) -> int:
    """Convert bytes/str/int fourcc spellings to the canonical int form."""
    if isinstance(code, int):
        return code
    if isinstance(code, str):
        code = code.encode("ascii")
    assert len(code) == 4
    return (code[0] << 24) | (code[1] << 16) | (code[2] << 8) | code[3]


class cwipc_rawsource_abstract(ABC):
    """Produces a stream of raw byte blocks (complete logical frames)."""

    @abstractmethod
    def set_fourcc(self, fourcc: vrt_fourcc_type) -> None: ...

    @abstractmethod
    def get(self) -> Optional[bytes]: ...

    @abstractmethod
    def available(self, wait: bool = False) -> bool: ...

    @abstractmethod
    def eof(self) -> bool: ...

    def statistics(self) -> None: ...


class cwipc_activerawsource_abstract(cwipc_rawsource_abstract):
    @abstractmethod
    def start(self) -> bool: ...

    @abstractmethod
    def stop(self) -> None: ...


cwipc_multistream_description = List[List[Any]]


class cwipc_activerawmultisource_abstract(ABC):
    """Container of per-tile rawsources with quality selection."""

    @abstractmethod
    def start(self) -> bool: ...

    @abstractmethod
    def stop(self) -> None: ...

    @abstractmethod
    def get_tile_count(self) -> int: ...

    @abstractmethod
    def get_description(self) -> cwipc_multistream_description: ...

    @abstractmethod
    def get_tile_source(self, tileIdx: int) -> cwipc_rawsource_abstract: ...

    @abstractmethod
    def select_tile_quality(self, tileIdx: int, qualityIdx: int) -> None: ...


cwipc_producer_abstract = threading.Thread


class cwipc_rawsink_abstract(ABC):
    """Consumes raw byte blocks (e.g. a network sender)."""

    @abstractmethod
    def start(self) -> None: ...

    @abstractmethod
    def stop(self) -> None: ...

    @abstractmethod
    def set_producer(self, producer: cwipc_producer_abstract) -> None: ...

    @abstractmethod
    def set_fourcc(self, fourcc: vrt_fourcc_type) -> None: ...

    @abstractmethod
    def add_stream(
        self,
        tilenum: Optional[int] = None,
        tiledesc: Optional[cwipc_tileinfo_dict] = None,
        qualitydesc: Optional[cwipc_quality_description] = None,
    ) -> int: ...

    @abstractmethod
    def feed(self, buffer: Union[bytes, bytearray], stream_index: Optional[int] = None) -> bool: ...

    def statistics(self) -> None: ...


class cwipc_sink_abstract(ABC):
    """Consumes pointclouds (viewer, writer, encoder front-end...)."""

    @abstractmethod
    def start(self) -> None: ...

    @abstractmethod
    def stop(self) -> None: ...

    @abstractmethod
    def set_producer(self, producer: cwipc_producer_abstract) -> None: ...

    @abstractmethod
    def feed(self, pc: cwipc_pointcloud_wrapper) -> None: ...

    def statistics(self) -> None: ...


cwipc_source_factory_abstract = Callable[[], cwipc_source_abstract]
cwipc_activesource_factory_abstract = Callable[[], cwipc_activesource_abstract]
cwipc_activerawsource_factory_abstract = Callable[[], cwipc_activerawsource_abstract]
cwipc_activedecoder_factory_abstract = Callable[
    [cwipc_activerawsource_abstract], cwipc_activesource_abstract
]
