"""Push rawsink: connect OUT to a relay and send frames.

Copied from cwipc_util_tpu/net/sink_netingest.py: it sends bytes the
encoder or passthrough sink made, so it holds no cloud and no tensor.

Re-implementation of the reference's netingest sink
(reference: python/cwipc/net/sink_netingest.py): instead of serving, this
sink dials a cwipc_netserver relay and pushes 16-byte-framed packets to it.
Single stream only, like the reference.
"""

from __future__ import annotations

import socket
import time
from typing import Optional, Union

from ..core.errors import CwipcError
from ..utils.stats import Stats
from .abstract import (
    VRT_4CC,
    cwipc_quality_description,
    cwipc_rawsink_abstract,
    cwipc_tileinfo_dict,
    vrt_fourcc_type,
)
from .sink_netserver import pack_frame


class _Sink_NetIngest(cwipc_rawsink_abstract):
    def __init__(self, address: str, verbose: bool = False):
        host, _, port = address.partition(":")
        self.host = host or "localhost"
        self.port = int(port or 4303)
        self.verbose = verbose
        self.fourcc: int = 0
        self.producer = None
        self.sock: Optional[socket.socket] = None
        self.stats = Stats(f"netingest:{self.host}:{self.port}")
        self.n_streams = 0

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
        if self.n_streams >= 1:
            raise CwipcError("netingest: supports a single stream only")
        self.n_streams += 1
        return 0

    def start(self) -> None:
        try:
            self.sock = socket.create_connection((self.host, self.port), timeout=5)
        except OSError as e:
            raise CwipcError(f"netingest: cannot connect to {self.host}:{self.port}: {e}") from e

    def stop(self) -> None:
        if self.sock:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def feed(self, buffer: Union[bytes, bytearray], stream_index: Optional[int] = None) -> bool:
        if self.sock is None:
            return False
        packet = pack_frame(self.fourcc, buffer, int(time.time() * 1000))
        try:
            t0 = time.time()
            self.sock.sendall(packet)
            self.stats.add("send_duration", time.time() - t0)
            self.stats.add("packetsize", len(packet), isInt=True)
            return True
        except OSError:
            if self.verbose:
                print("netingest: connection lost")
            self.stop()
            return False

    def statistics(self) -> None:
        self.stats.print()


def cwipc_sink_netingest(address: str, verbose: bool = False) -> cwipc_rawsink_abstract:
    """Rawsink that pushes packets to a cwipc netserver relay."""
    return _Sink_NetIngest(address, verbose=verbose)
