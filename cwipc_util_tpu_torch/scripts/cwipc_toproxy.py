"""cwipc toproxy: push pointcloud packets to a cwipc proxy server.

The port of cwipc_util_tpu/scripts/cwipc_toproxy.py: the source delivers
its clouds on ``--device`` (default CUDA); each is read back once and sent
in ``net/proxy._PKT_FMT`` packets.

Reference: python/cwipc/scripts/cwipc_toproxy.py (legacy path): grabs
clouds and sends them as 24-byte-header packets to a cwipc_proxy receiver.
"""

import queue
import socket
import struct
import sys

from ..net.proxy import CWIPC_POINT_PACKETHEADER_MAGIC, _PKT_FMT
from ._scriptsupport import (
    ArgumentParser,
    activesource_factory_from_args,
    beginOfRun,
    endOfRun,
)


class Sender:
    """Sink pushing packets to a cwipc_proxy receiver
    (reference: cwipc_toproxy.py Sender): feed() queues clouds, run()
    drains the queue while the producer lives, send_pc() does one packet."""

    def __init__(self, host: str, port: int, verbose: bool = False):
        self.producer = None
        self.output_queue: "queue.Queue" = queue.Queue(maxsize=2)
        self.verbose = verbose
        self.socket = socket.create_connection((host, port), timeout=5)
        self.sent = 0

    def start(self) -> None:
        pass

    def stop(self) -> None:
        if self.socket is not None:
            self.socket.close()
            self.socket = None

    def set_producer(self, producer) -> None:
        self.producer = producer

    def feed(self, pc) -> None:
        try:
            self.output_queue.put(pc, timeout=0.5)
        except queue.Full:
            pc.free()

    def run(self) -> None:
        while self.producer is not None and self.producer.is_alive():
            try:
                pc = self.output_queue.get(timeout=0.033)
            except queue.Empty:
                continue
            self.send_pc(pc)
            pc.free()

    def send_pc(self, pc) -> None:
        data = bytes(pc.get_bytes())
        hdr = struct.pack(
            _PKT_FMT, CWIPC_POINT_PACKETHEADER_MAGIC, len(data),
            pc.timestamp(), pc.cellsize(), 0,
        )
        self.socket.sendall(hdr + data)
        self.socket.recv(8)  # timestamp ack
        self.sent += 1
        if self.verbose:
            print(f"toproxy: sent {pc.count()} points, ts={pc.timestamp()}")

    def statistics(self) -> None:
        print(f"toproxy: sent={self.sent}")


def main() -> int:
    parser = ArgumentParser(description="Push pointclouds to a cwipc proxy")
    parser.add_argument("host", nargs="?", default="localhost")
    parser.add_argument("port", nargs="?", type=int, default=8887)
    args = parser.parse_args()
    beginOfRun(args)
    source = activesource_factory_from_args(args)()
    source.start()
    sender = Sender(args.host, args.port, verbose=args.verbose > 0)
    # explicit --count wins verbatim; only an OMITTED count defaults to 10
    count = args.count if args.count is not None else 10
    while sender.sent < count and not source.eof():
        if not source.available(True):
            continue
        pc = source.get()
        if pc is None:
            break
        sender.send_pc(pc)
        pc.free()
    sender.stop()
    source.stop()
    if args.verbose:
        sender.statistics()
    endOfRun(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
