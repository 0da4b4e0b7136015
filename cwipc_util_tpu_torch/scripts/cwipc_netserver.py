"""cwipc netserver: pure-Python TCP relay (ingest -> fan-out).

The port of cwipc_util_tpu/scripts/cwipc_netserver.py.  It relays framed
packets (``net/sink_netserver.HEADER_FORMAT``) and touches no cloud, so it
runs on the host only.

Re-implementation of the reference's relay
(reference: python/cwipc/scripts/cwipc_netserver.py): an IngestServer
receives frames pushed by `cwipc forward --forward` (one IngestHandler per
producer connection), a ForwardServer fans them out to any number of
clients (one ForwardHandler per client, each with a bounded queue of
MAX_OUTPUT_QUEUE packets, drop-on-full).

One difference from the JAX script: when the relay shuts down (the
producer gone with ``--oneshot``, or an interrupt), each client is first
sent what its queue still holds, within FLUSH_SECONDS, so a consumer
slower than the producer still gets every frame that was relayed.  The
JAX script's clients stop at once and drop those frames.
"""

import queue
import socket
import struct
import sys
import threading
import time
from typing import List, Optional

from ..net.sink_netserver import HEADER_FORMAT, HEADER_SIZE
from ._scriptsupport import BaseArgumentParser, beginOfRun, endOfRun

DEFAULT_INGEST_PORT = 4303
DEFAULT_SERVE_PORT = 4304
# per-client output queue bound (reference: cwipc_netserver.py MAX_OUTPUT_QUEUE)
MAX_OUTPUT_QUEUE = 10
CLIENT_QUEUE_SIZE = MAX_OUTPUT_QUEUE
# at shutdown, how long a client's queued packets may take to send
FLUSH_SECONDS = 10.0


class _RelayState:
    """State shared by the two servers: the client queues and shutdown."""

    def __init__(self, verbose: bool = False, oneshot: bool = False):
        self.verbose = verbose
        self.oneshot = oneshot
        self.clients: List[queue.Queue] = []
        self.clients_lock = threading.Lock()
        self.done = threading.Event()

    def distribute(self, packet: bytes) -> None:
        with self.clients_lock:
            for q in self.clients:
                try:
                    q.put(packet, block=False)
                except queue.Full:
                    pass

    def add_client(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=CLIENT_QUEUE_SIZE)
        with self.clients_lock:
            self.clients.append(q)
        return q

    def remove_client(self, q: queue.Queue) -> None:
        with self.clients_lock:
            if q in self.clients:
                self.clients.remove(q)


class _HandlerBase:
    """Per-connection handler plumbing shared by both directions."""

    def __init__(self, conn: socket.socket, addr, state: _RelayState):
        self.conn = conn
        self.addr = addr
        self.state = state
        self.stopped = False

    def log(self, message: str) -> None:
        print(f"netserver: {self.addr}: {message}", flush=True)

    def log_verbose(self, message: str) -> None:
        if self.state.verbose:
            self.log(message)

    def stop(self) -> None:
        self.stopped = True
        try:
            self.conn.close()
        except OSError:
            pass

    def _recv_all(self, n: int) -> Optional[bytes]:
        chunks, remaining = [], n
        while remaining > 0:
            chunk = self.conn.recv(remaining)
            if not chunk:
                return None
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)


class IngestHandler(_HandlerBase):
    """One producer connection: receive framed packets, hand each to the
    relay for fan-out (reference: cwipc_netserver.py:99-198)."""

    def handle(self) -> None:
        self.log_verbose("ingest connection")
        try:
            self.handle_receive()
        finally:
            self.stop()
        if self.state.oneshot:
            self.state.done.set()

    def handle_receive(self) -> None:
        while not self.stopped and not self.state.done.is_set():
            hdr = self._recv_all(HEADER_SIZE)
            if hdr is None:
                break
            _, length, _ = struct.unpack(HEADER_FORMAT, hdr)
            payload = self._recv_all(length)
            if payload is None:
                break
            self.receiver_forward(hdr + payload)

    def receiver_forward(self, packet: bytes) -> None:
        self.state.distribute(packet)


class ForwardHandler(_HandlerBase):
    """One consumer connection: drain this client's queue onto its socket,
    dropping the client on error (reference: cwipc_netserver.py:17-86)."""

    def handle(self) -> None:
        self.log_verbose("client connection")
        q = self.state.add_client()
        try:
            self.handle_transmit(q)
        except OSError:
            pass
        finally:
            self.state.remove_client(q)
            self.stop()

    def handle_transmit(self, q: queue.Queue) -> None:
        # at shutdown what the queue holds is sent first (Relay.run waits
        # FLUSH_SECONDS for it)
        while not self.stopped:
            try:
                packet = q.get(timeout=0.1 if self.state.done.is_set() else 0.5)
            except queue.Empty:
                if self.state.done.is_set():
                    break
                continue
            self.transmitter_forward(packet)

    def transmitter_forward(self, packet: bytes) -> None:
        self.conn.sendall(packet)


class _ServerBase:
    """Accept loop spawning one handler thread per connection."""

    handler_class = _HandlerBase
    backlog = 4

    def __init__(self, port: int, state: _RelayState):
        self.state = state
        self.handlers: List[threading.Thread] = []
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("", port))
        self.sock.listen(self.backlog)
        self.sock.settimeout(0.5)

    def serve_forever(self) -> None:
        while not self.state.done.is_set():
            try:
                conn, addr = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            handler = self.handler_class(conn, addr, self.state)
            thread = threading.Thread(target=handler.handle, daemon=True)
            thread.start()
            self.handlers.append(thread)

    def close(self) -> None:
        self.sock.close()


class IngestServer(_ServerBase):
    """Accepts producer connections (reference: cwipc_netserver.py:199-212)."""

    handler_class = IngestHandler
    backlog = 1


class ForwardServer(_ServerBase):
    """Accepts consumer connections (reference: cwipc_netserver.py:87-97)."""

    handler_class = ForwardHandler


class Relay:
    """The complete relay: an IngestServer and a ForwardServer over shared
    client state; run() serves both until shutdown (or until the producer
    disconnects, with oneshot)."""

    def __init__(self, ingest_port: int, serve_port: int, verbose: bool = False, oneshot: bool = False):
        self.state = _RelayState(verbose=verbose, oneshot=oneshot)
        self.ingest_server = IngestServer(ingest_port, self.state)
        self.forward_server = ForwardServer(serve_port, self.state)

    @property
    def done(self) -> threading.Event:
        return self.state.done

    def run(self) -> None:
        t1 = threading.Thread(target=self.ingest_server.serve_forever, daemon=True)
        t2 = threading.Thread(target=self.forward_server.serve_forever, daemon=True)
        t1.start()
        t2.start()
        try:
            while not self.state.done.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            self.state.done.set()
        self.ingest_server.close()
        self.forward_server.close()
        deadline = time.monotonic() + FLUSH_SECONDS
        for thread in self.forward_server.handlers:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))


def main() -> int:
    parser = BaseArgumentParser(description="Pointcloud stream relay")
    parser.add_argument("--port", type=int, default=DEFAULT_INGEST_PORT, help="Ingest port")
    parser.add_argument("--serveport", type=int, default=DEFAULT_SERVE_PORT, help="Client serving port")
    parser.add_argument("--oneshot", action="store_true", help="Exit after the producer disconnects")
    args = parser.parse_args()
    beginOfRun(args)
    relay = Relay(args.port, args.serveport, verbose=args.verbose > 0, oneshot=args.oneshot)
    relay.run()
    endOfRun(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
