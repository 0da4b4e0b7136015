"""cwipc forward: capture pointclouds and serve/push them over the network.

The port of cwipc_util_tpu/scripts/cwipc_forward.py.  The source delivers
its clouds on ``--device`` (default CUDA) and the encoder sink compresses
each on its device (kernel 1 in the downsample, kernel 3 for a tile's
mask) in its own thread, then sends the bytes to a netserver, a relay
(``--forward``) or a DASH ingest (``--lldpkg``, through SIGNALS).

Re-implementation of the reference's forward script
(reference: python/cwipc/scripts/cwipc_forward.py): source -> encoder (or
passthrough) -> netserver (serve) | netingest (push).  Tiled/multi-quality
stream fan-out is computed from the source's maxtile/tileinfo
(cwipc_forward.py:48-63).
"""

import sys
import threading

from ..net.sink_encoder import cwipc_sink_encoder
from ..net.sink_netingest import cwipc_sink_netingest
from ..net.sink_netserver import cwipc_sink_netserver
from ..net.sink_passthrough import cwipc_sink_passthrough
from ._scriptsupport import (
    ArgumentParser,
    SourceServer,
    activesource_factory_from_args,
    beginOfRun,
    endOfRun,
)

DEFAULT_PORT = 4303


def main() -> int:
    parser = ArgumentParser(description="Forward pointcloud streams over the network")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT, help=f"Serve on this port (default {DEFAULT_PORT})")
    parser.add_argument("--forward", metavar="HOST:PORT", help="Push to a cwipc netserver relay instead of serving")
    parser.add_argument("--lldpkg", metavar="URL", help="Push streams to a low-latency DASH ingest server (requires SIGNALS)")
    parser.add_argument("--noencode", action="store_true", help="Send uncompressed packets (fourcc cwi0)")
    parser.add_argument("--tiled", action="store_true", help="One stream per tile")
    parser.add_argument("--octree_bits", type=int, action="append", help="Encoder octree depth (may repeat for multi-quality)")
    parser.add_argument("--jpeg_quality", type=int, action="append", help="Encoder color quality (may repeat)")
    parser.add_argument("--noforward", action="store_true", help="Don't forward pointclouds, only print statistics at the end")
    parser.add_argument("--tile", type=int, action="append", help="Encode/transmit only specific tile(s); may repeat")
    parser.add_argument("--seg_dur", type=int, metavar="MS", help="DASH packager segment duration (ms, default 10000)")
    parser.add_argument("--timeshift_buffer", type=int, metavar="MS", help="DASH packager timeshift buffer depth (ms, default 30000)")
    args = parser.parse_args()
    beginOfRun(args)

    source = activesource_factory_from_args(args)()

    if args.noforward:
        from ..net.abstract import cwipc_rawsink_abstract

        class _NullRawSink(cwipc_rawsink_abstract):
            """--noforward: count packets, send nothing (reference :73-76)."""

            def __init__(self):
                self.packets = 0

            def add_stream(self, tilenum=None, tiledesc=None, qualitydesc=None):
                return 0

            def set_fourcc(self, fourcc):
                pass

            def set_producer(self, producer):
                pass

            def start(self):
                pass

            def stop(self):
                pass

            def feed(self, buffer, stream_index=None):
                self.packets += 1
                return True

            def statistics(self):
                print(f"nullsink: packets={self.packets}")

        rawsink = _NullRawSink()
    elif args.lldpkg:
        from ..net.sink_lldpkg import cwipc_sink_lldpkg

        kwargs = {}
        if args.seg_dur is not None:
            kwargs["seg_dur_ms"] = args.seg_dur
        if args.timeshift_buffer is not None:
            kwargs["timeshift_buffer_ms"] = args.timeshift_buffer
        rawsink = cwipc_sink_lldpkg(args.lldpkg, verbose=args.verbose > 1, **kwargs)
    elif args.forward:
        rawsink = cwipc_sink_netingest(args.forward, verbose=args.verbose > 1)
    else:
        rawsink = cwipc_sink_netserver(args.port, verbose=args.verbose > 1, nodrop=args.nodrop)

    if args.noencode:
        if args.tiled or args.tile:
            # the reference silently ignores these too (tiledescriptions
            # feed only the encoder); at least say so
            print(
                f"{sys.argv[0]}: warning: --tiled/--tile require encoding,"
                " ignored with --noencode",
                file=sys.stderr,
            )
        forwarder = cwipc_sink_passthrough(rawsink, verbose=args.verbose > 0, nodrop=args.nodrop)
    else:
        forwarder = cwipc_sink_encoder(rawsink, verbose=args.verbose > 0, nodrop=args.nodrop)
        tiles = [{}]
        if (args.tiled or args.tile) and hasattr(source, "maxtile"):
            # --tile N selects specific tiles (implies tiled transport,
            # reference: cwipc_forward.py:49-58)
            maxtile = source.maxtile()
            wanted = list(range(1, maxtile)) if not args.tile else args.tile
            bad = [t for t in wanted if t < 1 or t >= maxtile]
            if bad:
                print(f"{sys.argv[0]}: no such tile(s): {bad} (maxtile {maxtile})")
                return -1
            tiles = [source.get_tileinfo_dict(i) for i in wanted] or [{}]
        forwarder.set_encoder_params(
            tiles, args.octree_bits or None, args.jpeg_quality or None
        )

    server = SourceServer(source, forwarder, args)
    thread = threading.Thread(target=server.run, name="cwipc_forward.source", daemon=True)
    forwarder.set_producer(thread)
    forwarder.start()
    thread.start()
    try:
        thread.join()
    except KeyboardInterrupt:
        pass
    server.stop()
    forwarder.stop()
    if args.verbose or args.noforward:
        # --noforward exists to print the statistics
        server.statistics()
        forwarder.statistics()
    endOfRun(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
