"""Shared CLI plumbing: argument parsers, source factory, SourceServer loop.

The port of cwipc_util_tpu/scripts/_scriptsupport.py.  The parser gains
one argument, ``--device`` (default ``cuda``; ``cpu`` runs on the host):
the port's explicit device, which every source the factory builds gets,
and every file ``read_pointcloud`` reads (commands on
``BaseArgumentParser`` that read clouds add it with
``add_device_argument``).
Naming CUDA where there is none raises :class:`CwipcError`, as
``resolve_device`` does.  The DASH sources decode on that device too:
``--lldplay`` through one decoder, ``--mt-lldplay`` through a decoder a
tile, joined by the synchronizer (as ``--mt-netclient``).

Re-implementation of the reference's script-support layer
(reference: python/cwipc/scripts/_scriptsupport.py): the single place that
maps command-line arguments to source graphs (synthetic / capturer / proxy /
playback / netclient / tiled netclient + decoder + synchronizer pipelines),
plus the SourceServer grab loop with fps pacing, inpoint/outpoint and
latency statistics, and the SIGQUIT all-thread stack dumper.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import signal
import sys
import time
from typing import Callable, List, Optional, cast

from .. import (
    CWIPC_LOG_LEVEL_DEBUG,
    CWIPC_LOG_LEVEL_ERROR,
    CWIPC_LOG_LEVEL_NONE,
    CWIPC_LOG_LEVEL_TRACE,
    CWIPC_LOG_LEVEL_WARNING,
    cwipc_capturer,
    cwipc_check_module,
    cwipc_get_version,
    cwipc_log_configure,
    cwipc_log_default_callback,
    cwipc_proxy,
    cwipc_read,
    cwipc_read_debugdump,
    cwipc_synthetic,
)
from .. import filters
from ..abstract import cwipc_activesource_abstract
from ..core.buffers import resolve_device
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..models import playback
from ..net import (
    source_decoder,
    source_netclient,
    source_passthrough,
    source_synchronizer,
)
from ..utils.stats import Stats


def setup_signal_dump() -> None:
    """SIGQUIT dumps all thread stacks (reference: _scriptsupport.py:31-43)."""
    if hasattr(signal, "SIGQUIT"):
        faulthandler.register(signal.SIGQUIT, all_threads=True)


# The reference's name for the SIGQUIT stack-dump installer
# (reference: _scriptsupport.py:40-43).
SetupStackDumper = setup_signal_dump


def waitForDebugpy() -> None:
    """Listen for and block on a debugpy attach on port 5678
    (reference: _scriptsupport.py:456-461)."""
    import debugpy  # type: ignore

    debugpy.listen(5678)
    print(f"{sys.argv[0]}: waiting for debugpy attach on 5678", flush=True)
    debugpy.wait_for_client()
    print(f"{sys.argv[0]}: debugger attached")


class pipelined_activesource_factory:
    """Factory composing an active raw-source factory with a decoder factory:
    calling it builds the reader, wraps it in the decoder, and returns the
    decoder as the pipeline's active source
    (reference: _scriptsupport.py:105-114)."""

    def __init__(self, reader_factory, decoder_factory):
        self.reader_factory = reader_factory
        self.decoder_factory = decoder_factory

    def __call__(self) -> cwipc_activesource_abstract:
        reader = self.reader_factory()
        return self.decoder_factory(reader)


def _guess_playback_type(filenames: List[str]) -> Optional[str]:
    exts = {
        ext
        for ext in (".ply", ".cwipcdump", ".cwicpc")
        if any(fn.lower().endswith(ext) for fn in filenames)
    }
    if len(exts) != 1:
        return None
    return exts.pop()


def activesource_factory_from_args(
    args: argparse.Namespace, autoConfig: bool = False
) -> Callable[[], cwipc_activesource_abstract]:
    """Map CLI args to a factory producing the configured source graph,
    every source of it on ``args.device``."""
    verbose2 = args.verbose > 1
    device = resolve_device(args.device)

    if args.nodecode:
        passive = source_passthrough.cwipc_source_passthrough
        active = source_passthrough.cwipc_source_passthrough
    else:
        passive = source_decoder.cwipc_source_decoder
        active = source_decoder.cwipc_activesource_decoder

    def passivedecoder_factory(source, verbose=False):
        return passive(source, verbose=verbose, device=device)

    def activedecoder_factory(source, verbose=False):
        return active(source, verbose=verbose, device=device)

    if args.synthetic:
        return lambda: cwipc_synthetic(fps=args.fps, npoints=args.npoints, device=device)
    if args.proxy:
        return lambda: cwipc_proxy("", args.proxy, device=device)
    if args.playback:
        path = args.playback
        if not os.path.isdir(path):
            ptype = _guess_playback_type([path])
            if not ptype:
                print(f"{sys.argv[0]}: {path}: unknown playback file type")
                sys.exit(-1)
            return lambda: playback.cwipc_playback(
                [path], ext=ptype, fps=args.fps, loop=args.loop,
                inpoint=args.inpoint, outpoint=args.outpoint,
                retimestamp=args.retimestamp, device=device,
            )
        configfile = os.path.join(path, "cameraconfig.json")
        if os.path.exists(configfile):
            if args.loop:
                # Plumb --loop into the recording-replay capturer: load the
                # config and pass it inline with the flag folded in (the
                # playback capturer itself defaults to not looping, like
                # the reference's --loop default).
                import json as _json

                with open(configfile) as fp:
                    conf = _json.load(fp)
                conf["loop"] = True
                conf["_config_dir"] = os.path.abspath(path)
                return lambda: cwipc_capturer(_json.dumps(conf), device)
            return lambda: cwipc_capturer(configfile, device)
        ptype = _guess_playback_type(os.listdir(path))
        if not ptype:
            print(f"{sys.argv[0]}: {path}: should contain only one of .ply, .cwipcdump or .cwicpc files")
            sys.exit(-1)
        return lambda: playback.cwipc_playback(
            path, ext=ptype, fps=args.fps, loop=args.loop,
            inpoint=args.inpoint, outpoint=args.outpoint,
            retimestamp=args.retimestamp, device=device,
        )
    if args.netclient:
        def make_netclient() -> cwipc_activesource_abstract:
            rdr = source_netclient.cwipc_source_netclient(args.netclient, verbose=verbose2)
            return cast(cwipc_activesource_abstract, activedecoder_factory(rdr, verbose=verbose2))

        return make_netclient
    if args.mt_netclient:
        host, port, n_tile_s, n_qual_s = args.mt_netclient.split(":")
        n_tile, n_qual = int(n_tile_s), int(n_qual_s)

        def make_mt_netclient() -> cwipc_activesource_abstract:
            rdr = source_netclient.cwipc_multisource_netclient(
                f"{host}:{port}", n_tile, n_qual, verbose=verbose2
            )
            decoders = [
                passivedecoder_factory(rdr.get_tile_source(i), verbose=verbose2)
                for i in range(n_tile)
            ]
            return source_synchronizer.cwipc_source_synchronizer(rdr, decoders, verbose=verbose2)

        return make_mt_netclient
    if args.lldplay:
        def make_lldplay() -> cwipc_activesource_abstract:
            from ..net import source_lldplay

            rdr = source_lldplay.cwipc_source_lldplay(args.lldplay, verbose=verbose2)
            return cast(cwipc_activesource_abstract, activedecoder_factory(rdr, verbose=verbose2))

        return make_lldplay
    if args.mt_lldplay:
        def make_mt_lldplay() -> cwipc_activesource_abstract:
            from ..net import source_lldplay

            rdr = source_lldplay.cwipc_multisource_lldplay(args.mt_lldplay, verbose=verbose2)
            rdr.start()
            decoders = [
                passivedecoder_factory(rdr.get_tile_source(i), verbose=verbose2)
                for i in range(rdr.get_tile_count())
            ]
            return source_synchronizer.cwipc_source_synchronizer(rdr, decoders, verbose=verbose2)

        return make_mt_lldplay
    if getattr(args, "kinect", False) or getattr(args, "realsense", False) or getattr(args, "orbbec", False):
        name = "kinect" if args.kinect else ("realsense2" if args.realsense else "orbbec")
        if not cwipc_check_module(name):
            print(f"{sys.argv[0]}: No support for {name} grabber on this platform")
            sys.exit(-1)
        config = "auto" if autoConfig else (args.cameraconfig or "auto")
        return lambda: cwipc_capturer(f'{{"type":"{name}"}}' if config == "auto" else config, device)
    # Default: the generic capturer.
    if autoConfig:
        return lambda: cwipc_capturer("auto", device)
    if args.cameraconfig:
        return lambda: cwipc_capturer(args.cameraconfig, device)
    return lambda: cwipc_capturer(None, device)


class SourceServer:
    """The producer loop: grab -> filters -> feed(viewer/sink), with stats."""

    def __init__(self, grabber, viewer, args: argparse.Namespace, owns_grabber: bool = True):
        self.grabber = grabber
        self.viewer = viewer
        self.verbose = args.verbose
        self.count = args.count
        self.inpoint = args.inpoint
        self.outpoint = args.outpoint
        # --fps paces every source type; synthetic/playback also pace
        # internally, so the second gate here is a no-op for them
        self.fps = getattr(args, "fps", None)
        self.lastGrabTime: Optional[float] = None
        self._next_due: Optional[float] = None
        self.stopped = False
        self.owns_grabber = owns_grabber
        self.stats = Stats("grab")
        self.latency_grab: List[float] = []
        self.pc_filters: List[filters.cwipc_abstract_filter] = []
        if getattr(args, "filter", None):
            for fdesc in args.filter:
                self.pc_filters.append(filters.factory(fdesc))
        if self.owns_grabber:
            if not self.grabber.start():
                print("grab: failed to start() grabber", flush=True)
                self.grabber = None
                self.stopped = True

    def stop(self) -> None:
        if self.stopped:
            return
        if self.grabber and self.owns_grabber:
            self.grabber.stop()
        self.stopped = True

    def grab_pc(self) -> Optional[cwipc_pointcloud_wrapper]:
        if self.fps:
            # ABSOLUTE deadline ladder, like the sources' internal gates
            # (models/synthetic.py get()): the old relative form scheduled
            # from lastGrabTime — a POST-capture stamp — so every period
            # silently absorbed the capture cost (+ sleep overshoot) and a
            # nominal 30 fps forward pipeline delivered ~25 (40 ms cadence,
            # measured round 5).  A producer that falls a full period
            # behind resynchronizes instead of bursting.
            now = time.time()
            if self._next_due is not None and now < self._next_due:
                time.sleep(self._next_due - now)
                now = time.time()
            base = self._next_due if self._next_due is not None else now
            nxt = base + 1.0 / self.fps
            if nxt < now:
                nxt = now + 1.0 / self.fps
            self._next_due = nxt
        if not self.grabber or self.grabber.eof():
            return None
        if not self.grabber.available(True):
            if self.grabber.eof():
                return None
            time.sleep(0.1)
            return None
        pc = self.grabber.get()
        self.lastGrabTime = time.time()
        return pc

    def run(self) -> None:
        assert self.grabber
        if self.inpoint:
            if self.grabber.seek(self.inpoint):
                print(f"grab: seek to timestamp {self.inpoint} successful", flush=True)
        while not self.stopped and not self.grabber.eof():
            t0 = time.time()
            pc = self.grab_pc()
            if not pc:
                continue
            # trim BEFORE filtering: skipped frames must be freed (not
            # leaked) and not pay the filter chain
            if self.viewer:
                t = pc.timestamp()
                if self.inpoint and t < self.inpoint:
                    pc.free()
                    continue
                if self.outpoint and t > self.outpoint:
                    pc.free()
                    self.count = 0
                    self.stop()
                    continue
            for f in self.pc_filters:
                pc = f.filter(pc)
            self.stats.add("capture_pointcount", pc.count(), isInt=True)
            pc_timestamp = pc.timestamp() / 1000.0
            if self.verbose:
                print(f"grab: captured {pc.count()} points, ts={pc.timestamp()}")
            t1 = time.time()
            if self.viewer:
                self.viewer.feed(pc)
            self.latency_grab.append(time.time() - pc_timestamp)
            self.stats.add("capture_duration", t1 - t0)
            if self.count is not None:
                self.count -= 1
                if self.count <= 0:
                    break
        if self.verbose:
            print("grab: stopped", flush=True)

    def statistics(self) -> None:
        self.stats.print()
        if self.grabber:
            self.grabber.statistics()
        for f in self.pc_filters:
            f.statistics()

    def print1stat(self, name: str, values, isInt: bool = False) -> None:
        """Print count/average/min/max of one series
        (reference: _scriptsupport.py:401-413)."""
        from ..utils.stats import print1stat

        print1stat("grab", name, values, isInt)

    def get_latencies(self) -> List[float]:
        return self.latency_grab


def read_pointcloud(filename: str, device) -> cwipc_pointcloud_wrapper:
    """A .cwipcdump or .ply file as a cloud on ``device``."""
    if filename.endswith(".cwipcdump"):
        return cwipc_read_debugdump(filename, device)
    return cwipc_read(filename, 0, device)


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", action="store", default="cuda",
                        help="Torch device the clouds go to (default cuda; cpu runs on the host)")


def BaseArgumentParser(*args, **kwargs) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(*args, **kwargs)
    parser.add_argument("--version", action="store_true", help="Print version and exit")
    parser.add_argument("-v", "--verbose", action="count", default=0, help="Verbose output (repeat for more)")
    parser.add_argument("--logging", type=str, action="store", metavar="LEVEL", help="Set cwipc logging level (error, warning, trace, debug)")
    parser.add_argument("--pausefordebug", action="store_true", help="Pause at begin and end of run")
    parser.add_argument("--debugpy", action="store_true", help="Wait for debugpy attach at start")
    return parser


def ArgumentParser(*args, **kwargs) -> argparse.ArgumentParser:
    parser = BaseArgumentParser(*args, **kwargs)
    sel = parser.add_argument_group("input source selection").add_mutually_exclusive_group()
    parser.add_argument("--cameraconfig", action="store", help="Camera configuration file (default ./cameraconfig.json; 'auto' probes)")
    sel.add_argument("--realsense", action="store_true", help="Use Intel Realsense capturer")
    sel.add_argument("--kinect", action="store_true", help="Use Azure Kinect capturer")
    sel.add_argument("--orbbec", action="store_true", help="Use Orbbec capturer")
    sel.add_argument("--synthetic", action="store_true", help="Use synthetic pointcloud source")
    sel.add_argument("--proxy", type=int, action="store", metavar="PORT", help="Receive pointclouds on proxy server port PORT")
    sel.add_argument("--netclient", action="store", metavar="HOST:PORT", help="Receive pointclouds from a netserver")
    sel.add_argument("--lldplay", action="store", metavar="URL", help="DASH pointcloud stream from URL")
    sel.add_argument("--mt-netclient", action="store", metavar="HOST:PORT:NT:NQ", help="Tiled multi-quality netclient")
    sel.add_argument("--mt-lldplay", action="store", metavar="URL", help="Tiled multi-quality DASH stream")
    sel.add_argument("--playback", action="store", metavar="PATH", help="Play back ply/cwipcdump/cwicpc file or directory")

    inp = parser.add_argument_group("input arguments")
    inp.add_argument("--nodecode", action="store_true", help="Receive uncompressed pointclouds (with --netclient)")
    inp.add_argument("--loop", action="store_true", help="With --playback: loop")
    inp.add_argument("--npoints", action="store", metavar="N", type=int, default=0, help="Approximate point count for synthetic source")
    inp.add_argument("--fps", action="store", type=int, default=0, help="Limit rate to FPS")
    inp.add_argument("--retimestamp", action="store_true", help="Use wall clock timestamps")
    inp.add_argument("--count", type=int, action="store", metavar="N", help="Stop after N pointclouds")
    inp.add_argument("--inpoint", type=int, action="store", metavar="N", help="Start at frame with timestamp > N")
    inp.add_argument("--outpoint", type=int, action="store", metavar="N", help="Stop at frame with timestamp >= N")
    inp.add_argument("--nodrop", action="store_true", help="Do not drop frames on full queues")
    inp.add_argument("--filter", action="append", metavar="FILTERDESC", help="Apply filter(s) to each cloud, in order")
    inp.add_argument("--help_filters", action="store_true", help="List available filters and exit")
    add_device_argument(parser)
    return parser


def beginOfRun(args: argparse.Namespace) -> None:
    setup_signal_dump()
    if args.version:
        print(cwipc_get_version())
        sys.exit(0)
    if getattr(args, "help_filters", False):
        filters.help()
        sys.exit(0)
    if args.pausefordebug:
        answer = None
        while answer != "Y":
            print(f"{sys.argv[0]}: starting, pid={os.getpid()}. Press Y to continue -", flush=True)
            line = sys.stdin.readline()
            if not line:  # stdin at EOF (scripted run): proceed, don't spin
                break
            answer = line.strip()
    if args.debugpy:
        waitForDebugpy()
    if hasattr(args, "device"):
        args.device = resolve_device(args.device)
    if args.logging:
        levelmap = {
            "error": CWIPC_LOG_LEVEL_ERROR,
            "warning": CWIPC_LOG_LEVEL_WARNING,
            "trace": CWIPC_LOG_LEVEL_TRACE,
            "debug": CWIPC_LOG_LEVEL_DEBUG,
        }
        level = levelmap.get(args.logging.lower(), CWIPC_LOG_LEVEL_NONE)
        cwipc_log_configure(level, cwipc_log_default_callback)


def endOfRun(args: argparse.Namespace) -> None:
    if args.pausefordebug:
        answer = None
        while answer != "Y":
            print(f"{sys.argv[0]}: stopping, pid={os.getpid()}. Press Y to continue -", flush=True)
            line = sys.stdin.readline()
            if not line:  # stdin at EOF: proceed, don't spin
                break
            answer = line.strip()
