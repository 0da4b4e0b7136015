"""cwipc view: capture pointclouds and show them in a window.

Re-implementation of the reference's view script
(reference: python/cwipc/scripts/cwipc_view.py): source -> SourceServer
thread -> Visualizer; --nodisplay for headless runs.

The port of cwipc_util_tpu/scripts/cwipc_view.py.  The source delivers
its clouds on ``--device`` (default CUDA); the viewer selects tiles on
that device (kernel 3) and reads each displayed cloud to the host once
to render it.  ``--profile DIR`` records the run with ``torch.profiler``
(the card's kernels too, when there is one) and writes a Chrome trace,
``DIR/trace.json``.
"""

import os
import sys
import threading

from ..io.visualizer import Visualizer
from ._scriptsupport import (
    ArgumentParser,
    SourceServer,
    activesource_factory_from_args,
    beginOfRun,
    endOfRun,
)


def help_commands():
    """Print the viewer keymap (reference: cwipc_view.py:12-13)."""
    print(Visualizer.HELP)


def make_parser() -> ArgumentParser:
    parser = ArgumentParser(description="View pointcloud streams")
    parser.add_argument("--nodisplay", action="store_true", help="Run without a display window (count clouds only)")
    parser.add_argument("--latencies", metavar="FILE", help="Write per-cloud latency CSV to FILE")
    parser.add_argument("--rgb", action="store_true", help="Show RGB auxiliary images in a second window")
    parser.add_argument("--rgb_full", action="store_true", help="With --rgb: one window per camera")
    parser.add_argument("--rgb_cw", action="store_true", help="With --rgb: concatenate images horizontally")
    parser.add_argument("--rgb_ccw", action="store_true", help="With --rgb: concatenate images horizontally")
    parser.add_argument("--paused", action="store_true", help="Start paused")
    parser.add_argument("--skeleton", action="store_true", help="Also request and render skeleton metadata (capturers that support it)")
    parser.add_argument("--timestamps", action="store_true", help="Print detailed timestamp information per displayed cloud")
    parser.add_argument("--help_commands", action="store_true", help="List interactive commands and exit")
    parser.add_argument("--profile", metavar="DIR", help="Write a torch.profiler Chrome trace of the run to DIR/trace.json")
    return parser


def main() -> int:
    args = make_parser().parse_args()
    if args.profile:
        # device-level tracing for perf work: the whole run lands in a
        # Chrome trace (chrome://tracing, Perfetto) under DIR
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            rv = _main_inner(args)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        return rv
    return _main_inner(args)


def _main_inner(args) -> int:
    if args.help_commands:
        from ..io.visualizer import HELP

        print(HELP)
        return 0
    beginOfRun(args)

    source_factory = activesource_factory_from_args(args)
    source = source_factory()
    if args.rgb and hasattr(source, "request_metadata"):
        source.request_metadata("rgb")
    if args.skeleton and hasattr(source, "request_metadata"):
        source.request_metadata("skeletons")
    if (args.timestamps or args.latencies) and hasattr(source, "request_metadata"):
        source.request_metadata("timestamps")
    visualizer = Visualizer(verbose=args.verbose > 0, nodisplay=args.nodisplay, args=args)
    if args.paused and not args.nodisplay:
        # start held; single_step shows the first frame (reference
        # visualizer.py:71-74).  Headless runs ignore --paused (nothing
        # could ever unpause them).
        visualizer.paused = True
        visualizer.single_step = True
    if args.skeleton and visualizer.window is not None and hasattr(visualizer.window, "render_skeleton"):
        visualizer.window.render_skeleton = True
    visualizer.set_source(source)
    server = SourceServer(source, visualizer, args)

    source_thread = threading.Thread(target=server.run, name="cwipc_view.source", daemon=True)
    visualizer.set_producer(source_thread)
    source_thread.start()
    try:
        visualizer.run()
    except KeyboardInterrupt:
        pass
    server.stop()
    source_thread.join(timeout=5)
    if args.verbose:
        server.statistics()
        visualizer.statistics()
    if args.latencies:
        with open(args.latencies, "w") as fp:
            fp.write("latency\n")
            for lat in server.get_latencies():
                fp.write(f"{lat}\n")
    endOfRun(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
