"""cwipc grab: capture pointclouds and write them to files.

The port of cwipc_util_tpu/scripts/cwipc_grab.py.  The source delivers
its clouds on ``--device`` (default CUDA); ``--compress`` encodes each one
on its device (the codec's device route: kernel 1 in the downsample,
kernel 3 for a tile mask) with one host read a frame.  The writer runs in
the source's thread, on the same default CUDA stream as the source.

Re-implementation of the reference's grab script
(reference: python/cwipc/scripts/cwipc_grab.py): source -> FileWriter sink
writing ply / cwipcdump / cwicpc files named by a pattern.
"""

import argparse
import os
import sys
import threading
from typing import Optional

from .. import CWIPC_FLAGS_BINARY, cwipc_write, cwipc_write_debugdump
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ._scriptsupport import (
    ArgumentParser,
    SourceServer,
    activesource_factory_from_args,
    beginOfRun,
    endOfRun,
)


class FileWriter:
    """Sink writing each fed cloud to a file named by the pattern."""

    def __init__(self, dirname: str, pattern: str, flags: int = 0,
                 compressed: bool = False, verbose: bool = False,
                 rgb: Optional[str] = None, depth: Optional[str] = None,
                 skeleton: Optional[str] = None, nopointclouds: bool = False,
                 fpattern: str = "timestamp", incore: bool = False,
                 compress_params: Optional[dict] = None,
                 exact_name: Optional[str] = None):
        self.exact_name = exact_name  # single-file mode: literal output name
        self.dirname = dirname
        self.pattern = pattern
        self.flags = flags
        self.compressed = compressed
        self.verbose = verbose
        self.rgb = rgb
        self.depth = depth
        self.skeleton = skeleton
        self.nopointclouds = nopointclouds
        self.fpattern = fpattern
        self.incore = incore
        self.pending = []  # --incore: buffered clouds, written at stop
        self.count_written = 0
        self.producer = None
        self.encoder = None
        if compressed:
            from ..codec import cwipc_new_encoder

            self.encoder = cwipc_new_encoder(**(compress_params or {}))

    def set_producer(self, producer) -> None:
        self.producer = producer

    def _stem(self, pc: cwipc_pointcloud_wrapper) -> str:
        """Filename variable per --fpattern (reference: cwipc_grab.py:213)."""
        if self.fpattern.startswith("count"):
            return f"{self.count_written:04d}"
        return str(pc.timestamp())

    def _write_aux(
        self, pc: cwipc_pointcloud_wrapper, images: bool = True, skeletons: bool = True
    ) -> bool:
        """Write RGB/depth aux images and skeleton files when the matching
        --rgb/--depth/--skeleton flag was given (reference:
        python/cwipc/scripts/cwipc_grab.py:210-212).  Returns whether
        anything was written."""
        md = pc._metadata
        if md is None:
            return False
        import json

        wrote = False
        for i in range(md.count()):
            name = md.name(i)
            ts = self._stem(pc)
            want_img = images and (
                (self.rgb and name.startswith("rgb"))
                or (self.depth and name.startswith("depth"))
            )
            if want_img:
                ext = (self.rgb if name.startswith("rgb") else self.depth) or "png"
                try:
                    img = md.get_image(i)
                except (ValueError, KeyError):
                    continue
                try:
                    import cv2

                    out = os.path.join(self.dirname, f"{name}-{ts}.{ext}")
                    cv2.imwrite(out, img[..., ::-1] if img.ndim == 3 else img)
                    wrote = True
                except ImportError:
                    pass
            elif skeletons and self.skeleton and name.startswith("skeleton"):
                from ..core.pointcloud import parse_skeleton_collection

                n_s, n_j, joints = parse_skeleton_collection(md.data(i))
                out = os.path.join(self.dirname, f"{name}-{ts}.{self.skeleton}")
                with open(out, "w") as fp:
                    json.dump(
                        dict(
                            n_skeletons=n_s,
                            n_joints=n_j,
                            joints=[
                                dict(confidence=j.confidence, x=j.x, y=j.y, z=j.z,
                                     q_w=j.q_w, q_x=j.q_x, q_y=j.q_y, q_z=j.q_z)
                                for j in joints
                            ],
                        ),
                        fp,
                    )
                wrote = True
        return wrote

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        if self.incore:
            # --incore: buffer everything, write at the end (reference
            # cwipc_grab.py:214 — trades memory for capture-rate fidelity)
            self.pending.append(pc)
            self.count_written += 1
            return
        self._write_one(pc)

    def _write_one(self, pc: cwipc_pointcloud_wrapper) -> None:
        self._write_aux(pc)
        if not self.nopointclouds:
            name = self.exact_name if self.exact_name else self.pattern % self._stem(pc)
            filename = os.path.join(self.dirname, name)
            if filename.endswith(".cwipcdump"):
                cwipc_write_debugdump(filename, pc)
            elif filename.endswith(".cwicpc"):
                assert self.encoder is not None
                self.encoder.feed(pc)
                with open(filename, "wb") as fp:
                    fp.write(self.encoder.get_bytes())
            else:
                cwipc_write(filename, pc, self.flags)
            if self.verbose:
                print(f"grab: wrote {filename}")
        self.count_written += 1
        pc.free()

    def flush_pending(self) -> None:
        if not self.pending:
            return
        self.count_written = 0
        for pc in self.pending:
            self._write_one(pc)
        self.pending = []

    # -- reference-parity sink surface (reference: cwipc_grab.py FileWriter:
    # start/stop/run/setup_encoder/save_pc/save_images/save_skeletons) ------

    def start(self) -> None:
        """No-op lifecycle hook (the reference's FileWriter has none either)."""

    def stop(self) -> None:
        """Flush any --incore buffered clouds."""
        self.flush_pending()

    def run(self) -> bool:
        """Drain loop: in the reference the writer thread consumes a queue
        here; this writer saves synchronously in feed(), so run() waits for
        the producer to finish and flushes buffered clouds.  Returns success
        like the reference."""
        import time as _time

        while self.producer is not None and self.producer.is_alive():
            _time.sleep(0.1)
        self.flush_pending()
        return True

    def setup_encoder(self, params: Optional[dict]) -> None:
        """(Re)create the compressed-output encoder from a parameter dict
        (reference: cwipc_grab.py FileWriter.setup_encoder)."""
        from ..codec import cwipc_new_encoder

        self.encoder = cwipc_new_encoder(**(params or {}))
        self.compressed = True

    def save_pc(self, pc: cwipc_pointcloud_wrapper) -> bool:
        """Save one cloud (and requested aux data) now; False on error."""
        try:
            self._write_one(pc)
            return True
        except (OSError, ValueError, AssertionError) as e:
            print(f"writer: error: {e}")
            return False

    def save_images(self, pc: cwipc_pointcloud_wrapper) -> bool:
        """Save the cloud's RGB/depth aux images per --rgb/--depth; True if
        any image was written."""
        return self._write_aux(pc, images=True, skeletons=False)

    def save_skeletons(self, pc: cwipc_pointcloud_wrapper) -> bool:
        """Save the cloud's skeleton metadata per --skeleton; True if any
        skeleton was written."""
        return self._write_aux(pc, images=False, skeletons=True)

    def statistics(self) -> None:
        print(f"filewriter: written={self.count_written}")


def make_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Capture pointclouds to files")
    parser.add_argument("--nopointclouds", action="store_true", help="Don't save pointclouds (aux data only)")
    parser.add_argument("--cwipcdump", action="store_true", help="Save as .cwipcdump (default: .ply)")
    parser.add_argument("--compress", action="store_true", help="Save as compressed .cwicpc")
    parser.add_argument("--compress_param", action="append", metavar="NAME=VALUE", help="Add compressor parameter")
    parser.add_argument("--binary", action="store_true", help="Save as binary .ply")
    parser.add_argument("--rgb", metavar="EXT", help="Save captured RGB aux images as type EXT")
    parser.add_argument("--depth", metavar="EXT", help="Save captured depth aux images as type EXT")
    parser.add_argument("--skeleton", metavar="EXT", help="Save skeleton metadata as files of type EXT")
    parser.add_argument("--fpattern", metavar="VAR", default="timestamp", help="Name files by VAR: count or timestamp (default)")
    parser.add_argument("--incore", action="store_true", help="Buffer all captures in memory and write at the end (requires --count)")
    # internal (used by cwipc copy's single-file conversion path): write ONE
    # output file with exactly this name instead of pattern-named files
    parser.add_argument("--single_output", help=argparse.SUPPRESS)
    parser.add_argument("outputdir", nargs="?", help="Directory to write the files to")
    return parser


def main() -> int:
    parser = make_parser()
    args = parser.parse_args()
    if not args.single_output and args.outputdir is None:
        parser.error("the following arguments are required: outputdir")
    beginOfRun(args)
    exact_name = None
    if args.single_output:
        # single-file conversion mode (cwipc copy): the output format comes
        # from the target extension (reference cwipc_copy.py:234-245)
        args.outputdir = os.path.dirname(args.single_output) or "."
        exact_name = os.path.basename(args.single_output)
        args.cwipcdump = exact_name.endswith(".cwipcdump")
        args.compress = exact_name.endswith(".cwicpc")
    if not args.outputdir or not os.path.isdir(args.outputdir):
        print(f"{sys.argv[0]}: no such directory: {args.outputdir}")
        return -1
    if args.incore and not args.count:
        print(f"{sys.argv[0]}: --incore requires --count")
        return -1
    if args.cwipcdump:
        pattern, flags, compressed = "pointcloud-%s.cwipcdump", 0, False
    elif args.compress:
        pattern, flags, compressed = "pointcloud-%s.cwicpc", 0, True
    else:
        pattern, flags, compressed = "pointcloud-%s.ply", (CWIPC_FLAGS_BINARY if args.binary else 0), False

    compress_params = {}
    for p in args.compress_param or []:
        if "=" not in p:
            print(f"{sys.argv[0]}: --compress_param expects NAME=VALUE: {p}")
            return -1
        name, value = p.split("=", 1)
        try:
            compress_params[name] = int(value)
        except ValueError:
            compress_params[name] = value

    source = activesource_factory_from_args(args)()
    for wanted, md_name in ((args.rgb, "rgb"), (args.depth, "depth"), (args.skeleton, "skeletons")):
        if wanted and hasattr(source, "request_metadata"):
            source.request_metadata(md_name)
    writer = FileWriter(
        args.outputdir, pattern, flags, compressed, verbose=args.verbose > 0,
        rgb=args.rgb, depth=args.depth, skeleton=args.skeleton,
        nopointclouds=args.nopointclouds, fpattern=args.fpattern,
        incore=args.incore, compress_params=compress_params,
        exact_name=exact_name,
    )
    server = SourceServer(source, writer, args)
    thread = threading.Thread(target=server.run, name="cwipc_grab.source", daemon=True)
    writer.set_producer(thread)
    thread.start()
    thread.join()
    server.stop()
    writer.flush_pending()
    if args.verbose:
        server.statistics()
        writer.statistics()
    endOfRun(args)
    return 0 if writer.count_written else 1


if __name__ == "__main__":
    sys.exit(main())
