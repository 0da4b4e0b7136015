"""cwipc timing: per-cloud timestamp/latency CSV from timestamps metadata.

The port of cwipc_util_tpu/scripts/cwipc_timing.py; the source delivers
its clouds on ``--device`` (default CUDA).

Reference: python/cwipc/scripts/cwipc_timing.py.
"""

import csv
import queue
import sys
import time
from typing import Any, Dict, Iterable, List, Optional

from ._scriptsupport import (
    ArgumentParser,
    activesource_factory_from_args,
    beginOfRun,
    endOfRun,
)


class DropWriter:
    """Sink measuring per-cloud timing into CSV records
    (reference: cwipc_timing.py DropWriter): clouds are timed, recorded
    and dropped; per-stage "timestamps" metadata adds age columns."""

    BASE_KEYS = {"seq", "timestamp_ms", "received_ms", "latency_ms",
                 "frame_duration_ms", "pointcount", "aux"}

    def __init__(self, args, queuesize: int = 5):
        self.producer = None
        self.output_queue: "queue.Queue" = queue.Queue(maxsize=queuesize)
        self.count = 0
        self.details = getattr(args, "details", False)
        self.savergb = getattr(args, "savergb", 0)
        self.savergb_counter = self.savergb
        self.output_filename: Optional[str] = getattr(args, "output", None)
        self.results: List[Dict[str, Any]] = []
        self.csvwriter: Optional[csv.DictWriter] = None
        self.csvkeys: List[str] = []
        self._fp = None
        self.previous_timestamp: Optional[int] = None

    def start(self) -> None:
        pass

    def stop(self) -> None:
        if self._fp is not None and self._fp is not sys.stdout:
            self._fp.close()
            self._fp = None

    def set_producer(self, producer) -> None:
        self.producer = producer

    def feed(self, pc) -> None:
        self.output_queue.put(pc)

    def run(self) -> bool:
        while (self.producer is not None and self.producer.is_alive()) or not self.output_queue.empty():
            try:
                pc = self.output_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            self.record_pc(pc)
            pc.free()
        return True

    def record_pc(self, pc) -> None:
        """Build and write one timing record for a cloud."""
        self.count += 1
        now_ms = int(time.time() * 1000)
        ts = pc.timestamp()
        r: Dict[str, Any] = dict(
            seq=self.count - 1,
            timestamp_ms=ts,
            received_ms=now_ms,
            latency_ms=now_ms - ts,
            frame_duration_ms="" if self.previous_timestamp is None else ts - self.previous_timestamp,
            pointcount=pc.count(),
        )
        self.previous_timestamp = ts
        md = pc._metadata
        r["aux"] = md.count() if md is not None else 0
        if md is not None:
            for i in range(md.count()):
                name = md.name(i)
                if "timestamps" not in name:
                    continue
                descr = md._parse_aux_description(md.description(i))
                for k, v in descr.items():
                    r[f"{name}.{k}"] = v
                if "depth_timestamp" in descr:
                    r[f"{name}.depth_age"] = ts - descr["depth_timestamp"]
                if "color_timestamp" in descr:
                    r[f"{name}.color_age"] = ts - descr["color_timestamp"]
            if self.savergb:
                self.savergb_counter -= 1
                if self.savergb_counter <= 0:
                    self.savergb_counter = self.savergb
                    self.save_rgb(pc, md)
        # every record prints, metadata or not (the reference prints each
        # record unconditionally under --details)
        if self.details:
            print(f"timing: {r}", file=sys.stderr)
        self.results.append(r)
        self.writerecord(r)

    def save_rgb(self, pc, metadata) -> None:
        """Write the cloud's RGB aux images as <ts>.<serial>.png
        (reference: cwipc_timing.py save_rgb)."""
        try:
            import cv2
        except ImportError:
            return
        ts = pc.timestamp()
        for serial, image in metadata.get_all_images("rgb").items():
            filename = f"{ts}.{serial}.png"
            ok = cv2.imwrite(filename, image[..., ::-1] if image.ndim == 3 else image)
            print(f"{'wrote' if ok else 'Error: failed to write'} {filename}",
                  file=sys.stderr)

    def writerecord(self, record: Dict[str, Any]) -> None:
        if self.csvwriter is None:
            self.init_csv(record)
        assert self.csvwriter
        self.csvwriter.writerow(self.filter_record(record))
        if self._fp is sys.stdout:
            sys.stdout.flush()

    def init_csv(self, record: Dict[str, Any]) -> None:
        self.csvkeys = self.filter_keys(record.keys())
        self._fp = open(self.output_filename, "w") if self.output_filename else sys.stdout
        self.csvwriter = csv.DictWriter(self._fp, self.csvkeys)
        self.csvwriter.writeheader()

    def filter_record(self, record: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in record.items() if k in self.csvkeys}

    def filter_keys(self, keys: Iterable[str]) -> List[str]:
        """Without --details, keep the base columns and the per-stage age
        columns (reference: cwipc_timing.py filter_keys)."""
        if self.details:
            return list(keys)
        return [k for k in keys if k in self.BASE_KEYS or "age" in k]

    def statistics(self) -> None:
        pass


def main() -> int:
    parser = ArgumentParser(description="Measure per-cloud timing of a source")
    parser.add_argument("--output", metavar="FILE", help="Write CSV to FILE (default stdout)")
    parser.add_argument("--details", action="store_true", help="Include every record column, and print records as captured")
    parser.add_argument("--savergb", type=int, default=0, metavar="N", help="Save every Nth RGB aux image next to the CSV")
    args = parser.parse_args()
    beginOfRun(args)
    source = activesource_factory_from_args(args)()
    try:
        source.request_metadata("timestamps")
    except Exception:
        # playback sources have no per-stage timestamps metadata (the
        # reference raises and crashes here; degrading to frame
        # timestamps keeps the CSV useful for recordings)
        print("cwipc_timing: source has no timestamps metadata; "
              "frame timestamps only", file=sys.stderr)
    source.start()
    writer = DropWriter(args)
    # explicit --count wins verbatim; only an OMITTED count defaults to 10
    # (`or` would also coerce --count 0 and cap long recordings)
    count = args.count if args.count is not None else 10
    while not source.eof() and writer.count < count:
        if not source.available(True):
            continue
        pc = source.get()
        if pc is None:
            break
        writer.record_pc(pc)
        pc.free()
    source.stop()
    writer.stop()
    endOfRun(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
