"""Async visualizer: thread-safe viewer wrapper with interaction loop.

Re-implementation of the reference's Visualizer
(reference: python/cwipc/io/visualizer.py:15-435): an input queue decouples
the producer (SourceServer) from the display loop; the full reference
keymap (io/visualizer.py:20-43) is implemented, plus mouse orbit in the
window sink (src/cwipc_window.cpp:303-328) and the RGB auxiliary-image
window (--rgb / --rgb_full / --rgb_cw).

The port of cwipc_util_tpu/io/visualizer.py.  A displayed frame keeps
the JAX package's work: ``ColorizeFilter`` when colorize is on (the
port's filter reads the cloud, colors it on the host and puts it back on
the cloud's device), the tile select (``cwipc_tilefilter``, kernel 3 on
a CUDA cloud), then the window sink's one host read and its render; the
stats' ``count()`` reads the count that read cached.  The display thread
frees clouds that the source thread made: ``free`` only drops the
wrapper's references, and the default stream that made a cloud's tensors
(one stream for every thread) orders their reuse after the work queued
on them.
"""

from __future__ import annotations

import os
import queue
import subprocess
import sys
import time
from typing import Optional

from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..io.ply import CWIPC_FLAGS_BINARY, write_ply
from ..ops import cwipc_tilefilter
from ..utils.stats import Stats

HELP = """
space         Pause/resume
.             Single step (for recordings)
<             Rewind (for recordings)
mouse_left    Rotate viewpoint
mouse_scroll  Zoom in/out
mouse_right   Up/down viewpoint
+/-           Increase/decrease point size
0-9           Select single tile to view ( 0=All )
n             Select next tile to view
a             Show all tiles
m             Toggle tile selection mask mode
i             Toggle tile selection index mode
f             Colorize points to show contributing cameras
r             Toggle skeleton rendering
w             Write PLY file
t             Timelapse: like w but after a 5 second delay
p             Timelapse pause: pause after 5 seconds
z             Next tile quality selection (if available)
c             Reload cameraconfig
e             Edit cameraconfig
?,h           Help
q,ESC         Quit
"""

_RESPONSES = "?h\x1bq .<+-cefwtpamirnz0123456789"


class Visualizer:
    HELP = HELP

    def __init__(self, verbose: bool = False, nodisplay: bool = False, title: str = "cwipc_view", args=None):
        self.verbose = verbose
        self.nodisplay = nodisplay
        self.title = title
        self.args = args
        self.input_queue: "queue.Queue[Optional[cwipc_pointcloud_wrapper]]" = queue.Queue(maxsize=2)
        self.producer = None
        self.source = None
        self.stopped = False
        self.paused = False
        self.single_step = False
        self.tilefilter: Optional[int] = None  # 0/None = all
        self.filter_mode = "mask"  # reference default: digits select masks
        self.colorize = False
        self.point_size_power = 0
        self.timelapse_write_at = 0.0
        self.timelapse_beep_at = 0.0
        self.timelapse_pause_at = 0.0
        self.stats = Stats("visualizer")
        self.window = None
        self.display_count = 0
        self.alive = True
        self.current_pc: Optional[cwipc_pointcloud_wrapper] = None
        if not nodisplay:
            self.start_window()

    def start(self) -> None:
        """No-op lifecycle hook (reference: io/visualizer.py:101-102)."""

    def is_alive(self) -> bool:
        """False once the run loop has ended (reference: io/visualizer.py:113-114)."""
        return self.alive

    def start_window(self) -> None:
        """Create the display window (reference: io/visualizer.py:207-212)."""
        if self.window is None:
            from .visualizer_sink import cwipc_window_sink

            self.window = cwipc_window_sink(self.title)

    def set_producer(self, producer) -> None:
        self.producer = producer

    def set_source(self, source) -> None:
        self.source = source

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        try:
            self.input_queue.put(pc, timeout=0.5)
        except queue.Full:
            pc.free()

    def stop(self) -> None:
        self.stopped = True

    def _get_next_pc(self) -> Optional[cwipc_pointcloud_wrapper]:
        try:
            return self.input_queue.get(timeout=0.2)
        except queue.Empty:
            return None

    def _prepare_display_pc(self, pc: cwipc_pointcloud_wrapper) -> cwipc_pointcloud_wrapper:
        display = pc
        if self.colorize:
            from ..filters.colorize import ColorizeFilter

            f = ColorizeFilter(0.8, "camera")
            f.set_keep_source()
            display = f.filter(display)
        if self.tilefilter:
            selected = cwipc_tilefilter(display, self.tilefilter)
            if display is not pc:
                display.free()
            display = selected
        return display

    def run(self) -> None:
        while not self.stopped:
            if self.producer is not None and not self.producer.is_alive() and self.input_queue.empty():
                break
            if self.paused and not self.single_step:
                self._interact_once(50)
                continue
            pc = self._get_next_pc()
            if pc is None:
                self._interact_once(1)
                continue
            if self.single_step:
                # show exactly one frame, then hold (reference: io/visualizer.py:175-178)
                self.paused = True
                self.single_step = False
            t0 = time.time()
            if self.current_pc is not None:
                self.current_pc.free()
            self.current_pc = pc
            if self.args is not None and getattr(self.args, "timestamps", False):
                self._show_timestamps(pc, "timestamps")
            display = self._prepare_display_pc(pc)
            if self.window is not None:
                if self.args is not None and getattr(self.args, "rgb", False):
                    self._draw_rgb(pc)
                self.window.feed(display, clear=True)
                self._interact_once(1)
            self.display_count += 1
            self.stats.add("display_pointcount", display.count(), isInt=True)
            self.stats.add("display_duration", time.time() - t0)
            if display is not pc:
                display.free()
        if self.current_pc is not None:
            self.current_pc.free()
            self.current_pc = None
        if self.window is not None:
            self.window.free()
        self.alive = False

    def _show_timestamps(self, pc, label: str) -> None:
        """Per-cloud timestamp printout (reference: io/visualizer.py:214-223)."""
        print(f"{label}: ts={pc.timestamp()}")
        md = pc._metadata
        if md is not None:
            for i in range(md.count()):
                name = md.name(i)
                if "timestamps" in name:
                    print(f"{label}:    {name}: {md.description(i)}")

    # -- interaction ------------------------------------------------------

    def interact_visualiser(self) -> None:
        """One user-interaction slice with the display window
        (reference: io/visualizer.py:245-252)."""
        self._interact_once(50)

    def draw_rgb(self, pc: cwipc_pointcloud_wrapper) -> None:
        """Show the cloud's RGB aux images (reference: io/visualizer.py:355)."""
        self._draw_rgb(pc)

    def _interact_once(self, millis: int) -> None:
        if self.window is None:
            time.sleep(millis / 1000.0)
            self._handle_timelapse()
            return
        ch = self.window.interact(None, _RESPONSES, millis)
        self._handle_timelapse()
        self.handle_command(ch)

    def _handle_timelapse(self) -> None:
        now = time.time()
        if self.timelapse_write_at > 0:
            if now >= self.timelapse_write_at:
                print("timelapse: capture point cloud.\x07", file=sys.stderr)
                self.timelapse_write_at = 0
                self.timelapse_beep_at = 0
                self.write_current_pointcloud()
            elif now >= self.timelapse_beep_at:
                print(f"timelapse: {int(self.timelapse_write_at - now)}\x07", file=sys.stderr)
                self.timelapse_beep_at += 1
        if self.timelapse_pause_at > 0 and now >= self.timelapse_pause_at:
            print("timelapse: pause", file=sys.stderr)
            self.paused = True
            self.timelapse_pause_at = 0

    def handle_command(self, ch: str) -> None:
        """Dispatch one key of the reference keymap
        (reference: python/cwipc/io/visualizer.py:245-347)."""
        if ch == "\0" or ch == "":
            return
        if ch in ("q", "\x1b"):
            self.stopped = True
        elif ch in ("?", "h"):
            print(HELP, flush=True)
        elif ch == " ":
            self.paused = not self.paused
        elif ch == ".":
            self.single_step = True
            self.paused = False
        elif ch == "<":
            if self.source is None or not getattr(self.source, "seek", lambda t: False)(0):
                print("Input source does not support seek")
            self.paused = False
        elif ch == "a":
            self.select_tile(all=True)
        elif ch == "m":
            self.select_mode("mask")
        elif ch == "i":
            self.select_mode("index")
        elif ch == "n":
            self.select_tile(increment=True)
        elif ch == "r":
            if self.window is not None:
                self.window.render_skeleton = not self.window.render_skeleton
        elif ch.isdigit():
            self.select_tile(number=int(ch))
        elif ch == "+":
            self.point_size_power += 1
            self._apply_point_size()
        elif ch == "-":
            if self.point_size_power > 0:
                self.point_size_power -= 1
                self._apply_point_size()
        elif ch == "w":
            self.write_current_pointcloud()
        elif ch == "t":
            now = time.time()
            self.timelapse_beep_at = now + 1
            self.timelapse_write_at = now + 5
            self.paused = False
            print("timelapse: capture in 5 seconds", file=sys.stderr)
        elif ch == "p":
            self.timelapse_pause_at = time.time() + 5
            self.paused = False
            print("timelapse: pause in 5 seconds", file=sys.stderr)
        elif ch == "c":
            self.paused = False
            print("reload: reloading cameraconfig...", file=sys.stderr)
            self.reload_cameraconfig()
        elif ch == "e":
            self.edit_cameraconfig()
        elif ch == "f":
            self.colorize = not self.colorize
        elif ch == "z":
            if self.source is not None and hasattr(self.source, "select_next_tile_quality"):
                selection = self.source.select_next_tile_quality()
                print(f"Selected tile quality: {selection}")
            else:
                print("Input source does not support select_next_tile_quality")
        else:
            print(f"Unknown command {ch!r}")
            print(HELP, flush=True)

    # -- command implementations ------------------------------------------

    def select_mode(self, newmode: str) -> None:
        self.filter_mode = newmode
        print(f"tilefilter mask mode: {newmode}. Showing all tiles", flush=True)
        self.select_tile(all=True)

    def select_tile(self, *, number: Optional[int] = None, all: bool = False, increment: bool = False) -> None:
        if all:
            self.tilefilter = None
            print("Showing all tiles", flush=True)
        elif increment:
            self.tilefilter = 1 if not self.tilefilter else self.tilefilter + 1
            print(f"Showing tile number {self.tilefilter} mask 0x{self.tilefilter:x}", flush=True)
        else:
            assert number is not None
            if number == 0:
                self.tilefilter = None
                print("Showing all tiles", flush=True)
            else:
                self.tilefilter = (1 << (number - 1)) if self.filter_mode == "mask" else number
                print(f"Showing tile number {self.tilefilter} mask 0x{self.tilefilter:x}", flush=True)

    def _apply_point_size(self) -> None:
        if self.window is not None and hasattr(self.window, "camera"):
            # software splat: point size maps to splat radius power
            self.window.point_size = 1 + self.point_size_power

    def write_current_pointcloud(self) -> None:
        if self.current_pc is None:
            return
        filename = f"pointcloud_{self.current_pc.timestamp()}.ply"
        write_ply(filename, self.current_pc, CWIPC_FLAGS_BINARY)
        print(f"Saved as {filename} in {os.getcwd()}")

    def reload_cameraconfig(self) -> None:
        if self.source is None or not hasattr(self.source, "reload_config"):
            print("reload_cameraconfig: source does not support reload_config")
            return
        try:
            conf = getattr(self.args, "cameraconfig", None) if self.args else None
            ok = self.source.reload_config(conf)
            if not ok:
                print("reload_cameraconfig: failed to reload cameraconfig")
        except Exception as e:  # noqa: BLE001 - interactive path, report all
            print(f"reload_cameraconfig: Exception: {e}")

    def edit_cameraconfig(self) -> None:
        editor = os.environ.get("EDITOR", "vi")
        conf = (getattr(self.args, "cameraconfig", None) if self.args else None) or "cameraconfig.json"
        print(f"edit_cameraconfig: run: {editor} {conf}")
        try:
            subprocess.run([editor, conf])
        except OSError as e:
            print(f"edit_cameraconfig: {e}")
        print("edit_cameraconfig: use 'c' to reload cameraconfig when done")

    def _draw_rgb(self, pc: cwipc_pointcloud_wrapper) -> None:
        """RGB auxiliary-image window: one combined window, or one window
        per camera with --rgb_full (reference: io/visualizer.py:354-387)."""
        md = pc._metadata
        if md is None:
            return
        try:
            import cv2
        except ImportError:
            return
        images = md.get_all_images("rgb.")
        if not images:
            return
        if self.args is not None and getattr(self.args, "rgb_full", False):
            for name, image in images.items():
                cv2.imshow(name, image)
            cv2.waitKey(1)
            return
        all_images = list(images.values())
        rgb_cw = self.args is not None and getattr(self.args, "rgb_cw", False)
        rgb_ccw = self.args is not None and getattr(self.args, "rgb_ccw", False)
        if rgb_cw or rgb_ccw:
            # the flags' documented behavior: rotate each camera image 90
            # degrees first (for rotated camera mounts), then concatenate
            # horizontally.  (The reference's help text promises the
            # rotation but its draw_rgb only switches to hconcat,
            # reference io/visualizer.py:373-375 — we do what the flag says.)
            rot = cv2.ROTATE_90_CLOCKWISE if rgb_cw else cv2.ROTATE_90_COUNTERCLOCKWISE
            all_images = [cv2.rotate(im, rot) for im in all_images]
            full = cv2.hconcat(all_images)
        else:
            full = cv2.vconcat(all_images)
        h, w = full.shape[:2]
        scale = min(1024 / h, 1024 / w)
        if scale < 1:
            full = cv2.resize(full, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_LINEAR)
        cv2.imshow("RGB", full)
        cv2.waitKey(1)

    def statistics(self) -> None:
        self.stats.print()
