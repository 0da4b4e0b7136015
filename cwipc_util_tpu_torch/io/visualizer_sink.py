"""Viewer sink: the cwipc_window equivalent, software-rendered.

Re-implementation of the C-GUI viewer sink contract
(reference: src/cwipc_window.cpp:74-300): feed(pc, clear) accumulates or
replaces points, caption() sets the title, interact() implements the
blocking keyboard protocol.  Rendering is the numpy splat in io/render.py;
when OpenCV can open a window it is interactive (orbit with a/d/w/s, zoom
with +/-), otherwise it degrades to headless (interact returns the timeout
answer), which is what CI and --nodisplay use.

The port of cwipc_util_tpu/io/visualizer_sink.py.  ``feed`` reads the
cloud to the host once (``get_numpy_array``), as the JAX package does,
and both renderers draw from that host array.  ``renderer`` names the
one that drew the last frame (``"gl"`` or ``"splat"``); the switch to
the splat after a GL failure is logged once, when it happens.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.logging import CWIPC_LOG_LEVEL_WARNING, cwipc_log
from .render import OrbitCamera, render_points


def _try_cv2_gui() -> bool:
    import os

    if not os.environ.get("DISPLAY") and os.name != "nt":
        return False
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False


class cwipc_window_sink:
    """Sink displaying pointclouds in a window (or headless buffer)."""

    def __init__(self, title: str, width: int = 640, height: int = 480):
        self.title = title
        self.width = width
        self.height = height
        self.camera = OrbitCamera()
        self._points_xyz = np.zeros((0, 3), np.float32)
        self._points_rgb = np.zeros((0, 3), np.uint8)
        self._caption = title
        self._gui = _try_cv2_gui()
        self._last_image: Optional[np.ndarray] = None
        self._skeletons: list = []
        self.render_skeleton = True
        self.point_size = 1
        self._mouse_left = False
        self._mouse_right = False
        self.renderer: Optional[str] = None
        if self._gui:
            import cv2

            cv2.namedWindow(self.title)
            cv2.setMouseCallback(self.title, self._on_mouse)

    def _on_mouse(self, event, x, y, flags, param) -> None:
        """cv2 mouse hook -> reference orbit semantics: left-drag rotates,
        right-drag moves the viewpoint up/down, wheel zooms
        (reference: src/cwipc_window.cpp:303-328)."""
        import cv2

        if event == cv2.EVENT_LBUTTONDOWN:
            self._mouse_left = True
            self.camera._mouse_x, self.camera._mouse_y = float(x), float(y)
        elif event == cv2.EVENT_LBUTTONUP:
            self._mouse_left = False
        elif event == cv2.EVENT_RBUTTONDOWN:
            self._mouse_right = True
            self.camera._mouse_x, self.camera._mouse_y = float(x), float(y)
        elif event == cv2.EVENT_RBUTTONUP:
            self._mouse_right = False
        elif event == cv2.EVENT_MOUSEMOVE:
            if self._mouse_left or self._mouse_right:
                self.camera.on_mouse_move(
                    float(x), float(y), self._mouse_left, self._mouse_right
                )
                self._render()
        elif event == cv2.EVENT_MOUSEWHEEL:
            self.camera.on_mouse_scroll(1.0 if flags < 0 else -1.0)
            self._render()

    def free(self, *, force: bool = False) -> None:
        if self._gui:
            import cv2

            try:
                cv2.destroyWindow(self.title)
            except Exception:
                pass

    def feed(self, pc: Optional[cwipc_pointcloud_wrapper], clear: bool) -> bool:
        if pc is not None:
            arr = pc.get_numpy_array()
            xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1)
            rgb = np.stack([arr["r"], arr["g"], arr["b"]], axis=-1)
            if clear:
                self._points_xyz, self._points_rgb = xyz, rgb
                self._skeletons = []
            else:
                self._points_xyz = np.concatenate([self._points_xyz, xyz])
                self._points_rgb = np.concatenate([self._points_rgb, rgb])
            md = pc._metadata
            if md is not None:
                from ..core.pointcloud import parse_skeleton_collection

                for i in range(md.count()):
                    if md.name(i).startswith("skeleton"):
                        try:
                            self._skeletons.append(parse_skeleton_collection(md.data(i)))
                        except Exception:
                            pass
        self._render()
        return True

    def _render(self) -> None:
        # OpenGL path when an EGL context initializes (the reference's
        # viewer is fixed-function GL, src/cwipc_window.cpp:74-134);
        # numpy splat fallback otherwise, identical camera/pinhole
        # contract (parity within half-pixel rounding: tests/test_gl.py)
        from .gl_render import gl_available

        img = None
        if gl_available() and not getattr(self, "_gl_broken", False):
            from .gl_render import render_points_gl

            try:
                img = render_points_gl(
                    self._points_xyz,
                    self._points_rgb,
                    self.width,
                    self.height,
                    self.camera,
                    point_size=self.point_size,
                )
            except Exception as e:
                # a runtime GL failure must not kill the viewer loop:
                # degrade permanently to the splat renderer
                self._gl_broken = True
                cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_window",
                          f"GL rendering failed ({e}); drawing with the numpy splat from now on")
        self.renderer = "splat" if img is None else "gl"
        if img is None:
            img = render_points(
                self._points_xyz,
                self._points_rgb,
                self.width,
                self.height,
                self.camera,
                point_size=self.point_size,
            )
        if self._skeletons and self.render_skeleton:
            from .render import fuse_skeletons, render_skeleton_overlay

            for joints in fuse_skeletons(self._skeletons):
                render_skeleton_overlay(img, joints, self.camera)
        self._last_image = img
        if self._gui:
            import cv2

            cv2.imshow(self.title, img[:, :, ::-1])  # RGB -> BGR
            cv2.waitKey(1)

    def get_image(self) -> Optional[np.ndarray]:
        """The last rendered frame (headless access for tests/snapshots)."""
        return self._last_image

    def caption(self, caption: str) -> None:
        self._caption = caption

    def interact(self, prompt: Optional[str], responses: Optional[str], millis: int) -> str:
        """Blocking keyboard protocol: returns the pressed response char, or
        '\\0' on timeout (matching the reference's contract,
        cwipc_window.cpp:263-300).  Camera keys ([/]/;/' and, when the
        caller has not claimed them, a/d/w/s/+/-) are handled internally
        when the GUI is up; keys in `responses` always win."""
        deadline = time.time() + millis / 1000.0 if millis >= 0 else None
        if prompt:
            print(prompt, flush=True)
        if not self._gui:
            if deadline is not None:
                time.sleep(max(0.0, deadline - time.time()))
            return "\0"
        import cv2

        while True:
            remaining = 50 if deadline is None else int(max(1, (deadline - time.time()) * 1000))
            key = cv2.waitKey(min(50, remaining))
            if key >= 0:
                ch = chr(key & 0xFF)
                # the caller's documented commands take precedence: the
                # visualizer keymap claims a/w/+/- (show-all-tiles, write
                # PLY, point size), which must not be swallowed as camera
                # motion; bracket/semicolon aliases keep full keyboard
                # camera control available regardless
                if responses and ch in responses:
                    return ch
                if ch in ("a", "["):
                    self.camera.azimuth -= 0.1
                elif ch in ("d", "]"):
                    self.camera.azimuth += 0.1
                elif ch in ("w", "'"):
                    self.camera.elevation += 0.1
                elif ch in ("s", ";"):
                    self.camera.elevation -= 0.1
                elif ch in "+=":
                    self.camera.distance *= 0.9
                elif ch == "-":
                    self.camera.distance *= 1.1
                elif not responses:
                    # caller claimed no keys ("press any key to close"):
                    # any non-camera key ends the interaction
                    return ch
                self._render()
            if deadline is not None and time.time() >= deadline:
                return "\0"
