"""Hardware-OpenGL point renderer on a headless EGL context.

The reference's viewer window is GLFW + fixed-function OpenGL vertex
arrays (reference: src/cwipc_window.cpp:74-134 for the window/event
loop, src/window_util.cpp:61-149 for the draw path).  A TPU host is
headless, so the GL path here binds Mesa's surfaceless EGL platform via
ctypes (no GLFW, no X server, no dev headers needed — the stable EGL/GL
ABI is declared inline), renders GL_POINTS into an offscreen FBO with
the same fixed-function vertex-array draw calls the reference makes,
and reads the frame back for the cv2 display loop (io/visualizer*).
On a machine with a GPU the identical code hardware-accelerates; under
Mesa llvmpipe it still exercises the genuine GL pipeline.

Callers probe :func:`gl_available` once and keep the numpy splat
renderer (io/render.py) when EGL is absent; `CWIPC_GL=0` forces the
fallback.  The renderer reproduces :func:`io.render.render_points`'s
contract: same OrbitCamera, same pinhole geometry (vertical FOV), image
returned as [H, W, 3] uint8 with row 0 at the top.

The port of cwipc_util_tpu/io/gl_render.py, copied unchanged.  The GL
path renders a host array (the viewer reads the cloud once a frame, as
the JAX package does); it binds Mesa's surfaceless platform only.  Where
the host's EGL vendor does not offer that platform (an NVIDIA driver's
EGL may not), ``gl_available`` is False and the viewer draws with the
numpy splat: the JAX package's contract, not a device fallback.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import numpy as np

from .render import OrbitCamera

# ---- EGL / GL constants (Khronos-registry values; headers absent) ----
_EGL_PLATFORM_SURFACELESS_MESA = 0x31DD
_EGL_OPENGL_API = 0x30A2
_EGL_RENDERABLE_TYPE = 0x3040
_EGL_OPENGL_BIT = 0x0008
_EGL_SURFACE_TYPE = 0x3033
_EGL_NONE = 0x3038

_GL_COLOR_BUFFER_BIT = 0x4000
_GL_DEPTH_BUFFER_BIT = 0x0100
_GL_DEPTH_TEST = 0x0B71
_GL_PROJECTION = 0x1701
_GL_MODELVIEW = 0x1700
_GL_VERTEX_ARRAY = 0x8074
_GL_COLOR_ARRAY = 0x8076
_GL_FLOAT = 0x1406
_GL_UNSIGNED_BYTE = 0x1401
_GL_POINTS = 0x0000
_GL_RGB = 0x1907
_GL_PACK_ALIGNMENT = 0x0D05
_GL_FRAMEBUFFER = 0x8D40
_GL_RENDERBUFFER = 0x8D41
_GL_COLOR_ATTACHMENT0 = 0x8CE0
_GL_DEPTH_ATTACHMENT = 0x8D00
_GL_RGB8 = 0x8051
_GL_DEPTH_COMPONENT24 = 0x81A6
_GL_FRAMEBUFFER_COMPLETE = 0x8CD5

_state: Optional["_EGLState"] = None
_probe_failed = False


class _EGLState:
    """One process-wide surfaceless EGL context (current on the thread
    that created it; the visualizer render loop is single-threaded)."""

    def __init__(self) -> None:
        self.egl = ctypes.CDLL("libEGL.so.1")
        self.gl = ctypes.CDLL("libGL.so.1")
        egl = self.egl
        egl.eglGetProcAddress.restype = ctypes.c_void_p
        egl.eglGetProcAddress.argtypes = [ctypes.c_char_p]
        proc = egl.eglGetProcAddress(b"eglGetPlatformDisplayEXT")
        if not proc:
            raise RuntimeError("eglGetPlatformDisplayEXT unavailable")
        get_platform_display = ctypes.CFUNCTYPE(
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p
        )(proc)
        dpy = get_platform_display(_EGL_PLATFORM_SURFACELESS_MESA, None, None)
        if not dpy:
            raise RuntimeError("no surfaceless EGL display")
        self.dpy = ctypes.c_void_p(dpy)
        major, minor = ctypes.c_int(), ctypes.c_int()
        if not egl.eglInitialize(self.dpy, ctypes.byref(major), ctypes.byref(minor)):
            raise RuntimeError("eglInitialize failed")
        if not egl.eglBindAPI(_EGL_OPENGL_API):
            raise RuntimeError("eglBindAPI(OpenGL) failed")
        cfg_attribs = (ctypes.c_int * 5)(
            _EGL_RENDERABLE_TYPE, _EGL_OPENGL_BIT, _EGL_SURFACE_TYPE, 0, _EGL_NONE
        )
        cfg = ctypes.c_void_p()
        ncfg = ctypes.c_int()
        if not egl.eglChooseConfig(
            self.dpy, cfg_attribs, ctypes.byref(cfg), 1, ctypes.byref(ncfg)
        ) or ncfg.value < 1:
            raise RuntimeError("eglChooseConfig found nothing")
        egl.eglCreateContext.restype = ctypes.c_void_p
        ctx = egl.eglCreateContext(self.dpy, cfg, ctypes.c_void_p(0), None)
        if not ctx:
            raise RuntimeError("eglCreateContext failed")
        self.ctx = ctypes.c_void_p(ctx)
        # surfaceless: no EGL surface, rendering goes to an FBO
        if not egl.eglMakeCurrent(
            self.dpy, ctypes.c_void_p(0), ctypes.c_void_p(0), self.ctx
        ):
            raise RuntimeError("eglMakeCurrent failed")
        self._declare_gl()
        self.fbo_size: Tuple[int, int] = (0, 0)
        self.fbo = ctypes.c_uint(0)
        self.rbo_color = ctypes.c_uint(0)
        self.rbo_depth = ctypes.c_uint(0)
        # contexts are thread-affine: leaving it current on the PROBING
        # thread would make the first make_current on the render thread
        # fail with EGL_BAD_ACCESS (and silently degrade to the splat)
        self.release_current()

    def make_current(self) -> None:
        """Contexts are thread-affine; render_points_gl binds on entry
        and releases on exit (release_current), so render loops may
        migrate threads between frames — a context still current on
        another thread would make this bind fail with EGL_BAD_ACCESS."""
        if not self.egl.eglMakeCurrent(
            self.dpy, ctypes.c_void_p(0), ctypes.c_void_p(0), self.ctx
        ):
            raise RuntimeError("eglMakeCurrent failed")

    def release_current(self) -> None:
        self.egl.eglMakeCurrent(
            self.dpy, ctypes.c_void_p(0), ctypes.c_void_p(0), ctypes.c_void_p(0)
        )

    def _declare_gl(self) -> None:
        gl = self.gl
        gl.glGetString.restype = ctypes.c_char_p
        gl.glLoadMatrixf.argtypes = [ctypes.POINTER(ctypes.c_float)]
        gl.glVertexPointer.argtypes = [
            ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
        ]
        gl.glColorPointer.argtypes = [
            ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
        ]
        gl.glClearColor.argtypes = [ctypes.c_float] * 4
        gl.glPointSize.argtypes = [ctypes.c_float]
        gl.glReadPixels.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
        ]

    def ensure_fbo(self, width: int, height: int) -> None:
        if self.fbo_size == (width, height):
            return
        gl = self.gl
        if self.fbo.value:
            gl.glDeleteFramebuffers(1, ctypes.byref(self.fbo))
            gl.glDeleteRenderbuffers(1, ctypes.byref(self.rbo_color))
            gl.glDeleteRenderbuffers(1, ctypes.byref(self.rbo_depth))
        gl.glGenFramebuffers(1, ctypes.byref(self.fbo))
        gl.glBindFramebuffer(_GL_FRAMEBUFFER, self.fbo)
        gl.glGenRenderbuffers(1, ctypes.byref(self.rbo_color))
        gl.glBindRenderbuffer(_GL_RENDERBUFFER, self.rbo_color)
        gl.glRenderbufferStorage(_GL_RENDERBUFFER, _GL_RGB8, width, height)
        gl.glFramebufferRenderbuffer(
            _GL_FRAMEBUFFER, _GL_COLOR_ATTACHMENT0, _GL_RENDERBUFFER, self.rbo_color
        )
        gl.glGenRenderbuffers(1, ctypes.byref(self.rbo_depth))
        gl.glBindRenderbuffer(_GL_RENDERBUFFER, self.rbo_depth)
        gl.glRenderbufferStorage(_GL_RENDERBUFFER, _GL_DEPTH_COMPONENT24, width, height)
        gl.glFramebufferRenderbuffer(
            _GL_FRAMEBUFFER, _GL_DEPTH_ATTACHMENT, _GL_RENDERBUFFER, self.rbo_depth
        )
        status = gl.glCheckFramebufferStatus(_GL_FRAMEBUFFER)
        if status != _GL_FRAMEBUFFER_COMPLETE:
            raise RuntimeError(f"FBO incomplete: {status:#x}")
        self.fbo_size = (width, height)


def gl_available() -> bool:
    """Probe (once) whether the EGL/GL render path can initialize."""
    global _state, _probe_failed
    if _state is not None:
        return True
    if _probe_failed or os.environ.get("CWIPC_GL", "1") == "0":
        return False
    try:
        _state = _EGLState()
        return True
    except Exception:
        _probe_failed = True
        return False


def _perspective(fov_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def render_points_gl(
    xyz: np.ndarray,
    rgb: np.ndarray,
    width: int = 640,
    height: int = 480,
    camera: Optional[OrbitCamera] = None,
    point_size: int = 1,
    background: Tuple[int, int, int] = (0, 0, 0),
) -> np.ndarray:
    """GL twin of io.render.render_points (same camera/pinhole contract).

    Requires gl_available(); raises RuntimeError otherwise."""
    if not gl_available():
        raise RuntimeError("EGL/GL render path unavailable")
    assert _state is not None
    if camera is None:
        camera = OrbitCamera()
    st = _state
    gl = st.gl
    st.make_current()
    try:
        return _render_bound(st, gl, xyz, rgb, width, height, camera,
                             point_size, background)
    finally:
        st.release_current()


def _render_bound(st, gl, xyz, rgb, width, height, camera, point_size,
                  background) -> np.ndarray:
    st.ensure_fbo(width, height)
    gl.glBindFramebuffer(_GL_FRAMEBUFFER, st.fbo)
    gl.glViewport(0, 0, width, height)
    gl.glClearColor(background[0] / 255.0, background[1] / 255.0, background[2] / 255.0, 1.0)
    gl.glEnable(_GL_DEPTH_TEST)
    gl.glClear(_GL_COLOR_BUFFER_BIT | _GL_DEPTH_BUFFER_BIT)

    proj = _perspective(camera.fov_deg, width / height, 0.01, 100.0)
    view = camera.view_matrix().astype(np.float32)
    # glLoadMatrixf is column-major: upload the transpose
    proj_cm = np.ascontiguousarray(proj.T)
    view_cm = np.ascontiguousarray(view.T)
    gl.glMatrixMode(_GL_PROJECTION)
    gl.glLoadMatrixf(proj_cm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    gl.glMatrixMode(_GL_MODELVIEW)
    gl.glLoadMatrixf(view_cm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    n = int(xyz.shape[0])
    if n:
        # the reference's draw path: client vertex/color arrays + GL_POINTS
        # (window_util.cpp:61-149)
        v = np.ascontiguousarray(xyz, np.float32)
        c = np.ascontiguousarray(rgb, np.uint8)
        gl.glEnableClientState(_GL_VERTEX_ARRAY)
        gl.glEnableClientState(_GL_COLOR_ARRAY)
        gl.glVertexPointer(3, _GL_FLOAT, 0, v.ctypes.data_as(ctypes.c_void_p))
        gl.glColorPointer(3, _GL_UNSIGNED_BYTE, 0, c.ctypes.data_as(ctypes.c_void_p))
        gl.glPointSize(float(max(1, point_size)))
        gl.glDrawArrays(_GL_POINTS, 0, n)
        gl.glDisableClientState(_GL_COLOR_ARRAY)
        gl.glDisableClientState(_GL_VERTEX_ARRAY)
    gl.glFinish()

    out = np.empty((height, width, 3), np.uint8)
    gl.glPixelStorei(_GL_PACK_ALIGNMENT, 1)
    gl.glReadPixels(
        0, 0, width, height, _GL_RGB, _GL_UNSIGNED_BYTE,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    # GL's origin is bottom-left; the splat renderer's row 0 is the top
    return out[::-1].copy()
