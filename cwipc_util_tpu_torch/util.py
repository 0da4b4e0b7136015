"""The native cwipc_util library: build it and load it through ctypes.

The port's own copy of the JAX package's ``util.py`` loader
(``cwipc_util_dll_load``; reference: python/cwipc/util.py:368-400).  The
library is the backend-neutral C ABI of ``cwipc_util_tpu/native/`` (the
sources are shared, not copied); the port needs it for ``as_cwipc_p`` and
for the codec's native host stages.

    make -C cwipc_util_tpu/native BUILD=<dir> <dir>/libcwipc_util_tpu.so

* The library lands in ``_build/native/`` beside this file (git-ignored),
  never in ``cwipc_util_tpu/native/build/``.
* Each build runs in a directory of its own and the finished library is
  renamed into place, so two processes building at once never load a
  half-written file.
* A missing ``make`` or a failed build raises :class:`CwipcError`.

``build_fake_signals`` builds the fake SIGNALS libraries of the DASH
pair's tests the same way, into the same directory.

It also holds the ctypes structs of a tile's info that
``get_tileinfo_raw`` builds (``cwipc_vector``, ``cwipc_tileinfo``;
reference: python/cwipc/util.py:296-355), copied from the JAX package's
``util.py``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

from .core.errors import CwipcError

NATIVE_SRC = Path(__file__).resolve().parent.parent / "cwipc_util_tpu" / "native"
NATIVE_BUILD = Path(__file__).resolve().parent / "_build" / "native"
LIBNAME = "libcwipc_util_tpu.so"
FAKE_SIGNALS = ("liblldash_packager.so", "liblldash_play.so")

_lock = threading.Lock()
_dll: Optional[ctypes.CDLL] = None


def _build(what: str, names) -> Path:
    """Build the named files of ``cwipc_util_tpu/native/`` into
    ``_build/native/`` unless they are all there; returns that directory."""
    outs = [NATIVE_BUILD / name for name in names]
    if all(out.exists() for out in outs):
        return NATIVE_BUILD
    make = shutil.which("make")
    if make is None:
        raise CwipcError(f"cannot build {what}: make is not on PATH")
    if not (NATIVE_SRC / "Makefile").exists():
        raise CwipcError(f"cannot build {what}: no sources in {NATIVE_SRC}")
    NATIVE_BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=NATIVE_BUILD))
    try:
        rv = subprocess.run([make, "-C", str(NATIVE_SRC), f"BUILD={tmp}", *(str(tmp / name) for name in names)],
                            capture_output=True, text=True)
        if rv.returncode != 0 or not all((tmp / name).exists() for name in names):
            raise CwipcError(f"building {what} failed: {rv.stderr[-400:]}")
        for name in names:
            os.replace(tmp / name, NATIVE_BUILD / name)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return NATIVE_BUILD


def build_native() -> Path:
    """Build the native library into ``_build/native/`` unless it is there."""
    return _build("the native cwipc_util library", [LIBNAME]) / LIBNAME


def build_fake_signals() -> Path:
    """Build the fake SIGNALS libraries (``fake_signals.c``, the Makefile's
    ``fakesignals`` target: a file-system loopback with the real SMD ABI,
    the test double of the DASH pair) into ``_build/native/`` unless they
    are there; returns that directory, to name in ``SIGNALS_SMD_PATH``."""
    return _build("the fake SIGNALS libraries", FAKE_SIGNALS)


def cwipc_util_dll_load(libname: Optional[str] = None) -> ctypes.CDLL:
    """The ctypes handle of the native library, built on first use; with
    ``libname``, that library instead (loaded anew, not cached)."""
    global _dll
    if libname is not None:
        return ctypes.CDLL(libname)
    with _lock:
        if _dll is None:
            _dll = ctypes.CDLL(str(build_native()))
    return _dll


class cwipc_vector(ctypes.Structure):
    """A vector (reference util.py:296-318 / api.h cwipc_vector)."""

    _fields_ = [
        ("x", ctypes.c_double),
        ("y", ctypes.c_double),
        ("z", ctypes.c_double),
    ]

    def __eq__(self, other) -> bool:
        if not isinstance(other, cwipc_vector):
            return False
        return all(getattr(self, f) == getattr(other, f) for f in ("x", "y", "z"))

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)


class cwipc_tileinfo(ctypes.Structure):
    """Direction/camera info of a pointcloud tile (api.h:150-155)."""

    _fields_ = [
        ("normal", cwipc_vector),
        ("cameraName", ctypes.c_char_p),
        ("ncamera", ctypes.c_uint8),
        ("cameraMask", ctypes.c_uint8),
    ]

