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

_lock = threading.Lock()
_dll: Optional[ctypes.CDLL] = None


def build_native() -> Path:
    """Build the native library into ``_build/native/`` unless it is there."""
    out = NATIVE_BUILD / LIBNAME
    if out.exists():
        return out
    make = shutil.which("make")
    if make is None:
        raise CwipcError("cannot build the native cwipc_util library: make is not on PATH")
    if not (NATIVE_SRC / "Makefile").exists():
        raise CwipcError(f"cannot build the native cwipc_util library: no sources in {NATIVE_SRC}")
    NATIVE_BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=NATIVE_BUILD))
    try:
        rv = subprocess.run([make, "-C", str(NATIVE_SRC), f"BUILD={tmp}", str(tmp / LIBNAME)],
                            capture_output=True, text=True)
        if rv.returncode != 0 or not (tmp / LIBNAME).exists():
            raise CwipcError(f"building the native cwipc_util library failed: {rv.stderr[-400:]}")
        os.replace(tmp / LIBNAME, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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
