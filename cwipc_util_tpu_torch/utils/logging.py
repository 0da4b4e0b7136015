"""Logging / observability subsystem.

TPU-native re-design of the reference logging subsystem
(reference: src/logging.cpp:48-138, include/cwipc_util/internal/logging.hpp:7-22):

* global log level (default WARNING),
* optional user callback ``callback(level:int, message:bytes)``,
* ``CWIPC_LOGGING=LEVEL[:filename]`` environment variable,
* messages formatted ``t=<secs>: module: Level: message``,
* an "errorbuf" capture used by factory functions: the first ERROR emitted
  during a captured region is remembered so the caller can raise
  :class:`~cwipc_util_tpu_torch.core.errors.CwipcError` with that message.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional, TextIO

CWIPC_LOG_LEVEL_NONE = 0
CWIPC_LOG_LEVEL_ERROR = 1
CWIPC_LOG_LEVEL_WARNING = 2
CWIPC_LOG_LEVEL_TRACE = 3
CWIPC_LOG_LEVEL_DEBUG = 4

_LEVEL_NAMES = {
    CWIPC_LOG_LEVEL_NONE: "None",
    CWIPC_LOG_LEVEL_ERROR: "Error",
    CWIPC_LOG_LEVEL_WARNING: "Warning",
    CWIPC_LOG_LEVEL_TRACE: "Trace",
    CWIPC_LOG_LEVEL_DEBUG: "Debug",
}

_NAME_LEVELS = {v.upper(): k for k, v in _LEVEL_NAMES.items()}

cwipc_log_callback_type = Callable[[int, bytes], None]

_start_time = time.time()

_lock = threading.Lock()
_level: int = CWIPC_LOG_LEVEL_WARNING
_callback: Optional[cwipc_log_callback_type] = None
_logfile: Optional[TextIO] = None
_env_inited = False

# Per-thread capture of the first ERROR message emitted inside a
# `capture_errors` region (analog of the reference's currentErrorBuf,
# src/logging.cpp:113-116 — but thread-local rather than a global, fixing
# the documented thread-unsafety).
_capture = threading.local()


def _init_from_env() -> None:
    global _env_inited, _level, _logfile
    if _env_inited:
        return
    _env_inited = True
    spec = os.environ.get("CWIPC_LOGGING")
    if not spec:
        return
    if ":" in spec:
        levelname, filename = spec.split(":", 1)
    else:
        levelname, filename = spec, None
    lvl = _NAME_LEVELS.get(levelname.upper())
    if lvl is not None:
        _level = lvl
    if filename:
        try:
            _logfile = open(filename, "a")
        except OSError:
            _logfile = None


def cwipc_log_configure(level: int, callback: Optional[cwipc_log_callback_type] = None) -> None:
    """Set the global log level and optional log callback."""
    global _level, _callback, _env_inited
    with _lock:
        _env_inited = True  # explicit configuration overrides the env var
        _level = level
        _callback = callback


def cwipc_log_default_callback(level: int, message: bytes) -> None:
    sys.stderr.write(message.decode("utf8", "replace") + "\n")


def _format(level: int, module: str, message: str) -> str:
    t = time.time() - _start_time
    name = _LEVEL_NAMES.get(level, str(level))
    return f"t={t:.3f}: {module}: {name}: {message}"


def _cwipc_log_emit(level: int, module: str, message: str) -> None:
    """Emit a log record, honoring level, callback, file and error capture."""
    _init_from_env()
    if level == CWIPC_LOG_LEVEL_ERROR:
        buf = getattr(_capture, "errors", None)
        if buf is not None and not buf:
            buf.append(f"{module}: {message}")
    if level > _level:
        return
    text = _format(level, module, message)
    cb = _callback
    if cb is not None:
        cb(level, text.encode("utf8"))
    elif _logfile is not None:
        _logfile.write(text + "\n")
        _logfile.flush()
    else:
        sys.stderr.write(text + "\n")


def cwipc_log(level: int, module: str, message: str) -> None:
    _cwipc_log_emit(level, module, message)


class capture_errors:
    """Context manager: capture the first ERROR log emitted in this thread.

    Mirrors the factory error-return channel of the reference
    (src/logging.cpp:131-138): inside the region, the first ERROR message is
    remembered; :meth:`raise_if_error` converts it to a CwipcError.
    """

    def __enter__(self) -> "capture_errors":
        self._prev = getattr(_capture, "errors", None)
        _capture.errors = []
        return self

    def __exit__(self, *exc) -> None:
        self._captured = list(_capture.errors)
        _capture.errors = self._prev

    @property
    def error(self) -> Optional[str]:
        # after __exit__ the captured list is authoritative even when EMPTY:
        # falling through to the (restored) enclosing region's buffer would
        # report the OUTER region's error as this region's
        captured = getattr(self, "_captured", None)
        lst = captured if captured is not None else getattr(_capture, "errors", None)
        return lst[0] if lst else None

    def raise_if_error(self) -> None:
        """Promote a captured ERROR to a CwipcError (the factory
        error-return contract the class docstring describes)."""
        from ..core.errors import CwipcError

        msg = self.error
        if msg is not None:
            raise CwipcError(msg)
