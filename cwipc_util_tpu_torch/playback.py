"""Module-path alias: the reference exposes playback at cwipc.playback
(python/cwipc/playback.py); the implementation lives in models/playback
(the port of cwipc_util_tpu/playback.py)."""

from .models.playback import (  # noqa: F401
    _CompressedFilesource,
    _DumpFilesource,
    _Filesource,
    cwipc_playback,
)
