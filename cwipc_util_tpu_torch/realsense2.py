"""Module-path alias for the reference's `cwipc.realsense2` (reference:
python/cwipc/realsense2.py — `from _cwipc_realsense2 import *`).

The hardware capturer is an external plugin repo; in the reference,
importing this module fails with ImportError when the plugin is not
installed.  Same contract here, in the port of
cwipc_util_tpu/realsense2.py: the plugin registers a "realsense2"
capturer through cwipc_util_tpu_torch.models.capturer._cwipc_register_capturer,
and this module re-exports its factory once registered."""

from .models.capturer import cwipc_capturer_registry

if "realsense2" not in cwipc_capturer_registry():
    raise ImportError(
        "cwipc_realsense2 plugin not installed (no 'realsense2' capturer registered)"
    )


def cwipc_realsense2(configFilename=None, device=None):
    from .models.capturer import cwipc_capturer_of_type

    return cwipc_capturer_of_type("realsense2", configFilename, device)
