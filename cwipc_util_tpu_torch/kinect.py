"""Module-path alias for the reference's `cwipc.kinect` (reference:
python/cwipc/kinect.py — `from _cwipc_kinect import *`).

The hardware capturer is an external plugin repo; in the reference,
importing this module fails with ImportError when the plugin is not
installed.  Same contract here, in the port of
cwipc_util_tpu/kinect.py: the plugin registers a "kinect"
capturer through cwipc_util_tpu_torch.models.capturer._cwipc_register_capturer,
and this module re-exports its factory once registered."""

from .models.capturer import cwipc_capturer_registry

if "kinect" not in cwipc_capturer_registry():
    raise ImportError(
        "cwipc_kinect plugin not installed (no 'kinect' capturer registered)"
    )


def cwipc_kinect(configFilename=None, device=None):
    from .models.capturer import cwipc_capturer_of_type

    return cwipc_capturer_of_type("kinect", configFilename, device)
