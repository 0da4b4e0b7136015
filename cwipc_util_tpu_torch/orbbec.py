"""Module-path alias for the reference's `cwipc.orbbec` (reference:
python/cwipc/orbbec.py — `from _cwipc_orbbec import *`).

The hardware capturer is an external plugin repo; in the reference,
importing this module fails with ImportError when the plugin is not
installed.  Same contract here, in the port of
cwipc_util_tpu/orbbec.py: the plugin registers a "orbbec"
capturer through cwipc_util_tpu_torch.models.capturer._cwipc_register_capturer,
and this module re-exports its factory once registered."""

from .models.capturer import cwipc_capturer_registry

if "orbbec" not in cwipc_capturer_registry():
    raise ImportError(
        "cwipc_orbbec plugin not installed (no 'orbbec' capturer registered)"
    )


def cwipc_orbbec(configFilename=None, device=None):
    from .models.capturer import cwipc_capturer_of_type

    return cwipc_capturer_of_type("orbbec", configFilename, device)
