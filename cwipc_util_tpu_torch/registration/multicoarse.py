"""Module-path alias: the reference keeps the multi-camera coarse
aligners in ``cwipc.registration.multicoarse`` (reference:
python/cwipc/registration/multicoarse.py); the port of
cwipc_util_tpu/registration/multicoarse.py implements them in
:mod:`.coarse` (MultiCameraCoarse + Aruco/ArucoRgb/ColorTarget variants on
the software-rendered image path).  Code importing the
reference path keeps working."""

from .coarse import (  # noqa: F401
    MarkerPosition,
    MarkerPositions,
    MultiCameraCoarse,
    MultiCameraCoarseAruco,
    MultiCameraCoarseArucoRgb,
    MultiCameraCoarseColorTarget,
    MultiCameraCoarseColorTargetInteractive,
    fit_rigid,
)
