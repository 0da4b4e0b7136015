"""Capturer base framework: the contract new camera capturers implement.

The port of cwipc_util_tpu/models/capturer_base.py.  The camera contracts
and the colour helpers are host code, copied unchanged
(``greenscreen_mask`` stays the numpy function it is there); the fused
frame of :class:`cwipc_capturer_impl_base` and the result of
``remove_greenscreen`` go to a torch device.

Re-implementation of the reference's header-only capturer framework
(reference: include/cwipc_util/internal/capturers.hpp):

* per-camera configuration with a 4x4 ``trafo`` matrix and JSON
  (de)serialization (capturers.hpp:40-101),
* the camera lifecycle contract — the 4-phase start
  (``pre_start_all_cameras`` / ``start_camera`` /
  ``start_camera_streaming`` / ``post_start_all_cameras``,
  capturers.hpp:170-184), the sync-master flag, seek/eof, and the 2D<->3D
  mapping hook (capturers.hpp:186-194),
* HSV conversion and green-screen removal helpers (capturers.hpp:216-275),
  vectorized here instead of per-pixel loops,
* :class:`cwipc_capturer_impl_base` — the adapter that turns a grabber
  (a class managing N cameras) into a full activesource, implementing
  ``maxtile = nCamera + 1`` and per-camera tileinfo with
  ``cameraMask = 1 << (tile-1)`` (capturers.hpp:452-498).

Hardware plugins subclass :class:`CwipcBaseCamera`/:class:`CwipcBaseCapture`
and register a factory through models/capturer._cwipc_register_capturer.
"""

from __future__ import annotations

import json
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..abstract import cwipc_activesource_abstract
from ..core.buffers import resolve_device
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.logging import CWIPC_LOG_LEVEL_WARNING, cwipc_log


class CwipcBaseCameraConfig:
    """Per-camera configuration: serial, enabled flag, 4x4 trafo."""

    def __init__(self, serial: str = "", camera_type: str = ""):
        self.serial = serial
        self.type = camera_type
        self.disabled = False
        self.filename: Optional[str] = None
        self.trafo = np.identity(4)

    def from_json(self, data: Dict[str, Any]) -> None:
        self.serial = data.get("serial", self.serial)
        self.type = data.get("type", self.type)
        self.disabled = bool(data.get("disabled", False))
        self.filename = data.get("filename")
        if "trafo" in data:
            self.trafo = np.asarray(data["trafo"], np.float64).reshape(4, 4)

    def to_json(self) -> Dict[str, Any]:
        rv: Dict[str, Any] = dict(
            serial=self.serial, type=self.type,
            trafo=[list(map(float, row)) for row in self.trafo],
        )
        if self.disabled:
            rv["disabled"] = True
        if self.filename:
            rv["filename"] = self.filename
        return rv


class CwipcBaseCaptureConfig:
    """Whole-capturer configuration: type + per-camera configs."""

    def __init__(self, capture_type: str = ""):
        self.type = capture_type
        self.cameras: List[CwipcBaseCameraConfig] = []

    def from_json(self, data: Dict[str, Any]) -> None:
        self.type = data.get("type", self.type)
        self.cameras = []
        # both spellings occur in the wild; the capturer factory accepts
        # both, so the config object must too
        for cam_data in data.get("camera", data.get("cameras", [])):
            cam = CwipcBaseCameraConfig(camera_type=self.type)
            cam.from_json(cam_data)
            self.cameras.append(cam)

    def to_json(self) -> Dict[str, Any]:
        return dict(
            version=5, type=self.type, camera=[c.to_json() for c in self.cameras]
        )


# ---------------------------------------------------------------------------
# Color helpers (capturers.hpp:216-275), vectorized
# ---------------------------------------------------------------------------


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB -> [..., 3] float HSV (h in degrees, s/v in 0..1)."""
    rgbf = rgb.astype(np.float64) / 255.0
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    maxc = rgbf.max(axis=-1)
    minc = rgbf.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        h = np.where(
            delta == 0,
            0.0,
            np.where(
                maxc == r,
                60.0 * (((g - b) / np.maximum(delta, 1e-12)) % 6),
                np.where(
                    maxc == g,
                    60.0 * ((b - r) / np.maximum(delta, 1e-12) + 2),
                    60.0 * ((r - g) / np.maximum(delta, 1e-12) + 4),
                ),
            ),
        )
    return np.stack([h, s, v], axis=-1)


def greenscreen_mask(
    rgb: np.ndarray,
    hue_center: float = 120.0,
    hue_tolerance: float = 40.0,
    min_saturation: float = 0.3,
    min_value: float = 0.15,
) -> np.ndarray:
    """True for pixels/points that look like a green screen."""
    hsv = rgb_to_hsv(rgb)
    hue_dist = np.abs(((hsv[..., 0] - hue_center) + 180.0) % 360.0 - 180.0)
    return (
        (hue_dist <= hue_tolerance)
        & (hsv[..., 1] >= min_saturation)
        & (hsv[..., 2] >= min_value)
    )


def remove_greenscreen(pc: cwipc_pointcloud_wrapper, **kwargs) -> cwipc_pointcloud_wrapper:
    """Drop green-screen points from a cloud: one read of the cloud, and
    the result on the input's device."""
    from .. import cwipc_from_numpy_array

    arr = pc.get_numpy_array()
    rgb = np.stack([arr["r"], arr["g"], arr["b"]], axis=-1)
    keep = ~greenscreen_mask(rgb, **kwargs)
    rv = cwipc_from_numpy_array(arr[keep], pc.timestamp(), device=pc._device)
    rv._set_cellsize(pc.cellsize())
    return rv


# ---------------------------------------------------------------------------
# Camera / capture contracts
# ---------------------------------------------------------------------------


class CwipcBaseCamera(ABC):
    """One physical camera: the 4-phase start contract + mapping hooks."""

    def __init__(self, config: CwipcBaseCameraConfig):
        self.config = config
        self.is_sync_master = False
        self.started = False

    # 4-phase start (capturers.hpp:170-184): all cameras complete each phase
    # before any camera enters the next (hardware-sync requirement).
    def pre_start_all_cameras(self) -> None: ...

    @abstractmethod
    def start_camera(self) -> bool: ...

    @abstractmethod
    def start_camera_streaming(self) -> bool: ...

    def post_start_all_cameras(self) -> None: ...

    @abstractmethod
    def stop_camera(self) -> None: ...

    @abstractmethod
    def capture_pointcloud(self) -> Optional[np.ndarray]:
        """One frame as a structured POINT_DTYPE array in camera coordinates."""
        ...

    def seek(self, timestamp: int) -> bool:
        return False

    def eof(self) -> bool:
        return False

    def map_2d_to_3d(self, u: float, v: float, depth: float) -> Optional[Tuple[float, float, float]]:
        """Deproject an image pixel to camera-space 3D (capturers.hpp:186-194)."""
        return None


class CwipcBaseCapture(ABC):
    """A grabber managing N cameras (capturers.hpp:281-360 contract)."""

    def __init__(self, config: CwipcBaseCaptureConfig):
        self.config = config
        self.cameras: List[CwipcBaseCamera] = []
        self.recording_to: Optional[str] = None

    @abstractmethod
    def create_cameras(self) -> None:
        """Populate self.cameras from self.config."""
        ...

    def start(self) -> bool:
        if not self.cameras:
            self.create_cameras()
        active = [c for c in self.cameras if not c.config.disabled]
        if not active:
            return False
        if len(active) > 8:
            # the tile byte is an 8-bit camera mask (1 << index): more
            # cameras cannot be represented — fail fast instead of
            # overflowing in get()
            raise CwipcError(
                f"at most 8 active cameras supported (8-bit tile mask), got {len(active)}"
            )
        # elect a sync master (first camera, capturers.hpp:341-344)
        active[0].is_sync_master = True
        # mark each camera started as soon as its start_camera phase ran:
        # a mid-phase failure must leave the already-started cameras
        # stoppable (stop() only stops cameras with started=True), not
        # leak their hardware streams until process exit
        for phase in ("pre_start_all_cameras", "start_camera", "start_camera_streaming", "post_start_all_cameras"):
            for cam in active:
                rv = getattr(cam, phase)()
                if phase == "start_camera" and rv is not False:
                    cam.started = True
                if rv is False:
                    self.stop()
                    return False
        return True

    def stop(self) -> None:
        for cam in self.cameras:
            if cam.started:
                cam.stop_camera()
                cam.started = False

    def start_recording(self, dirname: str) -> None:
        self.recording_to = dirname

    def stop_recording(self) -> None:
        self.recording_to = None


class cwipc_capturer_impl_base(cwipc_activesource_abstract):
    """Adapter: a CwipcBaseCapture grabber becomes a full activesource.

    Implements maxtile = nCamera + 1 and per-camera tileinfo with
    cameraMask = 1 << (tile - 1) (capturers.hpp:452-498); each camera's
    points get its tile bit and its config trafo applied, and the per-frame
    result is the fused cloud, on ``device`` (``None`` means CUDA).
    """

    def __init__(self, grabber: CwipcBaseCapture, device=None):
        self.grabber = grabber
        self._device = resolve_device(device)
        if not grabber.cameras:
            grabber.create_cameras()
        self._started = False
        self._requested_metadata: set = set()
        self._lock = threading.Lock()

    def free(self, *, force: bool = False) -> None:
        self.stop()

    def start(self) -> bool:
        self._started = self.grabber.start()
        return self._started

    def stop(self) -> None:
        if self._started:
            self.grabber.stop()
            self._started = False

    def eof(self) -> bool:
        cams = [c for c in self.grabber.cameras if not c.config.disabled]
        return bool(cams) and all(c.eof() for c in cams)

    def available(self, wait: bool = False) -> bool:
        return self._started and not self.eof()

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        if not self._started:
            cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_capturer", "get() before start()")
            return None
        from .. import cwipc_from_numpy_array
        from ..core.buffers import POINT_DTYPE

        import time as _time

        with self._lock:
            parts: List[np.ndarray] = []
            for i, cam in enumerate(self.grabber.cameras):
                if cam.config.disabled or not cam.started:
                    continue
                arr = cam.capture_pointcloud()
                if arr is None or arr.shape[0] == 0:
                    continue
                arr = arr.astype(POINT_DTYPE, copy=True)
                arr["tile"] = 1 << i
                t = cam.config.trafo
                xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1)
                xyz = xyz @ t[:3, :3].T + t[:3, 3]
                arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
                parts.append(arr)
            if not parts:
                return None
            merged = np.concatenate(parts)
        return cwipc_from_numpy_array(merged, int(_time.time() * 1000), device=self._device)

    def seek(self, timestamp: int) -> bool:
        return all(c.seek(timestamp) for c in self.grabber.cameras if not c.config.disabled)

    # -- tiling contract (capturers.hpp:452-498) ---------------------------

    def maxtile(self) -> int:
        return len(self.grabber.cameras) + 1

    def get_tileinfo_dict(self, tilenum: int) -> Dict[str, Any]:
        ncam = len(self.grabber.cameras)
        if tilenum == 0:
            return {
                "normal": {"x": 0, "y": 0, "z": 0},
                "cameraName": b"all",
                "ncamera": ncam,
                "cameraMask": 0,
            }
        if 1 <= tilenum <= ncam:
            cam = self.grabber.cameras[tilenum - 1]
            return {
                "normal": {"x": 0, "y": 0, "z": 0},
                "cameraName": cam.config.serial.encode("utf8"),
                "ncamera": 1,
                "cameraMask": 1 << (tilenum - 1),
            }
        raise CwipcError(f"cwipc_capturer: no tileinfo for tile {tilenum}")

    # -- config / metadata ----------------------------------------------------

    def reload_config(self, config) -> bool:
        if config is None:
            return False
        data = json.loads(config) if isinstance(config, (str, bytes)) else config
        self.grabber.config.from_json(data)
        if self.grabber.cameras and len(self.grabber.cameras) != len(
            self.grabber.config.cameras
        ):
            # a zip() here would silently drop the extra camera configs (or
            # leave extra camera objects on stale configs)
            return False
        for cam, cam_cfg in zip(self.grabber.cameras, self.grabber.config.cameras):
            cam.config = cam_cfg
        return True

    def get_config(self) -> bytes:
        return json.dumps(self.grabber.config.to_json()).encode("utf8")

    def request_metadata(self, name: str) -> None:
        self._requested_metadata.add(name)

    def is_metadata_requested(self, name: str) -> bool:
        return name in self._requested_metadata

    def auxiliary_operation(self, op: str, inbuf: bytes, outbuf: bytearray) -> bool:
        return False

    def statistics(self) -> None:
        pass
