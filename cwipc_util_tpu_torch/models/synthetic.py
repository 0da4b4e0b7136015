"""Deterministic synthetic point-cloud source.

The port of cwipc_util_tpu/models/synthetic.py: a rotating parametric body
on a hsteps x asteps grid with animated colors and blinking "eyes"
(reference: src/cwipc_synthetic.cpp:19-242).  ``_generate`` builds it on
the device with torch; ``_generate_host`` is the numpy twin, copied from
the JAX package unchanged, so both packages can be fed the same cloud.

Behavioral parity: 160,000 points by default, cellsize = 2.0 / hsteps,
tile 1 for z < 0 and 2 otherwise, maxtile() == 3, fps gating, and the
"test-angle" / "test-setangle" hooks.
"""

from __future__ import annotations

import math
import struct
import time
from typing import Optional, Set

import numpy as np
import torch

from ..abstract import cwipc_activesource_abstract
from ..core.buffers import POINT_DTYPE, PointBuffer, bucket_capacity, pack_rgba, resolve_device
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.logging import CWIPC_LOG_LEVEL_ERROR, CWIPC_LOG_LEVEL_WARNING, cwipc_log

_PI = math.pi


def _generate(hsteps: int, asteps: int, capacity: int, angle: float, device) -> PointBuffer:
    """Generate the parametric body at animation angle ``angle`` (seconds)
    on ``device``, padded to ``capacity``."""
    dev = torch.device(device)
    f32 = torch.float32
    # height-major grid, matching the reference's loop nest order
    # (cwipc_synthetic.cpp:190-221): height index outer, angle index inner.
    hi = torch.arange(hsteps, dtype=f32, device=dev)[:, None].expand(hsteps, asteps)
    ai = torch.arange(asteps, dtype=f32, device=dev)[None, :].expand(hsteps, asteps)
    height = hi * (2.0 / hsteps)
    a = ai * (2.0 * _PI / asteps)
    ang = float(np.float32(angle))

    radius = 0.3 * torch.pow(torch.cos(height * _PI / 3 - _PI / 6), 0.71)
    x = radius * torch.sin(a)
    y = radius * torch.cos(a)

    def chan(k):
        v = (1 + torch.sin(k * _PI * height + ang + a)) / 2
        return (v * 255.0).to(torch.int32)

    rr, gg, bb = chan(2), chan(3), chan(4)
    eye_band = (height > 1.7) & (height < 1.8)
    eye_arc = ((a > _PI * 0.083) & (a < _PI * 0.1667)) | (
        (a > _PI * 1.833) & (a < _PI * 1.917)
    )
    blink_open = bool(np.mod(np.float32(angle), np.float32(_PI / 2)) > 0.08)
    eyes = eye_band & eye_arc & blink_open
    rr = torch.where(eyes, 255, rr)
    gg = torch.where(eyes, 255, gg)
    bb = torch.where(eyes, 255, bb)
    tile = torch.where(y < 0, 1, 2).to(torch.int32)

    n = hsteps * asteps
    xyz = torch.zeros((capacity, 3), dtype=f32, device=dev)
    xyz[:n] = torch.stack([-x, height, y], dim=-1).reshape(n, 3)
    rgba = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    rgba[:n] = pack_rgba(rr, gg, bb, tile).reshape(n)
    return PointBuffer(xyz=xyz, rgba=rgba, count=torch.tensor(n, dtype=torch.int32, device=dev))


def _generate_host(hsteps: int, asteps: int, angle: float):
    """numpy twin of _generate returning POINT_DTYPE records directly
    (same formulas; trig values differ from the device's in final ulps,
    which the synthetic contract — a deterministic parametric body —
    permits; separable terms are computed per-axis and broadcast)."""
    angle = np.float32(angle)
    h = (np.arange(hsteps, dtype=np.float32) * np.float32(2.0 / hsteps))[:, None]
    a = (np.arange(asteps, dtype=np.float32) * np.float32(2.0 * _PI / asteps))[None, :]
    radius = np.float32(0.3) * np.power(
        np.cos(h * np.float32(_PI / 3) - np.float32(_PI / 6)), np.float32(0.71)
    )
    sin_a, cos_a = np.sin(a), np.cos(a)
    x = radius * sin_a  # [hsteps, asteps] via broadcast
    y = radius * cos_a

    def chan(k):
        v = (1.0 + np.sin(np.float32(k * _PI) * h + angle + a)) * np.float32(0.5)
        return (v * np.float32(255.0)).astype(np.int32)

    rr, gg, bb = chan(2), chan(3), chan(4)
    eye_band = ((h > 1.7) & (h < 1.8)).astype(bool)
    eye_arc = ((a > _PI * 0.083) & (a < _PI * 0.1667)) | (
        (a > _PI * 1.833) & (a < _PI * 1.917)
    )
    blink_open = math.fmod(angle, _PI / 2) > 0.08
    eyes = eye_band & eye_arc & blink_open
    n = hsteps * asteps
    pts = np.empty(n, POINT_DTYPE)
    pts["x"] = (-x).ravel()
    pts["y"] = np.broadcast_to(h, (hsteps, asteps)).ravel()
    pts["z"] = y.ravel()
    pts["r"] = np.where(eyes, 255, rr).ravel()
    pts["g"] = np.where(eyes, 255, gg).ravel()
    pts["b"] = np.where(eyes, 255, bb).ravel()
    pts["tile"] = np.where(y < 0, 1, 2).ravel()
    return pts


_SYNTHETIC_TILEINFO = [
    {"normal": {"x": 0, "y": 0, "z": 0}, "cameraName": b"synthetic", "ncamera": 2, "cameraMask": 0},
    {"normal": {"x": 0, "y": 0, "z": 1}, "cameraName": b"synthetic-right", "ncamera": 1, "cameraMask": 1},
    {"normal": {"x": 0, "y": 0, "z": -1}, "cameraName": b"synthetic-left", "ncamera": 1, "cameraMask": 2},
]


class cwipc_source_synthetic(cwipc_activesource_abstract):
    """Active source producing the synthetic body at an optional fps cap.

    Clouds are generated on ``device`` (default CUDA); on the CPU the numpy
    twin builds a host-backed cloud, as the JAX package does on its CPU
    backend."""

    def __init__(self, fps: int = 0, npoints: int = 0, device=None):
        if npoints == 0:
            npoints = 160000
        self._device = resolve_device(device)
        self._hsteps = self._asteps = int(math.sqrt(npoints))
        self._capacity = bucket_capacity(self._hsteps * self._asteps)
        self._fps = fps
        self._angle = 0.0
        self._started = False
        self._start_time: Optional[float] = None
        self._earliest_next: Optional[float] = None
        self._requested_metadata: Set[str] = set()

    # -- source protocol ---------------------------------------------------

    def free(self, *, force: bool = False) -> None:
        pass

    def start(self) -> bool:
        if self._started:
            cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_synthetic", "start() called when already started")
            return True
        self._start_time = time.time()
        self._earliest_next = self._start_time
        self._started = True
        return True

    def stop(self) -> None:
        self._started = False

    def eof(self) -> bool:
        return False

    def seek(self, timestamp: int) -> bool:
        return False

    def available(self, wait: bool) -> bool:
        if not self._started:
            cwipc_log(CWIPC_LOG_LEVEL_ERROR, "cwipc_synthetic", "available() called before start()")
            return False
        if (
            not wait
            and self._fps != 0
            and self._earliest_next is not None
            and time.time() < self._earliest_next
        ):
            return False
        return True

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        if not self._started:
            cwipc_log(CWIPC_LOG_LEVEL_ERROR, "cwipc_synthetic", "get() called before start()")
            return None
        if self._fps != 0 and self._earliest_next is not None:
            delay = self._earliest_next - time.time()
            if delay > 0:
                time.sleep(delay)
        now = time.time()
        timestamp = int(now * 1000)
        assert self._start_time is not None
        if self._fps != 0:
            # absolute deadline ladder, like the reference's sleep_until
            # (src/cwipc_synthetic.cpp:110-128); a consumer that stalls more
            # than one period resynchronizes instead of bursting
            base = self._earliest_next if self._earliest_next is not None else now
            nxt = base + 1.0 / self._fps
            if nxt < now:
                nxt = now + 1.0 / self._fps
            self._earliest_next = nxt
        self._angle = now - self._start_time
        cellsize = 2.0 / self._hsteps
        if self._device.type == "cpu":
            pts = _generate_host(self._hsteps, self._asteps, self._angle)
            pc = cwipc_pointcloud_wrapper(
                None, timestamp, cellsize, _host_points=pts, device=self._device
            )
        else:
            buf = _generate(self._hsteps, self._asteps, self._capacity, self._angle, self._device)
            pc = cwipc_pointcloud_wrapper(
                buf, timestamp, cellsize, _count_hint=self._hsteps * self._asteps
            )
        if "test-angle" in self._requested_metadata:
            pc.access_metadata()._add("test-angle", "", struct.pack("<f", self._angle))
        return pc

    # -- tiling contract ----------------------------------------------------

    def maxtile(self) -> int:
        return 3

    def get_tileinfo_dict(self, tilenum: int) -> dict:
        if 0 <= tilenum < 3:
            info = _SYNTHETIC_TILEINFO[tilenum]
            return {k: (dict(v) if isinstance(v, dict) else v) for k, v in info.items()}
        raise CwipcError(f"cwipc_synthetic: no tileinfo for tile {tilenum}")

    # -- config / metadata / aux ops -----------------------------------------

    def reload_config(self, config) -> bool:
        cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_synthetic", "reload_config() not implemented (nor needed)")
        return False

    def get_config(self) -> bytes:
        raise CwipcError("cwipc_synthetic: no config available")

    def request_metadata(self, name: str) -> None:
        self._requested_metadata.add(name)

    def is_metadata_requested(self, name: str) -> bool:
        return name in self._requested_metadata

    def auxiliary_operation(self, op: str, inbuf: bytes, outbuf: bytearray) -> bool:
        if op != "test-setangle":
            return False
        if inbuf is None or len(inbuf) != 4:
            return False
        if outbuf is None or len(outbuf) != 4:
            return False
        (self._angle,) = struct.unpack("<f", inbuf)
        outbuf[:] = struct.pack("<f", self._angle)
        return True

    def statistics(self) -> None:
        pass


def cwipc_synthetic(fps: int = 0, npoints: int = 0, device=None) -> cwipc_source_synthetic:
    """Create a synthetic pointcloud source on ``device`` (default CUDA)."""
    return cwipc_source_synthetic(fps, npoints, device=device)
