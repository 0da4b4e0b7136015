"""cameraconfig model: the JSON camera-calibration state.

The port of cwipc_util_tpu/registration/cameraconfig.py, host code copied
unchanged: the JSON a package writes is read unchanged by the other.

Re-implementation of the reference's cameraconfig module
(reference: python/cwipc/registration/cameraconfig.py:12-161): a
dirty-tracked 4x4 Transform per camera, JSON load/save with a "~" backup of
the previous file, serial -> tilemask mapping, and dotted-path overrides
("camera.0.trafo=..." style, set_entry_from_string).

The JSON schema matches the reference capturers' expectations
(include/cwipc_util/internal/capturers.hpp:40-120): top-level "type",
"version": 5, and a "camera" array with per-camera "serial", "type",
optional "disabled"/"filename", and a 4x4 "trafo".
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.errors import CwipcError

CAMERACONFIG_VERSION = 5

# A 4x4 trafo as JSON carries it: a list of 4 lists of 4 floats
# (reference: cameraconfig.py:10).
PythonTrafo = List[List[float]]


class Transform:
    """A 4x4 matrix with a dirty flag for change tracking."""

    def __init__(self, matrix: Optional[Any] = None):
        self._matrix = (
            np.identity(4) if matrix is None else np.asarray(matrix, np.float64).reshape(4, 4)
        )
        self._dirty = False

    def get_matrix(self) -> np.ndarray:
        return self._matrix.copy()

    def set_matrix(self, matrix: Any) -> None:
        m = np.asarray(matrix, np.float64).reshape(4, 4)
        if not np.array_equal(m, self._matrix):
            self._matrix = m
            self._dirty = True

    def get(self) -> PythonTrafo:
        """The matrix in its JSON form (reference: cameraconfig.py:28-29)."""
        return self.to_json()

    def apply_matrix(self, matrix: Any) -> None:
        """Left-multiply an adjustment onto the current matrix
        (reference: cameraconfig.py:45-48)."""
        m = np.asarray(matrix, np.float64).reshape(4, 4)
        self.set_matrix(m @ self._matrix)

    def reset(self) -> None:
        self.set_matrix(np.identity(4))

    def is_dirty(self) -> bool:
        return self._dirty

    def clean(self) -> None:
        self._dirty = False

    def is_identity(self) -> bool:
        return bool(np.allclose(self._matrix, np.identity(4)))

    def to_json(self) -> List[List[float]]:
        return [list(map(float, row)) for row in self._matrix]


class CameraConfig:
    """Editable view of a cameraconfig.json file."""

    def __init__(self, filename: str):
        self.filename = filename
        self._data: Dict[str, Any] = dict(version=CAMERACONFIG_VERSION, type="", camera=[])
        self.transforms: List[Transform] = []
        self._loaded = False

    # -- load/save -------------------------------------------------------------

    def load(self, jsondata: Optional[bytes] = None) -> bool:
        """Load from the file, or from explicit JSON data (e.g. a capturer's
        get_config())."""
        if jsondata is not None:
            self._data = json.loads(jsondata)
        else:
            if not os.path.exists(self.filename):
                raise CwipcError(f"cameraconfig: no such file: {self.filename}")
            with open(self.filename) as fp:
                self._data = json.load(fp)
        self._refresh_transforms()
        self._loaded = True
        return True

    def is_loaded(self) -> bool:
        return self._loaded

    def load_from_file(self) -> None:
        """Load from self.filename (reference: cameraconfig.py:117-119)."""
        self.load()

    def save(self) -> None:
        """Write the file, keeping the previous version as filename~."""
        self.refresh_transforms()
        if os.path.exists(self.filename):
            backup = self.filename + "~"
            if os.path.exists(backup):
                os.unlink(backup)
            os.replace(self.filename, backup)
        with open(self.filename, "w") as fp:
            json.dump(self._data, fp, indent=4)
        for t in self.transforms:
            t.clean()

    def save_to(self, filename: str) -> None:
        self.filename = filename
        self.save()

    def get_json_data(self) -> bytes:
        self.refresh_transforms()
        return json.dumps(self._data).encode("utf8")

    def get(self) -> bytes:
        """The config as JSON bytes (reference: cameraconfig.py:139-140)."""
        return self.get_json_data()

    def refresh_transforms(self) -> None:
        """Copy the live Transform matrices back into the JSON camera
        entries (reference: cameraconfig.py:86-90)."""
        for i, t in enumerate(self.transforms):
            if i < len(self._data.get("camera", [])):
                self._data["camera"][i]["trafo"] = t.to_json()

    def init_transforms(self) -> None:
        """(Re)build the Transform list from the JSON camera entries
        (reference: cameraconfig.py:64-70)."""
        self._refresh_transforms()

    def _refresh_transforms(self) -> None:
        # preserve dirtiness: rebuilding from _data must not make unsaved
        # transform edits look saved (is_dirty gates save())
        was_dirty = [t.is_dirty() for t in getattr(self, "transforms", [])]
        cameras = self._data.setdefault("camera", [])
        self.transforms = [Transform(cam.get("trafo")) for cam in cameras]
        for t, dirty in zip(self.transforms, was_dirty):
            if dirty:
                t._dirty = True

    # -- accessors -------------------------------------------------------------

    def camera_count(self) -> int:
        return len(self._data.get("camera", []))

    def get_type(self) -> str:
        return self._data.get("type", "")

    def get_serial_dict(self) -> Dict[str, int]:
        """serial -> tilemask (camera i gets mask 1<<i,
        reference: cameraconfig.py:98-109)."""
        rv: Dict[str, int] = {}
        for i, cam in enumerate(self._data.get("camera", [])):
            serial = cam.get("serial", str(i))
            rv[serial] = 1 << i
        return rv

    def get_transform(self, cam_index: int) -> Transform:
        return self.transforms[cam_index]

    def set_transform(self, cam_index: int, matrix: Any) -> None:
        self.transforms[cam_index].set_matrix(matrix)

    def is_dirty(self) -> bool:
        return any(t.is_dirty() for t in self.transforms)

    def all_identity(self) -> bool:
        return all(t.is_identity() for t in self.transforms)

    def is_identity(self) -> bool:
        """Reference-parity name (reference: cameraconfig.py:92-96)."""
        return self.all_identity()

    def get_entry(self, path: str) -> Any:
        # sync live transforms first: _data only sees them at save time, so
        # a read-after-write of camera.N.trafo would return stale matrices
        self.refresh_transforms()
        node: Any = self._data
        for part in path.split("."):
            if isinstance(node, list):
                node = node[int(part)]
            else:
                node = node[part]
        return node

    def set_entry_from_string(self, assignment: str) -> None:
        """Apply a dotted-path override like "camera.0.serial=abc"
        (reference: cameraconfig.py:149-161)."""
        if "=" not in assignment:
            raise CwipcError(f"cameraconfig: expected key=value: {assignment}")
        # sync live (possibly unsaved) transforms into _data first, so the
        # trailing refresh does not revert them to the last-saved matrices
        self.refresh_transforms()
        path, value = assignment.split("=", 1)
        try:
            parsed: Any = json.loads(value)
        except json.JSONDecodeError:
            parsed = value
        parts = path.split(".")
        node: Any = self._data
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
            else:
                node = node.setdefault(part, {})
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = parsed
        else:
            node[last] = parsed
        self._refresh_transforms()


def default_cameraconfig(cam_type: str, serials: List[str]) -> Dict[str, Any]:
    """A fresh cameraconfig structure with identity transforms."""
    return dict(
        version=CAMERACONFIG_VERSION,
        type=cam_type,
        camera=[
            dict(serial=s, type=cam_type, trafo=Transform().to_json()) for s in serials
        ],
    )
