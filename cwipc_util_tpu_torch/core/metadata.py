"""Per-cloud metadata (auxiliary data) collection.

Python-native equivalent of the reference's cwipc_metadata collection
(reference: src/cwipc_util.cpp:24-87, include/cwipc_util/api.h:508-562):
an ordered list of (name, description, bytes) items attached to a point
cloud, e.g. per-camera RGB/depth images, timestamps, or test hooks like
"test-angle".  Image items carry a description string of
"k=v,k=v,..." pairs; `get_image_description` parses it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class cwipc_metadata:
    """Ordered collection of named binary metadata items."""

    def __init__(self) -> None:
        self._items: List[Tuple[str, str, bytes]] = []

    def _add(self, name: str, description: str, data: bytes) -> None:
        self._items.append((name, description, bytes(data)))

    def count(self) -> int:
        return len(self._items)

    def name(self, idx: int) -> str:
        return self._items[idx][0]

    def description(self, idx: int) -> str:
        return self._items[idx][1]

    def size(self, idx: int) -> int:
        return len(self._items[idx][2])

    def data(self, idx: int) -> bytes:
        return self._items[idx][2]

    def pointer(self, idx: int):
        """ctypes pointer to item idx's bytes (reference: util.py metadata
        .pointer, backed by cwipc_metadata_pointer).  The buffer it points
        into is pinned on this collection, so the pointer stays valid for
        the collection's lifetime."""
        import ctypes

        data = self._items[idx][2]
        if not hasattr(self, "_pinned"):
            self._pinned: Dict[int, Any] = {}
        buf = self._pinned.get(idx)
        if buf is None:
            buf = ctypes.create_string_buffer(data, len(data))
            self._pinned[idx] = buf
        return ctypes.cast(buf, ctypes.c_void_p)

    def as_cwipc_metadata_p(self):
        """ctypes-compatible handle (reference: util.py as_cwipc_metadata_p).
        Metadata collections in this framework are Python-native; only a
        collection obtained from a native-backed object carries a handle."""
        handle = getattr(self, "_native_handle", None)
        if handle:
            return handle
        from .errors import CwipcError

        raise CwipcError(
            "cwipc_metadata: this collection is Python-native and has no C"
            " handle; use data()/pointer() to pass its items to native code"
        )

    def _copy_from(self, other: "cwipc_metadata") -> None:
        self._items.extend(other._items)

    # -- image helpers (reference: python/cwipc/util.py:993-1082) ---------

    def _parse_aux_description(self, description: str) -> Dict[str, Any]:
        rv: Dict[str, Any] = {}
        for part in description.split(","):
            if not part or "=" not in part:
                continue
            k, v = part.split("=", 1)
            try:
                rv[k] = int(v)
            except ValueError:
                rv[k] = v
        return rv

    def get_image_description(self, idx: int) -> Dict[str, Any]:
        """Parsed description with the reference's format normalization
        (util.py:1005-1033): bpp-only descriptions imply a format
        (2=Z16, 3=RGB8, 4=RGBA), numeric ``format`` codes map to names
        (2=RGB8, 3=BGRA, 4=Z16), string formats pass through."""
        desc = self._parse_aux_description(self.description(idx))
        if "bpp" in desc:
            bpp = desc["bpp"]
            if bpp == 2:
                desc["image_format"] = "Z16"
            elif bpp == 3:
                desc["image_format"] = "RGB8"
            elif bpp == 4:
                desc["image_format"] = "RGBA8"
        if "format" in desc:
            image_format = desc["format"]
            if image_format == 2:
                desc["bpp"] = 3
                desc["image_format"] = "RGB8"
            elif image_format == 3:
                desc["bpp"] = 4
                desc["image_format"] = "BGRA8"
            elif image_format == 4:
                desc["bpp"] = 2
                desc["image_format"] = "Z16"
            else:
                desc["image_format"] = image_format
        return desc

    def get_image(self, idx: int) -> np.ndarray:
        """Decode an image item (Z16 depth, RGB8/BGR8, RGBA8/BGRA8) to numpy."""
        desc = self.get_image_description(idx)
        width = int(desc["width"])
        height = int(desc["height"])
        stride = int(desc.get("stride", 0))
        fmt = desc.get("image_format", desc.get("format", ""))
        data = self.data(idx)
        if fmt in ("Z16", "L16"):
            arr = np.frombuffer(data, np.uint16)
            bytes_per_pixel = 2
        elif fmt in ("RGB8", "BGR8"):
            arr = np.frombuffer(data, np.uint8)
            bytes_per_pixel = 3
        elif fmt in ("RGBA8", "BGRA8", "RGBA32", "BGRA32"):
            arr = np.frombuffer(data, np.uint8)
            bytes_per_pixel = 4
        elif fmt == "L8":
            arr = np.frombuffer(data, np.uint8)
            bytes_per_pixel = 1
        else:
            raise ValueError(f"Unknown image format {fmt!r}")
        if not stride:
            stride = width * bytes_per_pixel
        row_elems = stride // arr.itemsize
        arr = arr[: height * row_elems].reshape(height, row_elems)
        if bytes_per_pixel in (3, 4) and arr.itemsize == 1:
            ncol = width * bytes_per_pixel
            arr = arr[:, :ncol].reshape(height, width, bytes_per_pixel)
        else:
            arr = arr[:, :width]
        return arr

    def get_all_images(self, pattern: str = "") -> Dict[str, np.ndarray]:
        rv: Dict[str, np.ndarray] = {}
        for i in range(self.count()):
            nm = self.name(i)
            if pattern in nm:
                try:
                    rv[nm] = self.get_image(i)
                except (ValueError, KeyError):
                    continue
        return rv
