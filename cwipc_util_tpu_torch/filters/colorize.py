"""colorize filter (reference: python/cwipc/filters/colorize.py:8-50).

The port of cwipc_util_tpu/filters/colorize.py: tile-number -> colour
tables with a blend weight, as a 256-entry table lookup over the tile
column on the host; the result goes back to the input's device.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .abstract import BaseFilter

ColorTuple = Tuple[float, float, float]


class ColorMap:
    def __init__(self, initializer: Optional[Dict[int, ColorTuple]] = None):
        self._map: List[Optional[ColorTuple]] = [None] * 256
        if initializer:
            for k, v in initializer.items():
                self._map[k] = v

    def add_mapping(self, tilenum: int, color: ColorTuple) -> None:
        self._map[tilenum] = color

    def map(self, tilenum: int) -> Optional[ColorTuple]:
        return self._map[tilenum]

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(table [256, 3] float, defined mask [256] bool) for vectorized use."""
        lut = np.zeros((256, 3), np.float32)
        defined = np.zeros(256, bool)
        for i, c in enumerate(self._map):
            if c is not None:
                lut[i] = c
                defined[i] = True
        return lut, defined


# one distinct colour per single-camera tile bit
_colorMapTiles = ColorMap(
    {
        1: (1, 0, 0),
        2: (0, 1, 0),
        4: (0, 0, 1),
        8: (0.5, 0.5, 0),
        16: (0, 0.5, 0.5),
        32: (0.5, 0, 0.5),
        64: (0.2, 0.2, 0.2),
        128: (0.7, 0.7, 0.7),
    }
)

# colour by number of contributing cameras (bit count of the tile mask)
_colorForBitCount: List[ColorTuple] = [
    (0.2, 0.2, 0.2),
    (1, 1, 1),
    (1, 0, 0),
    (0, 1, 0),
    (0, 0, 1),
    (0.5, 0.5, 0),
    (0, 0.5, 0.5),
    (0.5, 0, 0.5),
    (0, 0, 0),
]

_colorMapContributingCameras = ColorMap(
    {i: _colorForBitCount[bin(i).count("1")] for i in range(256)}
)

_namedColorMaps = dict(
    camera=_colorMapTiles,
    contributions=_colorMapContributingCameras,
)


class ColorizeFilter(BaseFilter):
    """
    colorize - Change point colors based on the tile number or mask.
        Arguments:
            weight: 1.0 replaces the original color entirely, 0.0 changes nothing
            colormap: a 3-float tuple for a uniform color, a colorize.ColorMap,
                      or the name of one:
                      camera: each tile number gets a different color
                      contributions: color by number of bits set in the tile mask
    """

    filtername = "colorize"

    def __init__(self, weight: float, colormap: Any):
        super().__init__()
        if isinstance(colormap, str) and colormap in _namedColorMaps:
            self.colorMap = _namedColorMaps[colormap]
        elif isinstance(colormap, tuple):
            self.colorMap = ColorMap({i: colormap for i in range(256)})
        elif isinstance(colormap, ColorMap):
            self.colorMap = colormap
        else:
            self.colorMap = ColorMap(colormap)
        self.weight = weight

    def _process(self, pc):
        from .. import cwipc_from_numpy_array

        lut, defined = self.colorMap.as_arrays()
        arr = pc.get_numpy_array()
        tiles = arr["tile"]
        has_color = defined[tiles]
        mapped = lut[tiles] * 255.0
        w = self.weight
        for i, ch in enumerate(("r", "g", "b")):
            blended = (mapped[:, i] * w + arr[ch] * (1 - w)).astype(np.uint8)
            arr[ch] = np.where(has_color, blended, arr[ch])
        new_pc = cwipc_from_numpy_array(arr, pc.timestamp(), device=pc._device)
        new_pc._set_cellsize(pc.cellsize())
        return new_pc


CustomFilter = ColorizeFilter
