"""transform filter (reference: python/cwipc/filters/transform.py).

The port of cwipc_util_tpu/filters/transform.py: p' = (p + offset) *
scale, on the host as there; the result goes back to the input's device.
"""

import numpy as np

from .abstract import BaseFilter


class TransformFilter(BaseFilter):
    """
    transform - Translate-then-scale all points: p' = (p + (x,y,z)) * scale.
        Arguments:
            x, y, z: translation
            scale: scale factor applied after translation
    """

    filtername = "transform"

    def __init__(self, x: float, y: float, z: float, scale: float):
        super().__init__()
        self.offset = np.array([x, y, z], np.float32)
        self.scale = scale

    def _process(self, pc):
        from .. import cwipc_from_numpy_matrix

        m = pc.get_numpy_matrix()
        m[:, 0:3] = (m[:, 0:3] + self.offset) * self.scale
        new_pc = cwipc_from_numpy_matrix(m, pc.timestamp(), device=pc._device)
        new_pc._set_cellsize(pc.cellsize())
        return new_pc


CustomFilter = TransformFilter
