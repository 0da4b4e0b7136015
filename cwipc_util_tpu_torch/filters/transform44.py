"""transform44 filter (reference: python/cwipc/filters/transform44.py).

The port of cwipc_util_tpu/filters/transform44.py, on
registration.util.cwipc_transform.
"""

import numpy as np

from .abstract import BaseFilter


class Transform44Filter(BaseFilter):
    """
    transform44 - Apply a 4x4 homogeneous transformation matrix to all points.
        Arguments:
            matrix: 4x4 nested list (row major)
    """

    filtername = "transform44"

    def __init__(self, matrix):
        super().__init__()
        self.matrix = np.asarray(matrix, np.float64).reshape(4, 4)

    def _process(self, pc):
        from ..registration.util import cwipc_transform

        return cwipc_transform(pc, self.matrix)


CustomFilter = Transform44Filter
