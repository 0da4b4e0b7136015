"""remove_outliers filter (reference: python/cwipc/filters/remove_outliers.py).

The port of cwipc_util_tpu/filters/remove_outliers.py, on
ops.cwipc_remove_outliers.
"""

from ..ops import cwipc_remove_outliers
from .abstract import BaseFilter


class RemoveOutliersFilter(BaseFilter):
    """
    remove_outliers - Statistical outlier removal.
        Arguments:
            kNeighbours: neighbors analyzed per point
            threshold: stddev multiplier
            perTile: apply per tile instead of to the whole cloud
    """

    filtername = "remove_outliers"

    def __init__(self, kNeighbours: int, threshold: float, perTile: bool = False):
        super().__init__()
        self.kNeighbours = kNeighbours
        self.threshold = threshold
        self.perTile = perTile

    def _process(self, pc):
        return cwipc_remove_outliers(pc, self.kNeighbours, self.threshold, self.perTile)


CustomFilter = RemoveOutliersFilter
