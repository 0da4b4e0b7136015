"""crop filter (reference: python/cwipc/filters/crop.py).

The port of cwipc_util_tpu/filters/crop.py, on ops.cwipc_crop.
"""

from ..ops import cwipc_crop
from .abstract import BaseFilter


class CropFilter(BaseFilter):
    """
    crop - Keep only points inside a bounding box.
        Arguments:
            minx, maxx, miny, maxy, minz, maxz: bounding box (lower inclusive,
            upper exclusive)
    """

    filtername = "crop"

    def __init__(self, minx, maxx, miny, maxy, minz, maxz):
        super().__init__()
        self.bounding_box = (minx, maxx, miny, maxy, minz, maxz)

    def _process(self, pc):
        return cwipc_crop(pc, self.bounding_box)


CustomFilter = CropFilter
