"""voxelize filter (reference: python/cwipc/filters/voxelize.py:6-30).

The port of cwipc_util_tpu/filters/voxelize.py, on ops.cwipc_downsample.
"""

from ..ops import cwipc_downsample
from .abstract import BaseFilter


class VoxelizeFilter(BaseFilter):
    """
    voxelize - Reduce pointcloud to voxel grid centroids.
        Arguments:
            vsize: voxel cell size (meters)
    """

    filtername = "voxelize"

    def __init__(self, vsize: float):
        super().__init__()
        self.vsize = vsize

    def _process(self, pc):
        return cwipc_downsample(pc, self.vsize)


CustomFilter = VoxelizeFilter
