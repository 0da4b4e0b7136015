"""direction filter (reference: python/cwipc/filters/direction.py).

The port of cwipc_util_tpu/filters/direction.py: keeps points whose
estimated surface normal faces a direction, with the normals of
registration/normals.py (the reference uses Open3D's).
"""

from .abstract import BaseFilter


class DirectionFilter(BaseFilter):
    """
    direction - Keep only points whose normal faces a direction.
        Arguments:
            x, y, z: the direction vector
            threshold: minimum dot product between normal and direction
    """

    filtername = "direction"

    def __init__(self, x: float, y: float, z: float, threshold: float = 0.0):
        super().__init__()
        self.direction = (x, y, z)
        self.threshold = threshold

    def _process(self, pc):
        from ..registration.util import cwipc_direction_filter

        return cwipc_direction_filter(pc, self.direction, self.threshold)


CustomFilter = DirectionFilter
