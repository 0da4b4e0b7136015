"""randomize_floor filter (reference: python/cwipc/filters/randomize_floor.py).

The port of cwipc_util_tpu/filters/randomize_floor.py, on
registration.util.cwipc_randomize_floor (numpy's global generator, as
there).
"""

from .abstract import BaseFilter


class RandomizeFloorFilter(BaseFilter):
    """
    randomize_floor - Randomly reassign floor points (y < level) to other tiles.
        Arguments:
            level: y threshold below which points count as floor (default 0.1)
    """

    filtername = "randomize_floor"

    def __init__(self, level: float = 0.1):
        super().__init__()
        self.level = level

    def _process(self, pc):
        from ..registration.util import cwipc_randomize_floor

        return cwipc_randomize_floor(pc, self.level)


CustomFilter = RandomizeFloorFilter
