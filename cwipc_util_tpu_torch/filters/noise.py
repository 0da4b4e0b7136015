"""noise filter (reference: python/cwipc/filters/noise.py:9-28).

Displaces every point along a random vector of length <= distance (the
fault-injection fixture for registration tests).  Copied from
cwipc_util_tpu/filters/noise.py: the same numpy RNG use, so one seed gives
the same noise in both packages.  The result stays on its input's device.
"""

import numpy as np

from .abstract import BaseFilter


class NoiseFilter(BaseFilter):
    """
    noise - Add noise to the point coordinates.
        Arguments:
            distance: each point moves along a random vector up to this length
            seed: optional RNG seed for reproducible fixtures
    """

    filtername = "noise"

    def __init__(self, distance: float, seed=None):
        super().__init__()
        self.distance = distance
        self._rng = np.random.default_rng(seed)

    def _process(self, pc):
        from .. import cwipc_from_numpy_matrix

        m = pc.get_numpy_matrix()
        n = m.shape[0]
        # uniform direction, uniform length in [0, distance]
        vec = self._rng.normal(size=(n, 3))
        vec /= np.maximum(np.linalg.norm(vec, axis=1, keepdims=True), 1e-12)
        length = self._rng.uniform(0, self.distance, size=(n, 1))
        m[:, 0:3] += vec * length
        new_pc = cwipc_from_numpy_matrix(m, pc.timestamp(), device=pc._device)
        new_pc._set_cellsize(pc.cellsize())
        return new_pc


CustomFilter = NoiseFilter
