"""simulatecams filter (reference: python/cwipc/filters/simulatecams.py:9-40).

Copied from cwipc_util_tpu/filters/simulatecams.py: the same numpy math
and RNG use, so one seed gives the same tiles in both packages.  The
result stays on its input's device.

Fabricates multi-camera tiling from any cloud — the key test fixture for
multi-camera algorithms without hardware.  Vectorized: the reference's
per-point argsort loop becomes one [N, ncamera] dot-product matrix.
"""

from typing import Optional

import numpy as np

from .abstract import BaseFilter


class SimulatecamsFilter(BaseFilter):
    """
    simulatecams - Turn a pointcloud into multiple tiles by simulating cameras.
        Arguments:
            ncamera: number of cameras, equidistant on a circle around x=z=0
            hard: if True each point goes to the camera with the highest dot
                  product; if False (default) points near a camera boundary are
                  assigned probabilistically between the two best cameras
            skew: with hard=False, skew > 1 biases toward the closest camera
    """

    filtername = "simulatecams"

    def __init__(self, ncamera: int, hard: Optional[bool] = False, skew: Optional[float] = 1.0, seed=None):
        super().__init__()
        self.ncamera = ncamera
        angles = 2 * np.pi * np.arange(ncamera) / ncamera
        self.camera_vectors = np.stack(
            [np.cos(angles), np.zeros(ncamera), np.sin(angles)], axis=-1
        )
        self.hard = hard
        self.skew = skew
        self._rng = np.random.default_rng(seed)

    def _process(self, pc):
        from .. import cwipc_from_numpy_matrix

        m = pc.get_numpy_matrix()
        pts = m[:, 0:3].copy()
        pts[:, 1] = 0.0  # project to the horizontal plane
        centroid = m[:, 0:3].mean(axis=0)
        centroid[1] = 0.0
        pts -= centroid

        dots = pts @ self.camera_vectors.T  # [N, ncamera]
        order = np.argsort(-dots, axis=1)
        best = order[:, 0]
        if self.hard or self.ncamera < 2:
            cam = best
        else:
            second = order[:, 1]
            n = m.shape[0]
            # clamp before powering: a negative dot raised to a fractional
            # skew is NaN and to an even skew flips sign (the reference's
            # own weight math has this hole, simulatecams.py:63-64); a
            # camera facing away deserves weight 0, not a sign-flipped one
            w0 = np.maximum(dots[np.arange(n), best], 0.0) ** self.skew
            w1 = np.maximum(dots[np.arange(n), second], 0.0) ** self.skew
            chance = self._rng.uniform(-w0, np.maximum(w1, -w0 + 1e-12))
            cam = np.where(chance < 0, best, second)
        m[:, 6] = (1 << cam).astype(np.float32)
        new_pc = cwipc_from_numpy_matrix(m, pc.timestamp(), device=pc._device)
        new_pc._set_cellsize(pc.cellsize())
        return new_pc


CustomFilter = SimulatecamsFilter
