"""analyze filter (reference: python/cwipc/filters/analyze.py).

The port of cwipc_util_tpu/filters/analyze.py: per-axis min/max and the
mean of the clouds' centroids over all clouds seen, on the host.
"""

import numpy as np

from .abstract import BaseFilter


class AnalyzeFilter(BaseFilter):
    """
    analyze - Log point cloud statistics (bounding box, centroid).
        Arguments: none
    """

    filtername = "analyze"

    def __init__(self):
        super().__init__()
        self.mins = np.full(3, np.inf)
        self.maxs = np.full(3, -np.inf)
        self.sum_avg = np.zeros(3)
        self.nonempty = 0  # avg_centroid averages only clouds that have points

    def _process(self, pc):
        m = pc.get_numpy_matrix(onlyGeometry=True)
        if m.shape[0]:
            self.mins = np.minimum(self.mins, m.min(axis=0))
            self.maxs = np.maximum(self.maxs, m.max(axis=0))
            self.sum_avg += m.mean(axis=0)
            self.nonempty += 1
        return pc

    def statistics(self):
        print(f"{self.filtername}: count={self.count}")
        if self.nonempty:
            avg = self.sum_avg / self.nonempty
            for i, ax in enumerate("xyz"):
                print(
                    f"{self.filtername}: {ax}: min={self.mins[i]:.3f},"
                    f" max={self.maxs[i]:.3f}, avg_centroid={avg[i]:.3f}"
                )


CustomFilter = AnalyzeFilter
