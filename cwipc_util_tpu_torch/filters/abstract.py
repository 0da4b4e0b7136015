"""Filter contract + shared base class.

Copied from cwipc_util_tpu/filters/abstract.py.  Mirrors the reference's uniform filter interface
(reference: python/cwipc/filters/abstract.py:4-20): ``filter(pc) -> pc``,
``statistics()``, ``set_keep_source()``.  The per-filter timing/count
bookkeeping the reference copy-pastes into every module lives once in
:class:`BaseFilter` here.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.stats import Stats, Timer


class cwipc_abstract_filter(ABC):
    @abstractmethod
    def filter(self, pc: cwipc_pointcloud_wrapper) -> cwipc_pointcloud_wrapper:
        """Feed a point cloud to the filter; returns the resulting cloud."""
        ...

    def statistics(self) -> None:
        ...

    def set_keep_source(self) -> None:
        """Keep the source cloud instead of freeing it after processing."""
        ...


class BaseFilter(cwipc_abstract_filter):
    """Shared plumbing: timing, point-count stats, keep_source handling."""

    filtername = "filter"

    def __init__(self) -> None:
        self.count = 0
        self.keep_source = False
        self.stats = Stats(self.filtername)

    def set_keep_source(self) -> None:
        self.keep_source = True

    def print1stat(self, name: str, values, isInt: bool = False) -> None:
        """Print count/average/min/max of one series (the reference defines
        this helper on every filter class; reference filters/colorize.py:127)."""
        from ..utils.stats import print1stat

        print1stat(self.filtername, name, values, isInt)

    def filter(self, pc: cwipc_pointcloud_wrapper) -> cwipc_pointcloud_wrapper:
        self.count += 1
        self.stats.add("original_pointcount", pc.count(), isInt=True)
        with Timer(self.stats):
            new_pc = self._process(pc)
        if new_pc is not pc:
            self.stats.add("pointcount", new_pc.count(), isInt=True)
            # Like the reference filters, the source cloud is left to the
            # garbage collector (wrapper __del__ frees it); keep_source is
            # honored by callers that hold on to the input.
        return new_pc

    def _process(self, pc: cwipc_pointcloud_wrapper) -> cwipc_pointcloud_wrapper:
        raise NotImplementedError

    def statistics(self) -> None:
        print(f"{self.filtername}: count={self.count}")
        self.stats.print()
