"""Registration ABCs and result records.

Copied from cwipc_util_tpu/registration/abstract.py, on the port's
wrapper type.  Interface-compatible with the reference's registration ABCs
(reference: python/cwipc/registration/abstract.py:36-328): Algorithm (two
point clouds + filters), AnalysisResults / AnalysisAlgorithm (correspondence
measures over nearest-neighbor distances), OverlapAnalysisAlgorithm
(fitness/rmse), AlignmentAlgorithm (returns a 4x4 transformation) and the
multi-camera orchestrator ABCs.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Type

import numpy as np

from ..core.pointcloud import cwipc_pointcloud_wrapper

RegistrationTransformation = np.ndarray  # 4x4 float64
Vector3 = np.ndarray
PointCloudFilter = Callable[[cwipc_pointcloud_wrapper], cwipc_pointcloud_wrapper]

DEFAULT_CORRESPONDENCE_METHOD = "mean"


class Algorithm(ABC):
    """Any algorithm operating on a source and a reference point cloud."""

    verbose: bool
    debug: bool

    @abstractmethod
    def set_source_pointcloud(self, pc: cwipc_pointcloud_wrapper, tilemask: Optional[int] = None) -> None: ...

    @abstractmethod
    def set_reference_pointcloud(self, pc: cwipc_pointcloud_wrapper, tilemask: Optional[int] = None) -> None: ...

    @abstractmethod
    def run(self) -> bool: ...

    @abstractmethod
    def apply_source_filter(self, filter: PointCloudFilter) -> None: ...

    @abstractmethod
    def apply_reference_filter(self, filter: PointCloudFilter) -> None: ...

    @abstractmethod
    def get_source_pointcloud(self) -> cwipc_pointcloud_wrapper: ...

    @abstractmethod
    def get_filtered_source_pointcloud(self) -> cwipc_pointcloud_wrapper: ...

    @abstractmethod
    def get_reference_pointcloud(self) -> cwipc_pointcloud_wrapper: ...

    @abstractmethod
    def get_filtered_reference_pointcloud(self) -> cwipc_pointcloud_wrapper: ...


class AnalysisResults:
    """Results of an analysis run (correspondence statistics + histogram)."""

    def __init__(self) -> None:
        self.minCorrespondence: float = 0.0
        self.minCorrespondenceCount: int = 0
        self.mean: Optional[float] = None
        self.stddev: Optional[float] = None
        self.tmean: Optional[float] = None
        self.mode: Optional[float] = None
        self.median: Optional[float] = None
        self.sourcePointCount: int = 0
        self.referencePointCount: int = 0
        self.tilemask = None
        self.referenceTilemask: Optional[int] = None
        self.histogram = None
        self.histogramEdges = None
        self.algorithm: str = ""
        self.variant: Optional[str] = None

    def tostr(self) -> str:
        pct = (
            (self.minCorrespondenceCount / self.sourcePointCount) * 100
            if self.sourcePointCount
            else 0.0
        )
        rv = (
            f"correspondence: {self.minCorrespondence:.4f},"
            f" count: {self.minCorrespondenceCount}, percentage: {pct:.0f}%"
        )
        for name in ("mean", "stddev", "tmean", "mode", "median"):
            v = getattr(self, name)
            if v is not None:
                rv += f", {name}={v:.4f}"
        return rv


class AnalysisAlgorithm(Algorithm):
    """Analysis between two clouds: nearest-distance histogram + measures."""

    plot_label: Optional[str]
    correspondence_method: Optional[str]

    @abstractmethod
    def set_correspondence_measure(self, method: str, *other_methods: str) -> None:
        """Choose the correspondence statistic: mean, median, tmean or mode."""
        ...

    @abstractmethod
    def set_max_correspondence_distance(self, correspondence: float) -> None: ...

    @abstractmethod
    def set_min_correspondence_distance(self, correspondence: float) -> None: ...

    @abstractmethod
    def set_ignore_nearest(self, ignore_nearest: int) -> None: ...

    @abstractmethod
    def set_ignore_floor(self, ignoreFloor: bool) -> None: ...

    @abstractmethod
    def get_results(self) -> AnalysisResults: ...


class OverlapAnalysisResults:
    def __init__(self) -> None:
        self.fitness: float = 0.0
        self.rmse: float = 0.0
        self.sourcePointCount: int = 0
        self.referencePointCount: int = 0
        self.tilemask: Optional[int] = None
        self.referenceTilemask: Optional[int] = None


class OverlapAnalysisAlgorithm(Algorithm):
    @abstractmethod
    def set_correspondence(self, correspondence: float) -> None: ...

    @abstractmethod
    def get_results(self) -> OverlapAnalysisResults: ...


AnalysisAlgorithmFactory = Type[AnalysisAlgorithm]


class AlignmentAlgorithm(Algorithm):
    """Finds the transformation aligning the source tile to the reference."""

    @abstractmethod
    def set_correspondence(self, correspondence: float) -> None: ...

    @abstractmethod
    def get_result_transformation(self) -> RegistrationTransformation: ...

    @abstractmethod
    def get_result_pointcloud(self) -> cwipc_pointcloud_wrapper: ...

    @abstractmethod
    def get_result_pointcloud_full(self) -> cwipc_pointcloud_wrapper: ...


AlignmentAlgorithmFactory = Type[AlignmentAlgorithm]


class MulticamAlgorithm(ABC):
    """Any algorithm operating on a tiled (multi-camera) point cloud."""

    verbose: bool
    debug: bool

    @abstractmethod
    def set_tiled_pointcloud(self, pc: cwipc_pointcloud_wrapper) -> None: ...

    @abstractmethod
    def camera_count(self) -> int: ...

    @abstractmethod
    def tilemask_for_camera_index(self, cam_index: int) -> int: ...

    @abstractmethod
    def camera_index_for_tilemask(self, tilenum: int) -> int: ...

    @abstractmethod
    def run(self) -> bool: ...


class MulticamAlignmentAlgorithm(MulticamAlgorithm):
    """Aligns all tiles of a multi-camera cloud."""

    analyzer_class: Optional[AnalysisAlgorithmFactory]
    aligner_class: Optional[AlignmentAlgorithmFactory]

    def __init__(self) -> None:
        self.analyzer_class = None
        self.aligner_class = None

    def set_analyzer_class(self, analyzer_class: AnalysisAlgorithmFactory) -> None:
        self.analyzer_class = analyzer_class

    def set_aligner_class(self, aligner_class: AlignmentAlgorithmFactory) -> None:
        self.aligner_class = aligner_class

    def set_max_correspondence(self, max_correspondence: float) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} does not implement set_max_correspondence()")

    def set_original_transform(self, cam_index: int, matrix: RegistrationTransformation) -> None:
        raise NotImplementedError(f"{self.__class__.__name__} does not implement set_original_transform()")

    @abstractmethod
    def get_result_transformations(self) -> List[RegistrationTransformation]: ...

    @abstractmethod
    def get_result_pointcloud_full(self) -> cwipc_pointcloud_wrapper: ...


MulticamAlignmentAlgorithmFactory = Type[MulticamAlignmentAlgorithm]
