"""Alignment analyzers: nearest-distance statistics between clouds.

The port of cwipc_util_tpu/registration/analyze.py (reference:
python/cwipc/registration/analyze.py): per-point nearest-neighbour
distances from source to reference (ops/knn.py: the column grid with
kernel 5 on CUDA, the two-scale search on the CPU), the distance histogram
(a gaussian-KDE density by default, ``use_kde``), and the
"correspondence" that best characterizes how far the source is from the
reference: mean / trimmed mean / median / mode (histogram peak) / 2mode /
q=NN (percentile).  The symmetric variant (the default) analyzes both
directions and keeps the worse correspondence.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.buffers import bucket_capacity
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..ops.knn import nn_search, nn_search_host_auto
from .abstract import AnalysisAlgorithm, AnalysisResults, OverlapAnalysisAlgorithm, OverlapAnalysisResults
from .util import BaseAlgorithm

DEFAULT_MAX_CORRESPONDENCE = 0.1  # 10cm: sane upper bound for camera misalignment
DEFAULT_MIN_CORRESPONDENCE = 0.0001
HISTOGRAM_BINS = 400  # reference: histogram_bincount default (analyze.py:35)
FLOOR_LEVEL = 0.1  # points below this Y are "floor" and can be excluded


def _nn_distances(src: cwipc_pointcloud_wrapper, ref: cwipc_pointcloud_wrapper, max_distance: float,
                  ignore_nearest: int = 0) -> np.ndarray:
    """NN distances source -> reference (inf = no match in range)."""
    sbuf = src._access_buffer()
    rbuf = ref._access_buffer()
    if ignore_nearest > 0:
        # self-precision mode: the distance to the (ignore_nearest)-th real
        # neighbour needs a k-th-neighbour query (the reference's scipy
        # KDTree k-offset, analyze.py:120-123)
        from scipy.spatial import cKDTree

        spts = sbuf.xyz[: src.count()].cpu().numpy()
        rpts = rbuf.xyz[: ref.count()].cpu().numpy()
        if len(rpts) <= ignore_nearest:
            return np.empty(0, np.float32)
        tree = cKDTree(rpts)
        dist, _ = tree.query(spts, k=ignore_nearest + 1, workers=-1)
        d = np.atleast_2d(dist)[:, -1]
        return d[np.isfinite(d) & (d <= max_distance)].astype(np.float32)
    dist, _ = nn_search_host_auto(sbuf.xyz, sbuf.count, rbuf.xyz, rbuf.count, max_distance)
    return dist[: src.count()].cpu().numpy()


def _padded(pts: np.ndarray, device) -> torch.Tensor:
    buf = np.zeros((bucket_capacity(max(len(pts), 1)), 3), np.float32)
    buf[: len(pts)] = pts
    return torch.from_numpy(buf).to(device)


def nn_distances_batch(
    src_pts: "list[np.ndarray]",
    ref_pts: "list[np.ndarray]",
    max_distance: float,
    device,
) -> "list[np.ndarray]":
    """Finite-or-inf NN distances for K (source, reference) point-set pairs
    through the two-scale :func:`nn_search` on ``device``.  Entry i has
    length len(src_pts[i]).

    The JAX module vmaps the K searches into one program only to save
    device dispatches; the port runs them one pair after another.  The
    per-pair results are identical: a row's result does not depend on the
    padded capacity it sits in."""
    if len(src_pts) != len(ref_pts):
        raise ValueError("nn_distances_batch: as many reference sets as source sets")
    out = []
    for s, r in zip(src_pts, ref_pts):
        dist, _ = nn_search(_padded(s, device), len(s), _padded(r, device), len(r), max_distance)
        out.append(dist[: len(s)].cpu().numpy())
    return out


def nn_distances_batch_shared_ref(
    src_pts: "list[np.ndarray]",
    ref_pts: np.ndarray,
    max_distance: float,
    device,
) -> "list[np.ndarray]":
    """:func:`nn_distances_batch` with one reference point set shared by
    every query (uploaded once)."""
    ref = _padded(ref_pts, device)
    out = []
    for s in src_pts:
        dist, _ = nn_search(_padded(s, device), len(s), ref, len(ref_pts), max_distance)
        out.append(dist[: len(s)].cpu().numpy())
    return out


class RegistrationAnalyzer(BaseAlgorithm, AnalysisAlgorithm):
    """One-directional analyzer: how far is the source from the reference."""

    plot_label: Optional[str] = None

    def __init__(self) -> None:
        BaseAlgorithm.__init__(self)
        self.correspondence_method = "mean"
        self._extra_methods: Tuple[str, ...] = ()
        self.max_correspondence = DEFAULT_MAX_CORRESPONDENCE
        self.min_correspondence = DEFAULT_MIN_CORRESPONDENCE
        # binsize semantics engage only when the caller SETS a minimum
        # correspondence (reference: histogram_binsize defaults to 0 and
        # the default histogram is bincount=400, analyze.py:35-37,148-159)
        self._histogram_binsize: float | None = None
        self.ignore_nearest = 0
        self.ignore_floor = False
        # Reference parity: the distance density defaults to a gaussian
        # KDE evaluated on the histogram grid (analyze.py:48,171-179,275).
        self.use_kde = True
        self.gaussian_bw_method = None
        self.histogram_bincount = HISTOGRAM_BINS
        self._results: Optional[AnalysisResults] = None

    # -- configuration -------------------------------------------------------

    def set_correspondence_measure(self, method: str, *other_methods: str) -> None:
        self.correspondence_method = method
        self._extra_methods = other_methods

    def set_max_correspondence_distance(self, correspondence: float) -> None:
        self.max_correspondence = correspondence

    def set_min_correspondence_distance(self, correspondence: float) -> None:
        self.min_correspondence = correspondence
        self._histogram_binsize = correspondence

    def set_ignore_nearest(self, ignore_nearest: int) -> None:
        self.ignore_nearest = ignore_nearest

    def set_ignore_floor(self, ignoreFloor: bool) -> None:
        self.ignore_floor = ignoreFloor

    # -- run ------------------------------------------------------------------

    def _maybe_drop_floor(self, pc: cwipc_pointcloud_wrapper) -> cwipc_pointcloud_wrapper:
        if not self.ignore_floor:
            return pc
        from .util import cwipc_floor_filter

        return cwipc_floor_filter(pc, FLOOR_LEVEL, keep_floor=False)

    def _distances(self) -> np.ndarray:
        src = self._maybe_drop_floor(self.get_filtered_source_pointcloud())
        ref = self._maybe_drop_floor(self.get_filtered_reference_pointcloud())
        return _nn_distances(src, ref, self.max_correspondence, self.ignore_nearest)

    def run(self) -> bool:
        d = self._distances()
        self._results = self._compute_results(
            d,
            self.get_filtered_source_pointcloud().count(),
            self.get_filtered_reference_pointcloud().count(),
        )
        return True

    def _compute_results(self, d: np.ndarray, n_src: int, n_ref: int) -> AnalysisResults:
        res = AnalysisResults()
        res.algorithm = self.__class__.__name__
        res.variant = self.correspondence_method
        res.sourcePointCount = n_src
        res.referencePointCount = n_ref
        res.tilemask = self.source_tilemask
        res.referenceTilemask = self.reference_tilemask

        finite = d[np.isfinite(d)]
        if finite.size == 0:
            res.minCorrespondence = self.max_correspondence
            return res

        res.mean = float(finite.mean())
        res.stddev = float(finite.std())
        res.median = float(np.median(finite))
        from scipy import stats as _stats

        # reference: scipy trim_mean with 10% trimmed per tail (analyze.py:207)
        res.tmean = float(_stats.trim_mean(finite, 0.1)) if finite.size else res.mean

        hist, edges = self._compute_histogram(finite)
        res.histogram = hist
        res.histogramEdges = edges
        # reference's _mode_from_histogram: the RIGHT edge of the peak bin
        # (analyze.py:136-139)
        peak = int(np.argmax(hist))
        res.mode = float(edges[peak + 1])

        method = self.correspondence_method
        if method == "2mode":
            measure = 2.0 * res.mode
        elif method.startswith("q="):
            try:
                q = float(method[2:])  # superset of the reference's int
            except ValueError:
                raise ValueError(f"Unknown correspondence measure '{method}'")
            measure = float(np.percentile(finite, q))
        else:
            known = {
                "mean": res.mean,
                "median": res.median,
                "tmean": res.tmean,
                "mode": res.mode,
            }
            if method not in known:
                # the reference rejects unknown measures (analyze.py:240); a
                # silent fallback would change the multicamera thresholds
                raise ValueError(f"Unknown correspondence measure '{method}'")
            measure = known[method]
        res.minCorrespondence = float(measure)
        res.minCorrespondenceCount = int((finite <= res.minCorrespondence).sum())
        return res

    def _histogram_bins(self, finite: np.ndarray) -> int:
        """Reference semantics (analyze.py:141-159): an EXPLICITLY-set
        minimum correspondence is the minimum meaningful granularity,
        i.e. the BIN SIZE; otherwise the default bincount applies."""
        max_d = float(finite.max())
        if self._histogram_binsize and self._histogram_binsize > 0 and max_d > 0:
            bins = int(max_d / self._histogram_binsize)
            return max(1, min(bins, 100_000))
        return self.histogram_bincount

    def _compute_histogram(self, finite: np.ndarray):
        bins = self._histogram_bins(finite)
        max_d = float(finite.max())
        if self.use_kde and finite.size > 2 and max_d > 0 and float(finite.min()) < max_d:
            # gaussian-KDE density evaluated on the histogram grid
            # (reference analyze.py:171-179): edges from 0 to the maximum
            # distance, the density sampled at each bin's right edge
            from scipy import stats as _stats

            try:
                kde = _stats.gaussian_kde(finite, bw_method=self.gaussian_bw_method)
            except (np.linalg.LinAlgError, ValueError):
                pass  # singular data: fall through to the raw histogram
            else:
                edges = np.linspace(0.0, max_d, bins + 1)
                return kde.evaluate(edges[1:]), edges
        return np.histogram(finite, bins=bins)

    def get_results(self) -> AnalysisResults:
        assert self._results is not None
        return self._results

    def run_precomputed(
        self,
        d_fwd: np.ndarray,
        d_rev: Optional[np.ndarray],
        n_src: int,
        n_ref: int,
    ) -> bool:
        """run() with NN distances computed elsewhere (the multicamera
        sweep); the statistics are run()'s."""
        self._results = self._compute_results(d_fwd, n_src, n_ref)
        return True


class RegistrationAnalyzerSymmetric(RegistrationAnalyzer):
    """Analyzes both directions, keeping the worse (larger) correspondence --
    the default analyzer (reference: analyze.py:284-336, 389)."""

    def run(self) -> bool:
        src = self._maybe_drop_floor(self.get_filtered_source_pointcloud())
        ref = self._maybe_drop_floor(self.get_filtered_reference_pointcloud())
        d_fwd = _nn_distances(src, ref, self.max_correspondence, self.ignore_nearest)
        d_rev = _nn_distances(ref, src, self.max_correspondence, self.ignore_nearest)
        return self.run_precomputed(d_fwd, d_rev, src.count(), ref.count())

    def run_precomputed(
        self,
        d_fwd: np.ndarray,
        d_rev: Optional[np.ndarray],
        n_src: int,
        n_ref: int,
    ) -> bool:
        assert d_rev is not None
        r_fwd = self._compute_results(d_fwd, n_src, n_ref)
        r_rev = self._compute_results(d_rev, n_ref, n_src)
        self._results = (
            r_fwd if r_fwd.minCorrespondence >= r_rev.minCorrespondence else r_rev
        )
        self._results.sourcePointCount = n_src
        self._results.referencePointCount = n_ref
        self._results.tilemask = self.source_tilemask
        self._results.referenceTilemask = self.reference_tilemask
        return True


class OverlapAnalyzer(BaseAlgorithm, OverlapAnalysisAlgorithm):
    """Fitness/RMSE overlap measure (reference: analyze.py:338-387, open3d
    evaluate_registration there): fitness = fraction of source points with
    a reference neighbour within the correspondence distance, rmse over
    those inliers."""

    def __init__(self) -> None:
        BaseAlgorithm.__init__(self)
        self.correspondence = DEFAULT_MAX_CORRESPONDENCE
        self._results: Optional[OverlapAnalysisResults] = None

    def set_correspondence(self, correspondence: float) -> None:
        self.correspondence = correspondence

    def run(self) -> bool:
        src = self.get_filtered_source_pointcloud()
        ref = self.get_filtered_reference_pointcloud()
        d = _nn_distances(src, ref, self.correspondence)
        inliers = d[np.isfinite(d)]
        res = OverlapAnalysisResults()
        res.sourcePointCount = src.count()
        res.referencePointCount = ref.count()
        res.tilemask = self.source_tilemask
        res.referenceTilemask = self.reference_tilemask
        if src.count() > 0 and inliers.size > 0:
            res.fitness = float(inliers.size / src.count())
            res.rmse = float(np.sqrt((inliers**2).mean()))
        self._results = res
        return True

    def get_results(self) -> OverlapAnalysisResults:
        assert self._results is not None
        return self._results


DEFAULT_ANALYZER_ALGORITHM = RegistrationAnalyzerSymmetric
BaseRegistrationAnalyzer = RegistrationAnalyzer

ALL_ANALYZER_ALGORITHMS: List[type] = [
    RegistrationAnalyzer,
    RegistrationAnalyzerSymmetric,
    OverlapAnalyzer,
]

HELP_ANALYZER_ALGORITHMS = """
Analyzer algorithms:
    RegistrationAnalyzer           one-directional NN-distance statistics
    RegistrationAnalyzerSymmetric  both directions, worse wins (default)
    OverlapAnalyzer                fitness/rmse overlap measure
Correspondence measures: mean, median, tmean, mode, 2mode, q=NN (percentile).
The distance density is a gaussian-KDE histogram by default (use_kde).
"""
