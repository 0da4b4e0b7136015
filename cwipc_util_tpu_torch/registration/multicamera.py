"""Multi-camera fine-alignment orchestrators.

The port of cwipc_util_tpu/registration/multicamera.py, itself a
re-implementation of the reference's multicamera module
(reference: python/cwipc/registration/multicamera.py): per-camera pre/post
analysis, per-step pairwise alignment via a fine aligner, accumulation of
transformations (T_new @ T_old, multicamera.py:342-346), a proposed capture
cellsize derived from the final correspondences (x sqrt(2),
multicamera.py:244-252), and the strategy variants:

* MultiCameraOneToAllOthers — every camera aligned once against the union
  of the others (multicamera.py:308-349),
* MultiCameraToFloor        — every camera aligned to a synthetic Y=0 floor
  disc (multicamera.py:351-407),
* MultiCameraToGroundTruth  — every camera aligned to a given ground-truth
  cloud (multicamera.py:409-460),
* MultiCameraIterative      — the default: seed with the best camera, then
  repeatedly align the not-yet-registered tile with the best overlap
  against the growing registered set, accepting steps only when the
  correspondence improves (multicamera.py:462-741),
* MultiCameraIterativeInteractive — the same, with each step offered to
  the user on stdin (no viewer).

The JAX module's CWIPC_BATCHED_ANALYSIS switch is not ported: the analysis sweeps take the per-pair
two-scale searches of ``analyze.nn_distances_batch`` when the clouds are on
CUDA (the JAX module's accelerator choice) and the sequential analyzers
otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import cwipc_from_numpy_matrix, cwipc_join, cwipc_join_multi
from ..core.pointcloud import cwipc_pointcloud_wrapper
from .abstract import (
    AnalysisResults,
    MulticamAlignmentAlgorithm,
    RegistrationTransformation,
)
from .analyze import (
    DEFAULT_ANALYZER_ALGORITHM,
    DEFAULT_MAX_CORRESPONDENCE,
    OverlapAnalyzer,
    RegistrationAnalyzer,
    RegistrationAnalyzerSymmetric,
    nn_distances_batch,
    nn_distances_batch_shared_ref,
)
from .fine import DEFAULT_FINE_ALIGNMENT_ALGORITHM
from .util import BaseMulticamAlgorithm, cwipc_transform, transformation_identity

# Per-camera work list rows: (camera number, tilemask, correspondence,
# below-correspondence fraction) — reference: multicamera.py:25.
OrderedCameraList = List[Tuple[int, int, float, float]]


def _batched_analysis_enabled(pc: cwipc_pointcloud_wrapper) -> bool:
    """The analysis sweeps go through ``nn_distances_batch`` when the clouds
    are on CUDA, as the JAX module batches them on an accelerator; on the
    CPU the analyzers run one camera at a time."""
    return pc._device is not None and pc._device.type == "cuda"


class BaseMulticamAlignmentAlgorithm(BaseMulticamAlgorithm, MulticamAlignmentAlgorithm):
    """Shared plumbing: analysis passes, transformation bookkeeping, reports."""

    def __init__(self) -> None:
        BaseMulticamAlgorithm.__init__(self)
        MulticamAlignmentAlgorithm.__init__(self)
        self.transformations: List[RegistrationTransformation] = []
        self.pre_analysis_results: List[AnalysisResults] = []
        self.post_analysis_results: List[AnalysisResults] = []
        self.max_correspondence: Optional[float] = None
        self.proposed_cellsize: float = 0.0

    # -- configuration ---------------------------------------------------------

    def set_max_correspondence(self, max_correspondence: float) -> None:
        self.max_correspondence = max_correspondence

    def set_original_transform(self, cam_index: int, matrix: RegistrationTransformation) -> None:
        while len(self.transformations) <= cam_index:
            self.transformations.append(transformation_identity())
        self.transformations[cam_index] = np.asarray(matrix, np.float64)

    def _ensure_transforms(self) -> None:
        while len(self.transformations) < self.camera_count():
            self.transformations.append(transformation_identity())

    # -- analysis helpers --------------------------------------------------------

    def _analyzer(self):
        cls = self.analyzer_class or DEFAULT_ANALYZER_ALGORITHM
        an = cls()
        an.verbose = self.verbose
        return an

    def _aligner(self):
        cls = self.aligner_class or DEFAULT_FINE_ALIGNMENT_ALGORITHM
        al = cls()
        al.verbose = self.verbose
        return al

    def _analyse_camera(self, cam_index: int) -> AnalysisResults:
        """Analyze one camera's (transformed) tile against the union of the
        other cameras' (transformed) tiles."""
        self._ensure_transforms()
        cam_pc = self._moved_pc(cam_index)
        others = [
            self._moved_pc(i) for i in range(self.camera_count()) if i != cam_index
        ]
        registered = cwipc_join_multi(others) if others else cam_pc
        analyzer = self._analyzer()
        analyzer.set_source_pointcloud(cam_pc)
        analyzer.set_reference_pointcloud(registered)
        if self.max_correspondence:
            analyzer.set_max_correspondence_distance(self.max_correspondence)
        analyzer.run()
        return analyzer.get_results()

    def _analyse_all_cameras(self) -> List[AnalysisResults]:
        """The K per-camera analyses of a pre/post sweep.  On CUDA their NN
        distances come from ``nn_distances_batch`` (the two-scale search,
        pair by pair, as the JAX module's batch takes it); elsewhere, and
        for custom analyzer classes, each camera runs its analyzer."""
        n = self.camera_count()
        cls = self.analyzer_class or DEFAULT_ANALYZER_ALGORITHM
        if n < 2 or cls not in (RegistrationAnalyzer, RegistrationAnalyzerSymmetric):
            return [self._analyse_camera(i) for i in range(n)]
        if not _batched_analysis_enabled(self.original_pointcloud):
            return [self._analyse_camera(i) for i in range(n)]
        self._ensure_transforms()
        pts = [self._moved_pc(i).get_numpy_matrix(onlyGeometry=True) for i in range(n)]
        unions = [
            np.concatenate([pts[j] for j in range(n) if j != i]) for i in range(n)
        ]
        maxd = self.max_correspondence or DEFAULT_MAX_CORRESPONDENCE
        dev = self.original_pointcloud._device
        d_fwd = nn_distances_batch(pts, unions, maxd, dev)
        symmetric = issubclass(cls, RegistrationAnalyzerSymmetric)
        d_rev = nn_distances_batch(unions, pts, maxd, dev) if symmetric else [None] * n
        results = []
        for i in range(n):
            analyzer = self._analyzer()
            if self.max_correspondence:
                analyzer.set_max_correspondence_distance(self.max_correspondence)
            analyzer.run_precomputed(d_fwd[i], d_rev[i], len(pts[i]), len(unions[i]))
            results.append(analyzer.get_results())
        return results

    def _pre_analyse(self) -> None:
        self.pre_analysis_results = self._analyse_all_cameras()

    def _post_analyse(self) -> None:
        self.post_analysis_results = self._analyse_all_cameras()
        # proposed capture cellsize: worst final correspondence x sqrt(2)
        # (reference: multicamera.py:244-252)
        corrs = [r.minCorrespondence for r in self.post_analysis_results]
        if corrs:
            self.proposed_cellsize = float(max(corrs) * np.sqrt(2))

    def report_change(self) -> str:
        lines = []
        for i in range(self.camera_count()):
            pre = self.pre_analysis_results[i].minCorrespondence if i < len(self.pre_analysis_results) else 0
            post = self.post_analysis_results[i].minCorrespondence if i < len(self.post_analysis_results) else 0
            lines.append(
                f"camera {i} (tile {self.tilemask_for_camera_index(i)}):"
                f" correspondence {pre:.4f} -> {post:.4f}"
            )
        lines.append(f"proposed cellsize: {self.proposed_cellsize:.4f}")
        return "\n".join(lines)

    # -- results -------------------------------------------------------------------

    def get_result_transformations(self) -> List[RegistrationTransformation]:
        self._ensure_transforms()
        return self.transformations

    def get_result_pointcloud_full(self) -> cwipc_pointcloud_wrapper:
        self._ensure_transforms()
        parts = []
        for i in range(self.camera_count()):
            pc = self.get_pc_for_camnum(i)
            parts.append(cwipc_transform(pc, self.transformations[i]))
        return cwipc_join_multi(parts)

    def _accumulate(self, cam_index: int, new_transform: RegistrationTransformation) -> None:
        """transformations[cam] = T_new @ T_old (reference: :342-346)."""
        self._ensure_transforms()
        self.transformations[cam_index] = (
            np.asarray(new_transform, np.float64) @ self.transformations[cam_index]
        )

    def _moved_pc(self, cam_index: int) -> cwipc_pointcloud_wrapper:
        self._ensure_transforms()
        return cwipc_transform(self.get_pc_for_camnum(cam_index), self.transformations[cam_index])


class MultiCameraOneToAllOthers(BaseMulticamAlignmentAlgorithm):
    """Align each camera once against the union of all the others."""

    def run(self) -> bool:
        self._ensure_transforms()
        self._pre_analyse()
        for i in range(self.camera_count()):
            others = [
                self._moved_pc(j) for j in range(self.camera_count()) if j != i
            ]
            if not others:
                continue
            reference = cwipc_join_multi(others)
            aligner = self._aligner()
            aligner.set_source_pointcloud(self._moved_pc(i))
            aligner.set_reference_pointcloud(reference)
            if self.max_correspondence:
                aligner.set_correspondence(self.max_correspondence)
            if aligner.run():
                self._accumulate(i, aligner.get_result_transformation())
        self._post_analyse()
        return True


def _floor_disc(device, radius: float = 2.0, spacing: float = 0.01) -> cwipc_pointcloud_wrapper:
    """Synthetic Y=0 floor target (reference: multicamera.py:399-403 flattens
    all points to Y=0; a regular disc serves the same purpose)."""
    xs = np.arange(-radius, radius, spacing)
    gx, gz = np.meshgrid(xs, xs)
    mask = gx**2 + gz**2 <= radius**2
    pts = np.zeros((int(mask.sum()), 7), np.float32)
    pts[:, 0] = gx[mask]
    pts[:, 2] = gz[mask]
    pts[:, 3:6] = 128
    return cwipc_from_numpy_matrix(pts, 0, device=device)


class MultiCameraToFloor(BaseMulticamAlignmentAlgorithm):
    """Align every camera's floor points to the Y=0 plane."""

    floor_level = 0.2

    def run(self) -> bool:
        from .util import cwipc_floor_filter

        self._ensure_transforms()
        self._pre_analyse()
        target = _floor_disc(self.original_pointcloud._device)
        for i in range(self.camera_count()):
            cam_pc = self._moved_pc(i)
            floor_pc = cwipc_floor_filter(cam_pc, self.floor_level, keep_floor=True)
            if floor_pc.count() < 100:
                continue
            aligner = self._aligner()
            aligner.set_source_pointcloud(floor_pc)
            aligner.set_reference_pointcloud(target)
            if self.max_correspondence:
                aligner.set_correspondence(self.max_correspondence)
            if aligner.run():
                self._accumulate(i, aligner.get_result_transformation())
        self._post_analyse()
        return True


class MultiCameraToGroundTruth(BaseMulticamAlignmentAlgorithm):
    """Align every camera to a known ground-truth cloud."""

    def __init__(self) -> None:
        super().__init__()
        self.ground_truth: Optional[cwipc_pointcloud_wrapper] = None

    def set_groundtruth_pointcloud(self, pc: cwipc_pointcloud_wrapper) -> None:
        self.ground_truth = pc

    def set_groundtruth(self, pc: cwipc_pointcloud_wrapper) -> None:
        """Reference-parity name (reference: multicamera.py:422)."""
        self.set_groundtruth_pointcloud(pc)

    def run(self) -> bool:
        assert self.ground_truth is not None, "set_groundtruth_pointcloud() first"
        self._ensure_transforms()
        self._pre_analyse()
        for i in range(self.camera_count()):
            aligner = self._aligner()
            aligner.set_source_pointcloud(self._moved_pc(i))
            aligner.set_reference_pointcloud(self.ground_truth)
            if self.max_correspondence:
                aligner.set_correspondence(self.max_correspondence)
            if aligner.run():
                self._accumulate(i, aligner.get_result_transformation())
        self._post_analyse()
        return True


class MultiCameraIterative(BaseMulticamAlignmentAlgorithm):
    """The default strategy: grow a registered set camera by camera.

    Seed with the camera that has the most points; repeatedly pick the
    unregistered camera with the best overlap against the registered set,
    align it, and accept the step only if its correspondence improved
    (reference accept/reject heuristics, multicamera.py:573-596); give up on
    a camera after repeated failures and merge the rest unaligned
    (multicamera.py:727-733).
    """

    max_attempts_per_camera = 2
    interactive = False

    def _overlap(self, pc: cwipc_pointcloud_wrapper, registered: cwipc_pointcloud_wrapper) -> float:
        an = OverlapAnalyzer()
        an.set_source_pointcloud(pc)
        an.set_reference_pointcloud(registered)
        an.set_correspondence(self.max_correspondence or 0.1)
        an.run()
        return an.get_results().fitness

    def _overlaps_batched(
        self, cams: List[int], registered: cwipc_pointcloud_wrapper
    ) -> List[float]:
        """Fitness of every candidate camera against the registered set
        (OverlapAnalyzer semantics: the fraction of source points with a
        registered neighbour within the correspondence), through
        ``nn_distances_batch_shared_ref`` on CUDA."""
        if len(cams) == 1 or not _batched_analysis_enabled(registered):
            return [self._overlap(self._moved_pc(i), registered) for i in cams]
        pts = [self._moved_pc(i).get_numpy_matrix(onlyGeometry=True) for i in cams]
        rpts = registered.get_numpy_matrix(onlyGeometry=True)
        dists = nn_distances_batch_shared_ref(pts, rpts, self.max_correspondence or 0.1,
                                              registered._device)
        return [
            float(np.isfinite(d).sum() / len(p)) if len(p) else 0.0
            for d, p in zip(dists, pts)
        ]

    def _correspondence(self, pc: cwipc_pointcloud_wrapper, registered: cwipc_pointcloud_wrapper) -> float:
        an = self._analyzer()
        an.set_source_pointcloud(pc)
        an.set_reference_pointcloud(registered)
        if self.max_correspondence:
            an.set_max_correspondence_distance(self.max_correspondence)
        an.run()
        return an.get_results().minCorrespondence

    def _confirm_step(self, cam_index: int, before: float, after: float) -> bool:
        return after < before

    def run(self) -> bool:
        n = self.camera_count()
        if n == 0:
            return False
        self._ensure_transforms()
        self._pre_analyse()

        counts = [self.get_pc_for_camnum(i).count() for i in range(n)]
        seed = int(np.argmax(counts))
        registered_idx = [seed]
        registered_pc = self._moved_pc(seed)
        todo = [i for i in range(n) if i != seed]
        attempts = {i: 0 for i in todo}

        while todo:
            overlaps = list(zip(self._overlaps_batched(todo, registered_pc), todo))
            overlaps.sort(reverse=True)
            _, cam = overlaps[0]
            moved = self._moved_pc(cam)
            before = self._correspondence(moved, registered_pc)
            aligner = self._aligner()
            aligner.set_source_pointcloud(moved)
            aligner.set_reference_pointcloud(registered_pc)
            if self.max_correspondence:
                aligner.set_correspondence(self.max_correspondence)
            ok = aligner.run()
            accepted = False
            if ok:
                candidate = aligner.get_result_transformation()
                moved_after = cwipc_transform(moved, candidate)
                after = self._correspondence(moved_after, registered_pc)
                if self.verbose:
                    print(
                        f"multicamera: camera {cam}: correspondence {before:.4f} -> {after:.4f}"
                    )
                if self._confirm_step(cam, before, after):
                    self._accumulate(cam, candidate)
                    accepted = True
            attempts[cam] += 1
            if accepted or attempts[cam] >= self.max_attempts_per_camera:
                # accepted, or give up: merge as-is (reference :727-733)
                registered_idx.append(cam)
                registered_pc = cwipc_join(registered_pc, self._moved_pc(cam))
                todo.remove(cam)
        self._post_analyse()
        return True


class MultiCameraIterativeInteractive(MultiCameraIterative):
    """Iterative alignment where the user accepts or rejects each step."""

    interactive = True

    def _confirm_step(self, cam_index: int, before: float, after: float) -> bool:
        print(
            f"camera {cam_index}: correspondence {before:.4f} -> {after:.4f}."
            " Accept this step? [Y/n] ",
            end="",
            flush=True,
        )
        import sys

        answer = sys.stdin.readline().strip().lower()
        return answer in ("", "y", "yes")


DEFAULT_MULTICAMERA_ALGORITHM = MultiCameraIterative

ALL_MULTICAMERA_ALGORITHMS = [
    MultiCameraOneToAllOthers,
    MultiCameraToFloor,
    MultiCameraIterative,
    MultiCameraIterativeInteractive,
    MultiCameraToGroundTruth,
]

HELP_MULTICAMERA_ALGORITHMS = """
Multicamera alignment algorithms:
    MultiCameraOneToAllOthers        each camera vs union of the others
    MultiCameraToFloor               align floor points to Y=0
    MultiCameraToGroundTruth         align every camera to a given cloud
    MultiCameraIterative             grow a registered set (default)
    MultiCameraIterativeInteractive  iterative with user confirmation
"""
