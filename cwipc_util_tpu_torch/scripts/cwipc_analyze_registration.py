"""cwipc analyze_registration: analyzer suite on a tiled file, with plots.

The port of cwipc_util_tpu/scripts/cwipc_analyze_registration.py.  The
files are read onto ``--device`` (default CUDA): the analyzers' nearest
neighbours run on kernel 5.

Full analysis-mode parity with the reference
(reference: python/cwipc/scripts/cwipc_analyze_registration.py):

- default: each tile against all other tiles combined,
- ``--pairwise``: every ordered tile pair,
- ``--toself`` (+ ``--nth``): self-registration per tile — capture
  precision (nth nearest neighbor inside the same tile),
- ``--totile NUM``: every tile against one chosen tile,
- ``--togroundtruth PLYFILE``: every tile against a ground-truth cloud,
- ``--overlap``: additionally report overlap fitness/inlier-rmse,
- ``--occupancy CELLSIZE``: per-tile occupancy census,
- ``--algorithm_analyzer`` picks the analyzer class by name.
"""

import sys
from typing import List, Tuple

from ..registration import analyze as analyze_mod
from ..registration.analyze import DEFAULT_ANALYZER_ALGORITHM, OverlapAnalyzer
from ..registration.util import (
    cwipc_compute_tile_occupancy,
    cwipc_tilefilter_masked,
    get_tiles_used,
)
from ._scriptsupport import BaseArgumentParser, add_device_argument, beginOfRun, endOfRun, read_pointcloud


class AnalyzePointCloud:
    """Analyzer-suite runner (reference: cwipc_analyze_registration.py:15-119):
    load a tiled cloud (and optional ground truth), build the per-mode tile
    work list, analyze each pair, optionally plot and report occupancy."""

    def __init__(self, args):
        self.args = args
        self.verbose = args.verbose > 0
        self.analyzer_class = (
            getattr(analyze_mod, args.algorithm_analyzer)
            if args.algorithm_analyzer
            else DEFAULT_ANALYZER_ALGORITHM
        )
        self.pointcloud = None
        self.target_pointcloud = None
        self.all_results: List = []

    def load_source(self, source: str) -> None:
        self.pointcloud = read_pointcloud(source, self.args.device)
        self.target_pointcloud = self.pointcloud

    def load_target(self, target: str) -> None:
        self.target_pointcloud = read_pointcloud(target, self.args.device)

    def analyze_pointclouds(self, source, sourcetile: int, target, targettile: int):
        """Run one analyzer pass source(tile) -> target(tile); returns the
        AnalysisResults (reference: cwipc_analyze_registration.py:85-119)."""
        args = self.args
        analyzer = self.analyzer_class()
        analyzer.verbose = self.verbose
        if args.toself:
            analyzer.set_ignore_nearest(args.nth)
        analyzer.set_correspondence_measure(args.measure)
        if args.nokde:
            analyzer.use_kde = False
        max_corr = args.max_corr if args.max_corr >= 0 else args.correspondence
        analyzer.set_max_correspondence_distance(max_corr)
        if args.min_corr > 0:
            analyzer.set_min_correspondence_distance(args.min_corr)
        analyzer.set_ignore_floor(args.ignore_floor)
        analyzer.set_source_pointcloud(source, sourcetile)
        analyzer.set_reference_pointcloud(target)
        analyzer.run()
        return analyzer.get_results()

    def run(self) -> bool:
        args = self.args
        pc = self.pointcloud
        target_pc = self.target_pointcloud
        tiles = get_tiles_used(pc)
        if len(tiles) < 2 and not (args.toself or args.togroundtruth):
            print(f"analyze_registration: {args.pointcloud} has fewer than 2 tiles")
            return False

        todo: List[Tuple[int, int]] = []
        if args.togroundtruth:
            title = "Distance between this tile and ground-truth"
            todo = [(t, 0) for t in tiles]
        elif args.toself:
            title = f"Distance to the nth={args.nth} point in the same tile"
            todo = [(t, t) for t in tiles]
        elif args.totile >= 0:
            title = f"Distance between this tile and tile {args.totile}"
            todo = [(t, args.totile) for t in tiles if t != args.totile]
        elif args.pairwise:
            title = "Distance between each pair of tiles"
            todo = [(s, t) for s in tiles for t in tiles if s != t]
        else:
            title = "Distance between each tile and all other tiles combined"
            todo = [(s, 255 - s) for s in tiles]

        for sourcetile, targettile in todo:
            src = cwipc_tilefilter_masked(pc, sourcetile)
            if args.toself:
                ref = cwipc_tilefilter_masked(target_pc, targettile)
            elif targettile == 0:
                ref = target_pc
            else:
                ref = cwipc_tilefilter_masked(target_pc, targettile)
            results = self.analyze_pointclouds(src, sourcetile, ref, targettile)
            self.all_results.append(results)
            if args.toself:
                label = f"{sourcetile:#x} self, nth={args.nth}"
            else:
                label = f"{sourcetile:#x} to {targettile:#x}"
            print(f"Alignment {label}: {results.tostr()}")
            if args.overlap:
                overlap = OverlapAnalyzer()
                overlap.verbose = self.verbose
                overlap.set_source_pointcloud(src, sourcetile)
                overlap.set_reference_pointcloud(ref)
                overlap.set_correspondence(results.minCorrespondence)
                overlap.run()
                ores = overlap.get_results()
                print(f"Alignment {label}: overlap fitness: {ores.fitness:.6f}, "
                      f"inlier rmse: {ores.rmse:.6f}")

        if args.plot:
            from ..registration.plot import plot_analysis_results

            plot_analysis_results(self.all_results, filename=args.plot, title=title)
        if args.occupancy >= 0:
            # the CELLSIZE argument voxelizes first (reference semantics:
            # cwipc_compute_tile_occupancy(cellsize=...)), which is what makes
            # multi-camera combination tiles appear in the census
            for tilenum, count in cwipc_compute_tile_occupancy(pc, cellsize=args.occupancy):
                print(f"Occupancy: tilenum={tilenum}, count={count}, "
                      f"ncamera={bin(tilenum).count('1')}")
        return True


def main() -> int:
    parser = BaseArgumentParser(description="Analyze registration quality of a tiled pointcloud")
    parser.add_argument("--correspondence", type=float, default=0.1, help="Max correspondence distance")
    parser.add_argument("--max_corr", type=float, default=-1, metavar="DIST", help="Alias of --correspondence (reference flag name)")
    parser.add_argument("--min_corr", type=float, default=0, metavar="DIST", help="Minimum correspondence distance")
    parser.add_argument("--measure", default="mean", help="Correspondence measure: mean, median, tmean, mode, 2mode, q=NN")
    parser.add_argument("--nokde", action="store_true", help="Use the raw histogram instead of the gaussian-KDE density")
    parser.add_argument("--plot", metavar="FILE", help="Write a histogram plot to FILE")
    parser.add_argument("--ignore_floor", action="store_true", help="Exclude floor points")
    parser.add_argument("--pairwise", action="store_true", help="Analyze every ordered pair of tiles")
    parser.add_argument("--toself", action="store_true", help="Self-registration per tile (capture precision)")
    parser.add_argument("--nth", type=int, default=1, metavar="NTH", help="With --toself: use the NTH closest point (default 1)")
    parser.add_argument("--totile", type=int, default=-1, metavar="NUM", help="Analyze every tile against tile NUM")
    parser.add_argument("--togroundtruth", metavar="PLYFILE", help="Analyze every tile against a ground-truth cloud")
    parser.add_argument("--overlap", action="store_true", help="Also report overlap fitness and inlier rmse")
    parser.add_argument("--occupancy", type=float, default=-1, metavar="CELLSIZE", help="Print per-tile occupancy census")
    parser.add_argument("--algorithm_analyzer", help="Analyzer algorithm class name")
    parser.add_argument("pointcloud", help="Tiled pointcloud file")
    add_device_argument(parser)
    args = parser.parse_args()
    beginOfRun(args)
    runner = AnalyzePointCloud(args)
    runner.load_source(args.pointcloud)
    if args.togroundtruth:
        runner.load_target(args.togroundtruth)
    ok = runner.run()
    endOfRun(args)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
