"""cwipc find_transform: pairwise ICP between two files/tiles.

The port of cwipc_util_tpu/scripts/cwipc_find_transform.py.  The files are
read onto ``--device`` (default CUDA): the aligner's nearest neighbours
run on kernel 5, the analyses' on kernel 5 and the tile cuts on kernel 3.

Full flow parity with the reference
(reference: python/cwipc/scripts/cwipc_find_transform.py): before/after
alignment analysis printout, auto correspondence threshold from the
pre-analysis, --dump writes color-coded combined before/after clouds,
--output saves the aligned result, --plot shows the distance
distributions, and the result prints as a ready-to-use
``--filter 'transform44(...)'`` expression.
"""

import sys

import numpy as np

from .. import cwipc_colormap, cwipc_join, cwipc_write
from ..registration import fine
from ..registration.analyze import RegistrationAnalyzer
from ..registration.util import cwipc_tilefilter_masked
from ._scriptsupport import BaseArgumentParser, add_device_argument, beginOfRun, endOfRun, read_pointcloud


class TransformFinder:
    """Pairwise alignment runner (reference: cwipc_find_transform.py:14-96):
    load source/target clouds (optionally tile-filtered), analyze before,
    align, analyze after, emit the transform."""

    def __init__(self, args):
        self.args = args
        self.verbose = args.verbose > 0
        self.source = None
        self.target = None
        self.result = None
        self.transform = None

    def load_source(self, source: str) -> None:
        self._source_filename = source
        self.source = read_pointcloud(source, self.args.device)
        if self.args.sourcetile:
            self.source = cwipc_tilefilter_masked(self.source, self.args.sourcetile)

    def load_target(self, target: str) -> None:
        # With no explicit target the target is the SOURCE FILE, re-read
        # unfiltered — load_source may already have reduced self.source to
        # --sourcetile, and tile-vs-tile alignment within one file needs
        # the full cloud (or its --targettile subset) as the target.
        self.target = read_pointcloud(target if target else self._source_filename, self.args.device)
        if self.args.targettile:
            self.target = cwipc_tilefilter_masked(self.target, self.args.targettile)

    def _fnmod(self) -> str:
        if self.args.sourcetile or self.args.targettile:
            return f"_{self.args.sourcetile or 0}_{self.args.targettile or 0}"
        return ""

    def dump_pointclouds(self, filename: str, source, target) -> None:
        """Color-coded combined dump: source red, target green
        (reference: cwipc_find_transform.py:73-80)."""
        if self.verbose:
            print(f"Dumping point clouds to {filename}")
        colored_source = cwipc_colormap(source, 0xFFFFFFFF, 0xAAFF0000)
        colored_target = cwipc_colormap(target, 0xFFFFFFFF, 0xAA00FF00)
        combined = cwipc_join(colored_source, colored_target)
        cwipc_write(filename, combined)
        colored_source.free()
        colored_target.free()
        combined.free()

    def analyze_pointclouds(self, label: str, source, target, plot=False):
        """One before/after analysis pass; returns the AnalysisResults
        (reference: cwipc_find_transform.py:81-96)."""
        analyzer = RegistrationAnalyzer()
        analyzer.verbose = self.verbose
        analyzer.set_source_pointcloud(source)
        analyzer.set_reference_pointcloud(target)
        if self.args.measure:
            analyzer.set_correspondence_measure(*self.args.measure)
        analyzer.run()
        results = analyzer.get_results()
        print(f"{label} alignment: {results.tostr()}")
        if plot:
            from ..registration.plot import plot_analysis_results

            plot_analysis_results(
                [results],
                filename=plot if isinstance(plot, str) else None,
                title=label,
            )
        return results

    def save_output(self, filename: str) -> None:
        assert self.result is not None
        cwipc_write(filename, self.result)

    def run(self) -> bool:
        fnmod = self._fnmod()
        if self.args.dump:
            self.dump_pointclouds(
                f"find_transform_before{fnmod}.ply", self.source, self.target
            )
        pre = self.analyze_pointclouds("Before", self.source, self.target)
        correspondence = self.args.correspondence
        if correspondence < 0:
            correspondence = pre.minCorrespondence

        cls = getattr(fine, self.args.algorithm, None)
        if cls is None:
            print(f"Unknown algorithm {self.args.algorithm}."
                  f"{fine.HELP_FINE_ALIGNMENT_ALGORITHMS}")
            return False
        print(f"Using aligner {cls.__name__} with correspondence threshold {correspondence}")
        aligner = cls()
        aligner.verbose = self.verbose
        aligner.set_source_pointcloud(self.source)
        aligner.set_reference_pointcloud(self.target)
        aligner.set_correspondence(correspondence)
        if not aligner.run():
            print("find_transform: alignment failed")
            return False
        self.transform = aligner.get_result_transformation()
        self.result = aligner.get_result_pointcloud()

        if self.args.dump:
            cwipc_write(f"find_transform_result{fnmod}.ply", self.result)
            self.dump_pointclouds(
                f"find_transform_after{fnmod}.ply", self.result, self.target
            )
        self.analyze_pointclouds("After", self.result, self.target, self.args.plot)
        if self.args.output:
            self.save_output(self.args.output)

        np.set_printoptions(suppress=True, precision=6)
        print(np.asarray(self.transform))
        rows = ", ".join(
            "[" + ", ".join(f"{v:.6f}" for v in row) + "]"
            for row in np.asarray(self.transform)
        )
        print(f"Transform filter needed: --filter 'transform44([{rows}])'")
        return True


def main() -> int:
    parser = BaseArgumentParser(description="Find the transform aligning one cloud/tile to another")
    parser.add_argument("--algorithm", default="RegistrationComputer_ICP_Generalized", help="Fine alignment algorithm class name")
    parser.add_argument("--correspondence", type=float, default=-1, help="Max correspondence distance (default: from the pre-analysis)")
    parser.add_argument("--measure", action="append", metavar="METHOD", help="Correspondence measure(s): mean, median, tmean, mode")
    parser.add_argument("--sourcetile", type=int, help="Tile mask selecting the source points")
    parser.add_argument("--targettile", "--referencetile", dest="targettile", type=int, help="Tile mask selecting the target points")
    parser.add_argument("--plot", metavar="FILE", help="Write distance-distribution plots to FILE")
    parser.add_argument("--dump", action="store_true", help="Dump color-coded combined before/after clouds to files")
    parser.add_argument("--output", metavar="FILE", help="Write the aligned source cloud to FILE")
    parser.add_argument("source", help="Source pointcloud file")
    parser.add_argument("target", nargs="?", help="Target pointcloud file (default: same as source)")
    add_device_argument(parser)
    args = parser.parse_args()
    beginOfRun(args)
    finder = TransformFinder(args)
    finder.load_source(args.source)
    finder.load_target(args.target)
    ok = finder.run()
    endOfRun(args)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
