"""cwipc test_aligner: exercise a multicamera aligner on a file.

The port of cwipc_util_tpu/scripts/cwipc_test_aligner.py.  The files are
read onto ``--device`` (default CUDA): the aligners' and analyzers'
nearest neighbours run on kernel 5 and the tile cuts on kernel 3.

Reference: python/cwipc/scripts/cwipc_test_aligner.py.
"""

import sys

from .. import cwipc_write
from ..registration import analyze as analyze_mod
from ..registration import fine as fine_mod
from ..registration import multicamera
from ._scriptsupport import BaseArgumentParser, add_device_argument, beginOfRun, endOfRun, read_pointcloud


class AlignmentFinder:
    """Multicamera-aligner runner (reference: cwipc_test_aligner.py:18-86):
    resolve the algorithm classes from the args, load the tiled input,
    run the aligner and report/save the outcome."""

    def __init__(self, args):
        self.args = args
        self.verbose = args.verbose > 0
        self.pointcloud = None
        self.aligner = None
        if args.togroundtruth:
            self.multicamera_aligner_class = multicamera.MultiCameraToGroundTruth
        elif args.algorithm:
            self.multicamera_aligner_class = getattr(multicamera, args.algorithm, None)
        else:
            self.multicamera_aligner_class = multicamera.DEFAULT_MULTICAMERA_ALGORITHM
        self.alignment_class = (
            getattr(fine_mod, args.algorithm_fine) if args.algorithm_fine else None
        )
        self.analyzer_class = (
            getattr(analyze_mod, args.algorithm_analyzer)
            if args.algorithm_analyzer
            else None
        )

    def load_input(self, source: str) -> None:
        self.pointcloud = read_pointcloud(source, self.args.device)

    def save_output(self, filename: str) -> None:
        assert self.aligner is not None
        cwipc_write(filename, self.aligner.get_result_pointcloud_full())
        print(f"test_aligner: wrote {filename}")

    def run(self) -> bool:
        cls = self.multicamera_aligner_class
        if cls is None:
            print(f"Unknown algorithm {self.args.algorithm}."
                  f"{multicamera.HELP_MULTICAMERA_ALGORITHMS}")
            return False
        self.aligner = cls()
        self.aligner.verbose = self.verbose
        if self.args.togroundtruth:
            self.aligner.set_groundtruth_pointcloud(read_pointcloud(self.args.togroundtruth, self.args.device))
        if self.alignment_class is not None:
            self.aligner.set_aligner_class(self.alignment_class)
        if self.analyzer_class is not None:
            self.aligner.set_analyzer_class(self.analyzer_class)
        self.aligner.set_tiled_pointcloud(self.pointcloud)
        if self.args.correspondence:
            self.aligner.set_max_correspondence(self.args.correspondence)
        ok = self.aligner.run()
        print(self.aligner.report_change())
        if not ok:
            print("test_aligner: alignment failed")
            return False
        if self.args.plot:
            from ..registration.plot import plot_analysis_results

            results = [
                r for r in getattr(self.aligner, "post_analysis_results", [])
                if r is not None
            ]
            if results:
                plot_analysis_results(results, filename=self.args.plot,
                                      title="After alignment")
                print(f"test_aligner: wrote {self.args.plot}")
        if self.args.output:
            self.save_output(self.args.output)
        return True


def main() -> int:
    parser = BaseArgumentParser(description="Test a multicamera alignment algorithm on a tiled file")
    parser.add_argument("--algorithm", "--algorithm_multicamera", dest="algorithm", default="MultiCameraIterative", help="Multicamera algorithm class name")
    parser.add_argument("--algorithm_fine", help="Pairwise aligner class name")
    parser.add_argument("--algorithm_analyzer", help="Analyzer class name")
    parser.add_argument("--correspondence", type=float, help="Max correspondence distance")
    parser.add_argument("--togroundtruth", metavar="PLYFILE", help="Align every tile to a ground-truth cloud instead")
    parser.add_argument("--plot", metavar="FILE", help="Write per-camera analysis plots to FILE")
    parser.add_argument("--help_algorithms", action="store_true", help="List algorithm class names and exit")
    parser.add_argument("--output", metavar="FILE", help="Write the aligned cloud to FILE")
    parser.add_argument("pointcloud", nargs="?", help="Tiled pointcloud file")
    add_device_argument(parser)
    args = parser.parse_args()
    if args.help_algorithms:
        print(multicamera.HELP_MULTICAMERA_ALGORITHMS)
        print(fine_mod.HELP_FINE_ALIGNMENT_ALGORITHMS)
        print(analyze_mod.HELP_ANALYZER_ALGORITHMS)
        return 0
    if not args.pointcloud:
        print("test_aligner: a pointcloud file is required")
        return 1
    beginOfRun(args)
    finder = AlignmentFinder(args)
    finder.load_input(args.pointcloud)
    ok = finder.run()
    endOfRun(args)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
