"""cwipc join: merge pointcloud files into one.

The port of cwipc_util_tpu/scripts/cwipc_join.py: the files are read and
joined on ``--device`` (default CUDA).

Reference: python/cwipc/scripts/cwipc_join.py.
"""

import sys

from .. import cwipc_join_multi, cwipc_write, cwipc_write_debugdump
from ._scriptsupport import BaseArgumentParser, add_device_argument, beginOfRun, endOfRun, read_pointcloud


def main() -> int:
    parser = BaseArgumentParser(description="Join pointcloud files into one")
    parser.add_argument("output", help="Output file (.ply or .cwipcdump)")
    parser.add_argument("inputs", nargs="+", help="Input files")
    add_device_argument(parser)
    args = parser.parse_args()
    beginOfRun(args)
    pcs = [read_pointcloud(fn, args.device) for fn in args.inputs]
    joined = cwipc_join_multi(pcs)
    if args.output.endswith(".cwipcdump"):
        cwipc_write_debugdump(args.output, joined)
    else:
        cwipc_write(args.output, joined)
    print(f"join: {joined.count()} points -> {args.output}")
    endOfRun(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
