"""cwipc copy: convert recordings between formats (grab from playback).

Reference: python/cwipc/scripts/cwipc_copy.py — the same FileWriter
machinery as grab, with a positional input.

The port of cwipc_util_tpu/scripts/cwipc_copy.py: ``copy IN OUT`` runs the
port's ``grab``, on ``--device`` (default CUDA; ``--compress`` encodes on
that device).  The flags that take a value are read from the port's own
``grab`` and ``view`` parsers.
"""

import os
import sys

from . import cwipc_grab
from .cwipc_grab import FileWriter  # noqa: F401  (reference module surface:
# cwipc_copy.py defines its own FileWriter; this port shares grab's)


# Options that consume a following value must not have their values
# mistaken for positional arguments when rewriting argv.  The sets differ
# per delegation target — e.g. --rgb takes a value in grab (an image
# extension) but is a store_true in view — so they are DERIVED from the
# target's own argparse actions (argparse sets nargs=0 for store_true/
# store_false/store_const/count actions; everything else consumes values).


def _value_flags_from_parser(parser):
    flags = set()
    for action in parser._actions:
        if action.option_strings and action.nargs != 0:
            flags.update(action.option_strings)
    return flags


def GRAB_VALUE_FLAGS():
    from .cwipc_grab import make_parser

    return _value_flags_from_parser(make_parser())


def VIEW_VALUE_FLAGS():
    from .cwipc_view import make_parser

    return _value_flags_from_parser(make_parser())


def _positionals(argv, value_flags):
    if callable(value_flags):
        value_flags = value_flags()
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a.startswith("-"):
            if a in value_flags and "=" not in a:
                skip = True
            continue
        out.append(a)
    return out


def main() -> int:
    """Reference stream/single dispatch (cwipc_copy.py:220-258): a .json or
    directory input is a stream, a .ply/.cwipcdump/.cwicpc output is a single
    file; stream<->single mixes are rejected, a missing output directory is
    created, and single-file outputs get their format from the extension."""
    argv = sys.argv[1:]
    positional = _positionals(argv, GRAB_VALUE_FLAGS)
    if len(positional) >= 2:
        inp, outp = positional[0], positional[1]
        stream_input = inp.endswith(".json") or os.path.isdir(inp)
        # case-sensitive like the reference (cwipc_copy.py:234-245) and like
        # grab's writer dispatch — out.PLY is "unknown extension", not PLY
        single_output = outp.endswith((".ply", ".cwipcdump", ".cwicpc"))
        prog = "cwipc copy"
        if stream_input and single_output:
            print(
                f"{prog}: Cannot convert stream input to single point cloud output file",
                file=sys.stderr,
            )
            return 1
        if not stream_input and not single_output:
            print(
                f"{prog}: Cannot convert single point cloud input to stream output",
                file=sys.stderr,
            )
            return 1
        # locate BOTH positionals in the original argv before rewriting:
        # indexing after the prepend could match the playback flag's value
        # when input and output names collide (e.g. in-place conversion)
        idx_in = argv.index(inp)
        if single_output:
            idx_out = argv.index(outp, idx_in + 1)
            argv = argv[:idx_out] + argv[idx_out + 1 :]
        argv = argv[:idx_in] + argv[idx_in + 1 :]
        src_flag = "--cameraconfig" if inp.endswith(".json") else "--playback"
        argv = [src_flag, inp] + argv
        if single_output:
            argv = ["--single_output", outp] + argv
        elif not os.path.isdir(outp):
            if os.path.exists(outp):
                print(f"{prog}: unknown extension in output file: {outp}", file=sys.stderr)
                return 2
            os.mkdir(outp)  # reference cwipc_copy.py:252
    sys.argv = [sys.argv[0].replace("copy", "grab")] + argv
    return cwipc_grab.main()


if __name__ == "__main__":
    sys.exit(main())
