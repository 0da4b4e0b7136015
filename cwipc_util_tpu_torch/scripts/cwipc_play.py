"""cwipc play: view recorded pointcloud files (positional input argument).

Reference: python/cwipc/scripts/cwipc_play.py — view for files/recordings.

The port of cwipc_util_tpu/scripts/cwipc_play.py: ``play INPUT`` runs the
port's ``view --playback INPUT``, on ``--device`` (default CUDA).
"""

import sys

from . import cwipc_view
from .cwipc_copy import VIEW_VALUE_FLAGS, _positionals


def help_commands():
    """Print the viewer keymap (reference: cwipc_play.py:12-13)."""
    cwipc_view.help_commands()


def main() -> int:
    # `play INPUT` is `view --playback INPUT`; rewrite argv and delegate.
    argv = sys.argv[1:]
    positional = _positionals(argv, VIEW_VALUE_FLAGS)
    if positional:
        idx = argv.index(positional[0])
        argv = argv[:idx] + argv[idx + 1 :]
        argv = ["--playback", positional[0]] + argv
    sys.argv = [sys.argv[0].replace("play", "view")] + argv
    return cwipc_view.main()


if __name__ == "__main__":
    sys.exit(main())
