"""Device idle ms a traced frame while the host was inside the program's
``cwipc.exact`` span and none of its stages' spans: the stack, kernel 4's
and kernel 3's host calls, the gather back to points, the keep mask and
the uncovered count (ops/chain.py ``downsample_outliers_tilefilter_exact``)."""

from harness import spans


def read(run):
    return spans.idle_ms_per_frame(run, "cwipc.exact")
