"""Device idle ms a traced frame while the host was inside the program's
``cwipc.downsample`` span and no deeper one: the Morton key, the sort,
kernel 1's host call and the runs' rebuild (ops/voxelize.py
``downsample_cm``)."""

from harness import spans


def read(run):
    return spans.idle_ms_per_frame(run, "cwipc.downsample")
