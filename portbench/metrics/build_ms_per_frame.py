"""Device ms a traced frame of the kernels launched inside the program's
``cwipc.grid_build`` span (ops/cols_knn.py ``_cols_build``), found through
the launches' correlation ids."""

from harness import spans


def read(run):
    return spans.kernel_ms_per_frame(run, "cwipc.grid_build")
