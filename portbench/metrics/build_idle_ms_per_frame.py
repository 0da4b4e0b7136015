"""Device idle ms a traced frame while the host was inside the program's
``cwipc.grid_build`` span: the column grid's stable sort, scatters,
``cummax`` and drop dilation (ops/cols_knn.py ``_cols_build``)."""

from harness import spans


def read(run):
    return spans.idle_ms_per_frame(run, "cwipc.grid_build")
