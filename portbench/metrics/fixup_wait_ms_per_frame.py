"""Host ms a traced frame in runtime synchronizes and blocking copies that
start inside the program's ``cwipc.fixup`` span (ops/cols_knn.py
``bruteforce_md_subset``): the trip count's read, which waits for kernel 4
to end."""

from harness import spans
from harness.readers import SYNC_CALLS


def read(run):
    return spans.host_ms_per_frame(run, "cwipc.fixup", SYNC_CALLS)
