"""The 95th percentile, over every frame of the window, of the host-clock
time from the call into the chain to the synchronize that ends it."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
