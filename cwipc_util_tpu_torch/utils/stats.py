"""The statistics() protocol: per-stage counters printed at exit.

Copied from cwipc_util_tpu/utils/stats.py.

Every source/sink/filter in the reference accumulates per-frame durations,
sizes and bandwidths and prints count/avg/min/max on request (the
``print1stat`` pattern, reference: python/cwipc/net/source_netclient.py:181-199
and ~10 sibling modules).  This module centralizes it instead of
copy-pasting the helper into every class.
"""

from __future__ import annotations

import time
from typing import Dict, List, Union


def print1stat(component: str, name: str, values: Union[List[int], List[float]], isInt: bool = False) -> None:
    count = len(values)
    if count == 0:
        print(f"{component}: {name}: count=0")
        return
    minValue = min(values)
    maxValue = max(values)
    avgValue = sum(values) / count
    if isInt:
        fmt = "{}: {}: count={}, average={:.3f}, min={:d}, max={:d}"
    else:
        fmt = "{}: {}: count={}, average={:.3f}, min={:.3f}, max={:.3f}"
    print(fmt.format(component, name, count, avgValue, minValue, maxValue))


class Stats:
    """Accumulates named per-frame series and prints them on statistics()."""

    def __init__(self, component: str):
        self.component = component
        self.series: Dict[str, List[float]] = {}
        self.int_series: Dict[str, bool] = {}

    def add(self, name: str, value: float, isInt: bool = False) -> None:
        self.series.setdefault(name, []).append(value)
        self.int_series[name] = isInt

    def print(self) -> None:
        for name, values in self.series.items():
            print1stat(self.component, name, values, self.int_series.get(name, False))


class Timer:
    """Context manager measuring a stage duration into a Stats series."""

    def __init__(self, stats: Stats, name: str = "duration"):
        self.stats = stats
        self.name = name

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.stats.add(self.name, time.time() - self._t0)
