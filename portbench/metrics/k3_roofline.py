"""Kernel 3 (csrc/compact.cu): its share of its roofline, the work of
harness/work.py's k3_compact over the traced frames against the device
time of its launch (the memset before it is not counted)."""

from harness import work
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, ("compact_lookback",), work.k3_compact, "fp32_flops_per_s")
