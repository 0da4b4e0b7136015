"""Kernel 1 (csrc/segment_reduce.cu): its share of its roofline, the work
of harness/work.py's k1_segment_reduce over the traced frames against the
device time of its launch (the memset before it is not counted)."""

from harness import work
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, ("segment_reduce_lookback",), work.k1_segment_reduce, "fp32_flops_per_s")
