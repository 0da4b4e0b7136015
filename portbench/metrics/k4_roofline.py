"""Kernel 4 (csrc/cols_select.cu): its share of its roofline, the work of
harness/work.py's k4_select over the traced frames against the device
time of both its launches (column bounds and the strip selection)."""

from harness import work
from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, ("column_bounds", "cols_select_strip"), work.k4_select, "fp32_flops_per_s")
