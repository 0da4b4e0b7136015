"""The judge of the exact cleaning chain (``downsample_outliers_tilefilter_exact``).

Each frame held is run through the plain reference
(``reference/exact_chain.py``, float64) at the configuration's chain and
the traffic's slab; the frame's sampled output, where there is one, is
compared with it by the four numbers of ``reference/judge.py``, whose
``LIMITS`` are this judge's.  The work counts are ``work.frame_counts``
of the reference's voxels.
"""

from __future__ import annotations

from harness import work
from reference import exact_chain, judge as compare

LIMITS = compare.LIMITS


def judge(held, outputs, cfg, traffic, want_counts: bool):
    """Check each frame's sampled output against the reference; returns
    (worst numbers, frames failed, work counts per frame held)."""
    chain = cfg["chain"]
    readings, counts, failed = [], [], 0
    for f, (xyz, rgba, count) in enumerate(held):
        n = int(count)
        ref = exact_chain.run(xyz, rgba, n, cellsize=chain["cellsize"], k=chain["k"], mult=chain["mult"],
                              tile=chain["tile"], slab=traffic["slab_cells"] * chain["cellsize"])
        if want_counts:
            counts.append(work.frame_counts(ref, chain, n))
        out = outputs.get(f)
        if out is not None:
            r = compare.judge_frame(ref, out.xyz, out.rgba, int(out.count), chain["cellsize"])
            readings.append(r)
            failed += not compare.verdict(r)
        del ref
    return (compare.worst(readings) if readings else None), failed, counts
