"""A profiling probe of kernel 4's earlier design, one block per query
column (``csrc/cols_select_probe.cu``).

It is on no path.  ``chip_smoke.py`` runs it on the bench planes beside
kernel 4 (``ops/cols_select.py``, the strip design that replaced it),
holds its result to kernel 4's contract and prints the share of block
cycles each of its phases took.  It runs on the card only: its result is
kernel 4's, whose plain version serves the CPU.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..core.errors import CwipcError
from .cols_knn import halo

MAX_CAP = 160  # one warp's staged ring and d2 buffer fit in 227 KB
PROF_FIELDS = ("occupancy cycles", "prefix cycles", "staging cycles", "selection cycles", "blocks")


def column_probe(xs_g, ys_g, zs_g, *, k, gy, gz, cap, prof):
    """(sums, kth) f32 [gy*gz, cap], as ``cols_select`` computes them, by the
    earlier design; ``prof``, an int64 [5] on the planes' device, receives
    its phase profile (PROF_FIELDS) added to what it holds."""
    what = "column_probe"
    gyz = gy * gz
    prows = xs_g.shape[0]
    for name, t in (("xs_g", xs_g), ("ys_g", ys_g), ("zs_g", zs_g)):
        _kernels.expect(what, name, t, torch.float32, (prows, cap))
    _kernels.expect(what, "prof", prof, torch.int64, (len(PROF_FIELDS),))
    if prows < gyz + 2 * halo(gz):
        raise CwipcError(f"{what}: planes of {prows} rows, need gy*gz + 2*off = {gyz + 2 * halo(gz)}")
    if _kernels.route(what, xs_g, ys_g, zs_g, prof) != "cuda":
        raise CwipcError(f"{what}: a probe of the card, for CUDA tensors only")
    sums, kth = torch.empty((2, gyz, cap), dtype=torch.float32, device=xs_g.device).unbind(0)
    lib = _kernels.load()
    with _kernels.device_guard(xs_g):
        err = lib.cwipc_cols_select_column_probe(
            xs_g.data_ptr(), ys_g.data_ptr(), zs_g.data_ptr(), cap, gz, k, 0, gyz, sums.data_ptr(),
            kth.data_ptr(), prof.data_ptr(), _kernels.stream(xs_g),
        )
    _kernels.check(lib, err, what)
    return sums, kth
