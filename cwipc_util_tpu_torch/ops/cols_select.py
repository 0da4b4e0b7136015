"""Kernel 4: exact k-NN selection over the (y, z) column grid.

Replaces cwipc_util_tpu/ops/pallas_cols_select.py (``_select_kernel``, its
pallas_call at :502, wrapper ``cols_select_pallas`` :403).  On CUDA tensors
:func:`cols_select` launches ``csrc/cols_select.cu``; on CPU tensors it
runs :func:`cols_select_plain`, the plain PyTorch version
(``cols_knn._cols_select``, the JAX module's XLA formulation).

Contract (the one tests/test_pallas.py holds the TPU kernel to): on every
occupied slot the covered/uncovered classification (kth < 4 * cell) is
the plain version's; where covered, kth is bit-equal and the sum allclose
(rtol 1e-5: only the order of summation differs).  The kernel scans the
77-column ring (the 9x9 ring minus its corners), the plain version all 81
columns; corners lie beyond the 4-cell radius a covered query uses.

Bound on the H100: most likely latency, not memory or instruction count;
see the source.
A row range ``[row0, row0 + nrows)`` takes the place of the TPU kernel's
``tile0``/``ntiles_run``, for a caller that splits the plane.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..core.errors import CwipcError
from .cols_knn import _cols_select, halo
from .outliers import F32_MAX


def cols_select_plain(xs_g, ys_g, zs_g, *, k, gy, gz, cap, row0=0, nrows=None,
                      chunk=256, voxel_unique=False):
    """Plain PyTorch version of kernel 4 (any device): ``_cols_select`` over
    the chunks that cover the row range, one chunk at a time.  Planes too
    short for the last chunk are padded with empty rows."""
    gyz = gy * gz
    nrows = gyz - row0 if nrows is None else nrows
    off = halo(gz)
    c0s = range(row0, row0 + nrows, chunk)
    need = row0 + len(c0s) * chunk + 2 * off
    if need > xs_g.shape[0]:
        pad = xs_g.new_full((need - xs_g.shape[0], cap), F32_MAX)
        xs_g, ys_g, zs_g = (torch.cat([a, pad]) for a in (xs_g, ys_g, zs_g))
    sums, kths = _cols_select(xs_g, ys_g, zs_g, c0s, k=k, gy=gy, gz=gz, cap=cap, chunk=chunk,
                              voxel_unique=voxel_unique)
    return sums.reshape(-1, cap)[:nrows], kths.reshape(-1, cap)[:nrows]


def cols_select(xs_g, ys_g, zs_g, *, k, gy, gz, cap, row0=0, nrows=None, chunk=256,
                voxel_unique=False):
    """(sums, kth) f32 [nrows, cap] for the columns [row0, row0 + nrows)
    of the padded planes [prows, cap] from ``cols_knn._cols_build``
    (default: the whole [gy*gz, cap] plane).  ``chunk`` and
    ``voxel_unique`` shape the plain version's work only."""
    what = "cols_select"
    gyz = gy * gz
    nrows = gyz - row0 if nrows is None else nrows
    prows = xs_g.shape[0]
    for name, t in (("xs_g", xs_g), ("ys_g", ys_g), ("zs_g", zs_g)):
        _kernels.expect(what, name, t, torch.float32, (prows, cap))
    off = halo(gz)
    if prows < gyz + 2 * off:
        raise CwipcError(f"{what}: planes of {prows} rows, need gy*gz + 2*off = {gyz + 2 * off}")
    if not (0 <= row0 and 0 <= nrows and row0 + nrows <= gyz):
        raise CwipcError(f"{what}: row range [{row0}, {row0 + nrows}) outside [0, {gyz})")
    if k < 1:
        raise CwipcError(f"{what}: need k >= 1, got {k}")
    if _kernels.route(what, xs_g, ys_g, zs_g) == "cpu":
        return cols_select_plain(xs_g, ys_g, zs_g, k=k, gy=gy, gz=gz, cap=cap, row0=row0,
                                 nrows=nrows, chunk=chunk, voxel_unique=voxel_unique)
    sums = torch.empty((nrows, cap), dtype=torch.float32, device=xs_g.device)
    kth = torch.empty_like(sums)
    if nrows == 0:  # nothing to launch
        return sums, kth
    lib = _kernels.load()
    P = _kernels.ptr
    with torch.cuda.device(xs_g.device):
        err = lib.cwipc_cols_select(
            P(xs_g), P(ys_g), P(zs_g), cap, gz, k, row0, nrows, P(sums), P(kth), _kernels.stream(xs_g)
        )
    _kernels.check(lib, err, what)
    cols_select.launches += 1
    return sums, kth


cols_select.launches = 0
