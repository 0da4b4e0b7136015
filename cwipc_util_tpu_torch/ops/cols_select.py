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

Bound on the H100: neither bytes nor operations; a ring kernel is bound
by how often it restages the same columns and by the latency of its
loads.  A first launch finds every column's occupancy bound; then a block
stages the ring union of a strip of STRIP query columns once and spreads
the strip's query slots over its threads, each query selecting by a
bisection that snaps to the d2 values that occur (see the source).  Its
host side, :func:`select_plan`, sizes the stage so that every cap fits
the default 48 KB of shared memory, with passes over unions denser than
that.
A row range ``[row0, row0 + nrows)`` takes the place of the TPU kernel's
``tile0``/``ntiles_run``, for a caller that splits the plane.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import _kernels
from ..core.errors import CwipcError
from .cols_knn import _M, _cols_select, halo
from .outliers import F32_MAX

STRIP = 8  # query columns per block (cols_select.cu)
THREADS = 256  # per block: the strip's query slots spread over them
UNION_COLS = (2 * _M + 1) * (STRIP + 2 * _M)  # the strip's ring union: 9 rows of STRIP + 8 columns
STAGE_MAX = 2048  # candidates staged per pass, 16 bytes each
SMEM_LIMIT = 48 * 1024  # shared memory a block takes without cudaFuncAttributeMaxDynamicSharedMemorySize
PROF_WORDS = 8  # the profile the launches add to (cols_select.cu)
PROF_FIELDS = ("bounds cycles", "union scan cycles", "staging cycles", "selection cycles", "blocks",
               "scans", "queries", "blocks with passes")


@dataclass(frozen=True)
class SelectPlan:
    """The launch cols_select.cu gets for one cap."""

    threads: int  # per block
    stage: int  # candidates staged per pass
    max_passes: int  # passes when every union slot is occupied
    smem_bytes: int  # the stage (dynamic) and the union offsets, warp sums and query offsets (static)


@functools.lru_cache(maxsize=256)
def select_plan(cap: int) -> SelectPlan:
    """Stage as many candidates as the strip's ring union can hold, up to
    STAGE_MAX; denser unions take passes."""
    if cap < 1:
        raise CwipcError(f"select_plan: cap {cap} < 1")
    stage = min(STAGE_MAX, UNION_COLS * cap)
    # static: the union's staging offsets, warp sums and the strip's query
    # offsets, rounded up to 16 bytes
    static = -(-4 * (UNION_COLS + 1 + THREADS // 32 + STRIP + 1) // 16) * 16
    return SelectPlan(threads=THREADS, stage=stage, max_passes=-(-UNION_COLS * cap // stage),
                      smem_bytes=16 * stage + static)


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
                voxel_unique=False, prof=None):
    """(sums, kth) f32 [nrows, cap] for the columns [row0, row0 + nrows)
    of the padded planes [prows, cap] from ``cols_knn._cols_build``
    (default: the whole [gy*gz, cap] plane).  ``chunk`` and
    ``voxel_unique`` shape the plain version's work only.  ``prof``, an
    int64 [PROF_WORDS] on the planes' CUDA device, receives the kernel's
    phase profile (PROF_FIELDS) added to what it holds."""
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
    if prof is not None:
        _kernels.expect(what, "prof", prof, torch.int64, (PROF_WORDS,))
        _kernels.route(what, xs_g, prof)
    # one allocation: sums, kth, then the column bounds (int32 scratch)
    nb = nrows + 2 * off
    work = torch.empty(2 * nrows * cap + nb, dtype=torch.float32, device=xs_g.device)
    sums, kth = work[:2 * nrows * cap].view(2, nrows, cap).unbind(0)
    if nrows == 0:  # nothing to launch
        return sums, kth
    lib = _kernels.load()
    with _kernels.device_guard(xs_g):
        err = lib.cwipc_cols_select(
            xs_g.data_ptr(), ys_g.data_ptr(), zs_g.data_ptr(), cap, gz, k, row0, nrows,
            select_plan(cap).stage, work[2 * nrows * cap:].data_ptr(), sums.data_ptr(), kth.data_ptr(),
            None if prof is None else prof.data_ptr(), _kernels.stream(xs_g),
        )
    _kernels.check(lib, err, what)
    cols_select.launches += 1
    return sums, kth


cols_select.launches = 0
