"""Kernel 5: cross-cloud nearest neighbour over the (y, z) column grid.

Replaces cwipc_util_tpu/ops/pallas_nn.py (``_nn_kernel``, its pallas_call
at :246, wrapper ``nn_select_pallas`` :171).  On CUDA tensors
:func:`nn_select` launches ``csrc/nn_select.cu``; on CPU tensors it runs
:func:`nn_select_plain`, the plain PyTorch version and the spec.

Inputs are the padded coordinate planes that ``cols_knn._cols_build``
makes for a REFERENCE cloud ([prows_r, cap_r]) and a QUERY cloud
([prows_q, cap_q]) on the same grid (same gy, gz, cell and origin).  Both
carry ``halo(gz)`` rows of F32_MAX in front, so column p of either plane is
row ``halo(gz) + p``.  For every query slot (p, s) of the gy*gz columns:

* the minimum squared distance ((dx*dx + dy*dy) + dz*dz), dx = c - q,
  over the reference slots of the 77-column ring around p (the 9x9 columns
  minus their 4 corners, in dy-major, dz-minor order), and
* its candidate id ``ring_index * ceil8(cap_r) + slot_row``, the smallest
  id among equal squared distances.

The port's rule for empty cases, the same in the kernel and here: an empty
query slot (x >= F32_MAX / 2), and a query whose ring holds no reference
point, read (F32_MAX, INT32_MAX).  (The TPU kernel leaves some empty query
slots at d2 0 with an arbitrary id, and an all-empty ring at F32_MAX with
id 0; ``knn.nn_grid_query`` turns each of these into "no correspondence"
either way.)  Kernel and plain version agree bit for bit: d2 is rounded
op by op in both, with no FMA contraction.

Bound on the H100: neither bytes nor operations (both a few µs at the
registration flow's shapes).  The kernel stages the union of the rings of
a strip of STRIP query columns once per block (9 rows of STRIP + 8
columns) and spreads the strip's query slots over the block's threads;
its host side, :func:`strip_plan`, sizes the stage so that every cap
fits the default 48 KB of shared memory, with passes over rings denser
than that.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import _kernels
from ..core.errors import CwipcError
from .cols_knn import _M, halo
from .outliers import F32_MAX

INT32_MAX = 2**31 - 1
RING = [
    (dy, dz)
    for dy in range(-_M, _M + 1)
    for dz in range(-_M, _M + 1)
    if max(abs(dy) - 1, 0) ** 2 + max(abs(dz) - 1, 0) ** 2 < _M * _M
]  # 77 columns: the 9x9 ring minus its 4 corners
MAX_CAP = 1024  # query slots per column the kernel takes
STRIP = 8  # query columns per block (nn_select.cu)
THREADS = 512  # per block: the strip's query slots spread over them
UNION_COLS = (2 * _M + 1) * (STRIP + 2 * _M)  # the strip's ring union: 9 rows of STRIP + 8 columns
STAGE_MAX = 2048  # candidates staged per pass, 16 bytes each
SMEM_LIMIT = 48 * 1024  # shared memory a block takes without cudaFuncAttributeMaxDynamicSharedMemorySize
_PLAIN_BUDGET = 1 << 24  # elements of the plain version's distance tensor per chunk


def ring_offsets(gz: int) -> list[int]:
    """Plane-row offsets of the ring columns, in candidate-id order."""
    return [dy * gz + dz for dy, dz in RING]


@dataclass(frozen=True)
class StripPlan:
    """The launch nn_select.cu gets for one (cap_r, cap_q)."""

    threads: int  # per block
    stage: int  # candidates staged per pass
    max_passes: int  # passes when every union slot is occupied
    smem_bytes: int  # the stage (dynamic) and the bounds, offsets and warp sums (static)


@functools.lru_cache(maxsize=256)
def strip_plan(cap_r: int, cap_q: int) -> StripPlan:
    """Stage as many candidates as the strip's ring union can hold, up to
    STAGE_MAX; denser rings take passes."""
    if not (1 <= cap_r and 1 <= cap_q <= MAX_CAP):
        raise CwipcError(f"strip_plan: caps ({cap_r}, {cap_q}) outside [1, inf) x [1, {MAX_CAP}]")
    stage = min(STAGE_MAX, UNION_COLS * cap_r)
    # static: bounds and offsets of the union columns, warp sums, query
    # counts and offsets of the strip's columns, rounded up to 16 bytes
    static = -(-4 * (2 * UNION_COLS + 1 + THREADS // 32 + 2 * STRIP + 1) // 16) * 16
    return StripPlan(threads=THREADS, stage=stage, max_passes=-(-UNION_COLS * cap_r // stage),
                     smem_bytes=16 * stage + static)


def _occupied_bound(plane: torch.Tensor) -> int:
    """One past the last slot index that holds a point in any row."""
    used = torch.nonzero((plane < F32_MAX / 2).any(dim=0))
    return int(used[-1]) + 1 if used.numel() else 0


def nn_select_plain(r_xs, r_ys, r_zs, q_xs, q_ys, q_zs, *, gy, gz, cap_r, cap_q):
    """Plain PyTorch version of kernel 5 (any device).  Returns (d2 f32,
    cid int32), [gy*gz, cap_q].

    Only the query columns that hold a point are searched (the others read
    (F32_MAX, INT32_MAX) by the rule), in chunks whose [chunk, cap_q,
    77 * cap_r] distance tensor stays under ``_PLAIN_BUDGET`` elements, and slot
    ranges that are empty in every column are left out of the distance
    tensor (they can neither hold a query nor a candidate).  Reading the
    occupied columns and bounds syncs with the host."""
    gyz = gy * gz
    off = halo(gz)
    dev = r_xs.device
    capp_r = -(-cap_r // 8) * 8
    d2_out = torch.full((gyz, cap_q), F32_MAX, dtype=torch.float32, device=dev)
    cid_out = torch.full((gyz, cap_q), INT32_MAX, dtype=torch.int32, device=dev)
    q_planes = [a[off:off + gyz] for a in (q_xs, q_ys, q_zs)]
    cols = torch.nonzero((q_planes[0] < F32_MAX / 2).any(dim=1)).squeeze(1)
    nq = _occupied_bound(q_planes[0])
    nr = _occupied_bound(r_xs)
    if cols.numel() == 0 or nr == 0:
        return d2_out, cid_out
    offs = torch.tensor(ring_offsets(gz), dtype=torch.long, device=dev)
    cand_id = (torch.arange(len(RING), dtype=torch.int32, device=dev)[:, None] * capp_r
               + torch.arange(nr, dtype=torch.int32, device=dev)[None, :]).reshape(-1)
    chunk = max(1, _PLAIN_BUDGET // (nq * len(RING) * nr))
    for c0 in range(0, cols.numel(), chunk):
        cc = cols[c0:c0 + chunk]
        n = cc.numel()
        q = [a[cc, :nq, None] for a in q_planes]  # [n, nq, 1]
        rows = off + cc[:, None] + offs[None, :]  # [n, 77]
        c = [a[rows, :nr].reshape(n, 1, -1) for a in (r_xs, r_ys, r_zs)]  # [n, 1, 77 * nr]
        dx, dy, dz = (ca - qa for ca, qa in zip(c, q))
        d2 = dx * dx + dy * dy + dz * dz  # ((dx² + dy²) + dz²), op by op
        d2 = torch.where(c[0] < F32_MAX / 2, d2, torch.inf)
        m = d2.amin(dim=-1)
        cid = torch.where(d2 == m[..., None], cand_id, INT32_MAX).amin(dim=-1)
        hit = torch.isfinite(m) & (q[0][..., 0] < F32_MAX / 2)
        d2_out[cc, :nq] = torch.where(hit, m, F32_MAX)
        cid_out[cc, :nq] = torch.where(hit, cid, INT32_MAX)
    return d2_out, cid_out


def nn_select(r_xs, r_ys, r_zs, q_xs, q_ys, q_zs, *, gy, gz, cap_r, cap_q):
    """(d2 f32, cid int32) [gy*gz, cap_q] per query slot: the minimum
    squared distance over the reference ring and its candidate id (see the
    module docstring for the contract)."""
    what = "nn_select"
    gyz = gy * gz
    off = halo(gz)
    for name, t, cap in (("r_xs", r_xs, cap_r), ("r_ys", r_ys, cap_r), ("r_zs", r_zs, cap_r),
                         ("q_xs", q_xs, cap_q), ("q_ys", q_ys, cap_q), ("q_zs", q_zs, cap_q)):
        prows = r_xs.shape[0] if name[0] == "r" else q_xs.shape[0]
        _kernels.expect(what, name, t, torch.float32, (prows, cap))
        if prows < gyz + 2 * off:
            raise CwipcError(f"{what}: {name} has {prows} rows, need gy*gz + 2*off = {gyz + 2 * off}")
    if not (1 <= cap_r and 1 <= cap_q <= MAX_CAP):
        raise CwipcError(f"{what}: caps ({cap_r}, {cap_q}) outside [1, inf) x [1, {MAX_CAP}]")
    if _kernels.route(what, r_xs, r_ys, r_zs, q_xs, q_ys, q_zs) == "cpu":
        return nn_select_plain(r_xs, r_ys, r_zs, q_xs, q_ys, q_zs, gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q)
    d2 = torch.empty((gyz, cap_q), dtype=torch.float32, device=r_xs.device)
    cid = torch.empty((gyz, cap_q), dtype=torch.int32, device=r_xs.device)
    if gyz == 0:  # nothing to launch
        return d2, cid
    lib = _kernels.load()
    with _kernels.device_guard(r_xs):
        err = lib.cwipc_nn_select(
            r_xs.data_ptr(), r_ys.data_ptr(), r_zs.data_ptr(), q_xs.data_ptr(), q_ys.data_ptr(), q_zs.data_ptr(),
            cap_r, cap_q, gz, gyz, strip_plan(cap_r, cap_q).stage, d2.data_ptr(), cid.data_ptr(),
            _kernels.stream(r_xs),
        )
    _kernels.check(lib, err, what)
    nn_select.launches += 1
    return d2, cid


nn_select.launches = 0
