"""EXACT k-NN mean distance for voxel-unique clouds: the column grid.

The port of cwipc_util_tpu/ops/cols_knn.py (see its docstring for the
design and the coverage argument).  In short:

1. quantize to the ``cell`` grid and key every point by its (y, z) column;
   rank points within a column by x (one stable sort);
2. scatter into a dense [gy*gz, cap] slot grid, padded with ``off`` rows
   of F32_MAX on both sides so every ring read stays in bounds;
3. candidates for a query are the slots of the 9x9 ring of columns;
   kernel 4 (ops/cols_select.py) selects the k smallest squared distances
   exactly; ``_cols_select`` here is its plain version;
4. gather the per-slot results back to the caller's point order.

A point whose k-th neighbour is not strictly inside 4*cell (or that has
fewer than k candidates, or lost a candidate to a column-cap or extent
drop) is UNCOVERED; the caller recomputes it with
:func:`bruteforce_md_subset`.

Differences from the JAX module, none of which changes a result:

* the sort is ``torch.sort(stable=True)`` on the int32 key, with the
  payloads gathered through its permutation (the JAX module packs them
  into complex operands of ``lax.sort``).  Keys are unique on a
  voxel-unique cloud, so planes and ``point_slot`` are bit-equal there;
* the drop flags and their 2*_M box dilation are computed always, not
  behind a ``lax.cond`` on ``any(drops)``: nothing branches on device
  data, and the result is the same (all False without drops);
* the per-chunk selection is a Python loop over chunks (``lax.map``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import span
from .outliers import F32_MAX, _knn_sum_rows

SENTINEL = 2**31 - 1
_M = 4  # ring radius in cells; guarantees coverage of balls < _M*cell


def _f32(v) -> float:
    return float(np.float32(v))


def _k_smallest_sum(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of sqrt of the k smallest entries along the last axis, and the
    k-th smallest distance itself.  d2: [..., C] with invalid = F32_MAX."""
    small = torch.topk(d2, k, dim=-1, largest=False).values  # ascending
    found = small < F32_MAX / 2
    dist = torch.where(found, torch.sqrt(torch.clamp_min(small, 0.0)), 0.0)
    kth = torch.sqrt(torch.clamp_min(small[..., -1], 0.0))
    kth = torch.where(found[..., -1], kth, F32_MAX)
    return dist.sum(-1), kth


def halo(gz: int) -> int:
    """Rows of F32_MAX padding on each side of the [gy*gz, cap] plane: the
    farthest ring column, (4, 4) columns away, is this many rows off."""
    return _M * gz + _M


def plane_rows(gy: int, gz: int, chunk: int) -> int:
    """The padded plane's row count for selection chunks of ``chunk``."""
    return halo(gz) + -(-gy * gz // chunk) * chunk + halo(gz)


def _cols_build(xyz, count, cell, *, gy, gz, cap, chunk, vmin_override=None, want_orig=True):
    """Phase 1: slot-grid construction.

    Returns (xs_g, ys_g, zs_g, slot_orig, valid, drop_ring, point_slot),
    the JAX module's order: the padded [prows, cap] coordinate planes
    (F32_MAX in empty slots), the slot -> point map [gy*gz*cap] (-1 in
    empty slots; None with ``want_orig=False``: only the NN callers in
    ops/knn.py read it), the valid mask, the per-column "a dropped point is
    within reach" flags [gy*gz] and the point -> slot map (gy*gz*cap for
    dropped points).

    ``vmin_override`` ([3] int, absolute cell coordinates) anchors the grid
    explicitly; points below it, or beyond the extents, are out of grid and
    reported uncovered."""
    n = xyz.shape[0]
    dev = xyz.device
    assert gy * gz <= 1_000_000, "column plane too large for the int32 sort key"
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    valid = idx < count
    inv = _f32(np.float32(1.0) / np.float32(cell))

    v = torch.floor(xyz * inv).to(torch.int32)
    if vmin_override is None:
        vmin = torch.where(valid[:, None], v, SENTINEL).amin(dim=0)
        vmin = torch.where(vmin == SENTINEL, 0, vmin)
    else:
        vmin = torch.as_tensor(vmin_override, dtype=torch.int32, device=dev)
    vr = v - vmin[None, :]
    in_grid = valid & (vr[:, 1] >= 0) & (vr[:, 1] < gy) & (vr[:, 2] >= 0) & (vr[:, 2] < gz)
    gyz = gy * gz
    ck = torch.where(in_grid, vr[:, 1] * gz + vr[:, 2], gyz)  # overflow column

    # rank within column by x-cell: sort by (ck, vx); rank = i - run_start
    sort_key = ck * 2048 + torch.clamp(vr[:, 0], 0, 2047)
    sort_key = torch.where(in_grid, sort_key, SENTINEL)
    skey, perm = torch.sort(sort_key, stable=True)
    sck = ck[perm]
    sidx = perm.to(torch.int32)
    si = torch.arange(n, dtype=torch.int32, device=dev)
    new_col = (si == 0) | (sck != torch.roll(sck, 1))
    run_start = torch.cummax(torch.where(new_col, si, 0), dim=0).values
    rank = si - run_start
    fits = (skey < SENTINEL) & (rank < cap)
    slots = gyz * cap
    addr = torch.where(fits, sck * cap + rank, slots)  # dropped -> sink

    # the planes, scattered straight into their padded layout
    off, prows = halo(gz), plane_rows(gy, gz, chunk)
    addr_p = torch.where(fits, addr + off * cap, prows * cap).long()
    sxyz = xyz[perm]

    def fill_padded(vals):
        base = torch.full((prows * cap + 1,), F32_MAX, dtype=torch.float32, device=dev)
        base[addr_p] = torch.where(fits, vals, F32_MAX)
        return base[: prows * cap].reshape(prows, cap)

    xs_g, ys_g, zs_g = (fill_padded(sxyz[:, a]) for a in range(3))

    # inverse map point -> slot: the finish phase gathers per point
    point_slot = torch.full((n + 1,), slots, dtype=torch.int32, device=dev)
    point_slot[torch.where(fits, sidx, n).long()] = torch.where(fits, addr, slots)
    point_slot = point_slot[:n]

    slot_orig = None
    if want_orig:
        slot_orig = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
        slot_orig[addr.long()] = torch.where(fits, sidx, -1)
        slot_orig = slot_orig[:slots]

    # A DROPPED point (column capacity or grid-extent overflow) is absent
    # from its neighbours' candidate sets, so every query within reach of
    # a drop is recomputed.  Rank overflows flag their true column; extent
    # overflows their nearest border column; dilating by 2*_M covers the
    # ring radius and the clamp displacement (the roll's wrap only ever
    # over-marks).
    rank_drop = (skey < SENTINEL) & (rank >= cap)
    ext_drop = valid & ~in_grid
    rank_addr = torch.where(rank_drop, sck, gyz)
    vy_c = torch.clamp(vr[:, 1], 0, gy - 1)
    vz_c = torch.clamp(vr[:, 2], 0, gz - 1)
    ext_addr = torch.where(ext_drop, vy_c * gz + vz_c, gyz)
    flag = torch.zeros((gyz + 1,), dtype=torch.bool, device=dev)
    flag[torch.cat([rank_addr, ext_addr]).long()] = True
    # separable box dilation by exactly 2*_M per axis, each pass rolling
    # the pre-dilation base
    base = flag[:gyz].reshape(gy, gz)
    f = base
    for j in range(1, 2 * _M + 1):
        f = f | torch.roll(base, j, 0) | torch.roll(base, -j, 0)
    base = f
    for j in range(1, 2 * _M + 1):
        f = f | torch.roll(base, j, 1) | torch.roll(base, -j, 1)
    drop_ring = f.reshape(gyz)
    return xs_g, ys_g, zs_g, slot_orig, valid, drop_ring, point_slot


def _cols_select(xs_g, ys_g, zs_g, c0s, *, k, gy, gz, cap, chunk, voxel_unique):
    """Phase 2, the plain version of kernel 4: per-chunk candidate
    distances over the full 81-column ring and exact selection, for the
    plane chunks whose start rows are ``c0s``.  Returns (sums, kths)
    stacked per chunk, [len(c0s), chunk, cap] each."""
    off = halo(gz)
    ncols = (2 * _M + 1) ** 2
    dev = xs_g.device
    qslot = torch.arange(cap, device=dev)
    self_col = torch.arange(ncols, device=dev) == ncols // 2
    # [cap_q, 81, cap_c]: the query's own slot in the centre column
    is_self = self_col[None, :, None] & (qslot[:, None, None] == qslot[None, None, :])
    keep_per_col = min(9, cap) if voxel_unique else cap
    sums, kths = [], []
    for c0 in (int(c) for c in c0s):
        qx, qy, qz = (a[c0 + off:c0 + off + chunk] for a in (xs_g, ys_g, zs_g))  # [chunk, cap]
        rows = [c0 + off + dy * gz + dz for dy in range(-_M, _M + 1) for dz in range(-_M, _M + 1)]
        cx, cy, cz = (torch.stack([a[r:r + chunk] for r in rows], dim=1) for a in (xs_g, ys_g, zs_g))
        # [chunk, cap_q, 81, cap_c] distances by broadcasting, ((dx² + dy²) + dz²)
        dx = qx[:, :, None, None] - cx[:, None, :, :]
        dy = qy[:, :, None, None] - cy[:, None, :, :]
        dz = qz[:, :, None, None] - cz[:, None, :, :]
        d2 = dx * dx + dy * dy + dz * dz
        bad = (cx >= F32_MAX / 2)[:, None, :, :] | (qx >= F32_MAX / 2)[:, :, None, None]
        d2 = torch.where(bad | is_self[None], F32_MAX, d2)
        # Two-stage exact selection: top-9 per candidate column is exact on
        # a voxel-unique cloud (at most 9 distinct x-cells of a column lie
        # within |dx| < 4*cell of any query), then top-k over the survivors.
        if keep_per_col < cap:
            survivors = torch.topk(d2, keep_per_col, dim=-1, largest=False).values
            survivors = survivors.reshape(chunk * cap, ncols * keep_per_col)
        else:
            survivors = d2.reshape(chunk * cap, ncols * cap)
        ssum, kth = _k_smallest_sum(survivors, k)
        sums.append(ssum.reshape(chunk, cap))
        kths.append(kth.reshape(chunk, cap))
    return torch.stack(sums), torch.stack(kths)


def _cols_finish(sums, kths, point_slot, valid, drop_ring, cell, *, k, gy, gz, cap):
    """Phase 3: slot results back to the caller's point order, by a
    per-point gather through the build's inverse map.  ``sums``/``kths``
    are [gy*gz, cap]; returns (md, uncovered) per point."""
    gyz = gy * gz
    slots = gyz * cap
    r_cut = _f32(np.float32(_M) * np.float32(cell) * np.float32(1.0 - 1e-6))
    sums = sums.reshape(slots)
    # queries whose ring lost a dropped candidate are not trustworthy:
    # kth = F32_MAX fails the covered test
    kths = torch.where(drop_ring[:, None], F32_MAX, kths.reshape(gyz, cap)).reshape(slots)
    has_slot = point_slot < slots
    ps = torch.clamp_max(point_slot, slots - 1).long()
    md = torch.where(has_slot, sums[ps] / float(k), 0.0)
    covered = kths[ps] < r_cut
    unc = valid & ~(has_slot & covered)
    return torch.where(valid & has_slot, md, 0.0), unc


def cols_knn_mean_distance(
    xyz: torch.Tensor,
    count: torch.Tensor,
    cell: float,
    k: int,
    gy: int,
    gz: int,
    cap: int,
    chunk: int = 256,
    voxel_unique: bool = False,
    vmin_override=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact mean k-NN distance over the column grid.

    Returns (md, uncovered): md [N] is exact for every point where
    uncovered is False; uncovered entries must be fixed up by the caller.
    Requirements as in the JAX module: the rebased y/z extents fit
    (gy, gz) and no column holds more than ``cap`` points (violations are
    reported through ``uncovered``).  ``voxel_unique`` enables the plain
    version's per-column pre-selection."""
    from .cols_select import cols_select  # cols_select imports this module

    with span("cwipc.grid_build"):
        xs_g, ys_g, zs_g, _, valid, drop_ring, point_slot = _cols_build(
            xyz, count, cell, gy=gy, gz=gz, cap=cap, chunk=chunk, vmin_override=vmin_override,
            want_orig=False,
        )
    sums, kths = cols_select(
        xs_g, ys_g, zs_g, k=k, gy=gy, gz=gz, cap=cap, chunk=chunk, voxel_unique=voxel_unique,
    )
    return _cols_finish(sums, kths, point_slot, valid, drop_ring, cell, k=k, gy=gy, gz=gz, cap=cap)


def bruteforce_md_subset(xyz: torch.Tensor, count: torch.Tensor, sel: torch.Tensor, k: int, block: int = 128) -> torch.Tensor:
    """Exact md for the selected points only, by brute force over blocks of
    ``block`` selected rows.  Output is 0 for non-selected rows.

    The number of selected points sets the trip count, so it is read on
    the host: this is the exact chain's one device-to-host sync (the JAX
    module keeps it on the device with a dynamic-trip-count fori_loop)."""
    with span("cwipc.fixup"):
        cap = xyz.shape[0]
        valid = torch.arange(cap, dtype=torch.int32, device=xyz.device) < count
        sel = sel & valid
        col_mask = torch.where(valid, 0.0, F32_MAX)
        ilist = torch.nonzero(sel).squeeze(1)  # host sync: the trip count
        md = torch.zeros(cap, dtype=torch.float32, device=xyz.device)
        for b in range(0, ilist.shape[0], block):
            bidx = ilist[b:b + block]
            md[bidx] = _knn_sum_rows(xyz[bidx], bidx, xyz, col_mask, k) / float(k)
        return torch.where(sel, md, 0.0)
