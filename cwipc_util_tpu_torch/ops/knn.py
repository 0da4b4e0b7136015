"""Cross-cloud nearest-neighbour search: two-scale grid and column grid.

The port of cwipc_util_tpu/ops/knn.py, the registration toolkit's inner
search: for every point of a source cloud, the nearest point of a
reference cloud within a maximum correspondence distance, as (distance,
reference index), or (+inf, -1) where there is none.

* :func:`nn_search`, the two-scale search: a fine pass (cell = maxd / 8)
  and a coarse pass (cell = maxd), each scanning up to ``cell_cap``
  sorted reference points in the 3x3x3 cell ring, the per-point minimum
  of both (the fine result wins ties).  In the JAX package this is XLA,
  not Pallas, so plain torch ops are its port.
* :func:`nn_grid_prepare` / :func:`nn_grid_query`, the column grid: both
  clouds in (y, z)-column slot grids on one plane (cell = maxd / 3.5);
  kernel 5 (ops/nn_select.py) scans each query slot's 77-column ring; the
  queries the grid cannot certify (out of grid, rank-dropped, or with a
  dropped reference column in reach) go through the exact
  :func:`bruteforce_nn_subset`.
* :func:`nn_grid_params`, the host-side choice of the grid, copied from
  the JAX module as it is so both packages pick the same grid.
* :func:`two_scale_searcher` / :func:`grid_searcher`: each search with its
  reference side prepared once, for ICP's fixed reference; ``nn_search``
  and the one-shot grid search are one query of them.
* :func:`nn_search_host_auto`: the grid on CUDA tensors whenever
  ``nn_grid_params`` returns one, the two-scale search otherwise and on
  CPU tensors (as the JAX package on the CPU).

The JAX module's environment switches (CWIPC_GRID_NN, CWIPC_GRID_NN_MIN)
are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .cols_knn import _M, _cols_build
from .nn_select import INT32_MAX, nn_select, ring_offsets
from .outliers import F32_MAX

SENTINEL = INT32_MAX
_AXIS_BITS = 10
_AXIS_MAX = (1 << _AXIS_BITS) - 1

FINE_FACTOR = 8.0


def _nn_prepare(ref_xyz, rvalid, ridx, cell):
    """Reference-side preparation for one grid scale: cell keys, the key
    sort and the gathered coordinates.  Loop-invariant for ICP, which
    queries a moving source against a fixed reference.  The sort is stable,
    so equal keys keep their index order."""
    rv = torch.floor(ref_xyz / cell).to(torch.int32)
    vmin = torch.where(rvalid[:, None], rv, SENTINEL).amin(dim=0)
    vmin = torch.where(vmin == SENTINEL, 0, vmin)
    vc = torch.clamp(rv - vmin[None, :], 0, _AXIS_MAX)
    rkey = (vc[:, 0] << (2 * _AXIS_BITS)) | (vc[:, 1] << _AXIS_BITS) | vc[:, 2]
    rkey = torch.where(rvalid, rkey, SENTINEL)
    srkey, perm = torch.sort(rkey, stable=True)
    sridx = ridx[perm]
    return srkey.contiguous(), sridx, ref_xyz[sridx], vmin


def _ring27(dev) -> torch.Tensor:
    off = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    ox, oy, oz = torch.meshgrid(off, off, off, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], dim=-1)  # [27, 3]


def _nn_query(src_xyz, prep, cell, radius, cell_cap: int, block: int):
    """Query one prepared grid scale: NN within ``radius``, candidates from
    the 3x3x3 cell ring (exact when radius <= cell and cells do not
    overflow ``cell_cap``)."""
    scap = src_xyz.shape[0]
    srkey, sridx, srxyz, vmin = prep
    rcap = srxyz.shape[0]
    dev = src_xyz.device
    sv = torch.clamp(torch.floor(src_xyz / cell).to(torch.int32) - vmin[None, :], 0, _AXIS_MAX)
    offsets = _ring27(dev)
    slots = torch.arange(cell_cap, dtype=torch.int32, device=dev)
    dists, idxs = [], []
    for start in range(0, scap, block):
        bxyz = src_xyz[start:start + block]
        nb = sv[start:start + block, None, :] + offsets[None, :, :]
        in_grid = ((nb >= 0) & (nb <= _AXIS_MAX)).all(dim=-1)
        nb_key = (nb[..., 0] << (2 * _AXIS_BITS)) | (nb[..., 1] << _AXIS_BITS) | nb[..., 2]
        lo = torch.searchsorted(srkey, nb_key, side="left").to(torch.int32)
        hi = torch.searchsorted(srkey, nb_key, side="right").to(torch.int32)
        hi = torch.where(in_grid, hi, lo)
        cand = lo[:, :, None] + slots[None, None, :]
        cand_ok = (cand < hi[:, :, None]).reshape(len(bxyz), -1)
        cand = torch.clamp(cand, 0, rcap - 1).reshape(len(bxyz), -1).long()
        diff = srxyz[cand] - bxyz[:, None, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
        d2 = torch.where(cand_ok, d2, F32_MAX)
        best = torch.argmin(d2, dim=-1, keepdim=True)  # the first of equal minima
        best_d2 = torch.gather(d2, 1, best)[:, 0]
        best_ridx = sridx[torch.gather(cand, 1, best)[:, 0]]
        dist = torch.sqrt(torch.clamp_min(best_d2, 0.0))
        found = (best_d2 < F32_MAX / 2) & (dist <= radius)
        dists.append(torch.where(found, dist, torch.inf))
        idxs.append(torch.where(found, best_ridx, -1))
    return torch.cat(dists), torch.cat(idxs)


def _maxd(max_distance, dev) -> torch.Tensor:
    return torch.clamp_min(torch.as_tensor(max_distance, dtype=torch.float32, device=dev), 1e-9)


def _masked(src_count, dist, idx):
    """(+inf, -1) on the source's padding rows."""
    svalid = torch.arange(dist.shape[0], dtype=torch.int32, device=dist.device) < src_count
    return torch.where(svalid, dist, torch.inf), torch.where(svalid, idx, -1)


def two_scale_searcher(ref_xyz, ref_count, max_distance, cell_cap: int = 48, block: int = 4096):
    """The two-scale search against a fixed reference: prepares both scales
    once (loop-invariant for ICP) and returns ``query(src_xyz, src_count)
    -> (dist, idx)``, as :func:`nn_search` computes it."""
    dev = ref_xyz.device
    maxd = _maxd(max_distance, dev)
    ridx = torch.arange(ref_xyz.shape[0], dtype=torch.int32, device=dev)
    rvalid = ridx < ref_count
    # fine pass: exact for matches within maxd / FINE_FACTOR
    fine_cell = maxd / FINE_FACTOR
    prep_f = _nn_prepare(ref_xyz, rvalid, ridx, fine_cell)
    # coarse pass: full-radius coverage
    prep_c = _nn_prepare(ref_xyz, rvalid, ridx, maxd)

    def query(src_xyz, src_count):
        blk = max(1, min(block, src_xyz.shape[0]))
        d_f, i_f = _nn_query(src_xyz, prep_f, fine_cell, fine_cell, cell_cap, blk)
        d_c, i_c = _nn_query(src_xyz, prep_c, maxd, maxd, cell_cap, blk)
        take_fine = d_f <= d_c
        return _masked(src_count, torch.where(take_fine, d_f, d_c), torch.where(take_fine, i_f, i_c))

    return query


def nn_search(src_xyz, src_count, ref_xyz, ref_count, max_distance, cell_cap: int = 48,
              block: int = 4096):
    """For each source point: (distance, ref index) of the nearest reference
    point within max_distance; (+inf, -1) where there is none and for the
    padding rows.  Returns (dist f32 [scap], idx int32 [scap])."""
    return two_scale_searcher(ref_xyz, ref_count, max_distance, cell_cap, block)(src_xyz, src_count)


def bruteforce_nn_subset(src_xyz, src_count, sel, ref_xyz, ref_count, maxd, block: int = 256):
    """Exact NN for the selected source rows only, by blocks of ``block``
    rows against every reference point.  Returns (dist, idx) with
    (+inf, -1) for non-selected rows and beyond-radius results.

    d2 is computed by direct subtraction, NOT the |a|^2 + |b|^2 - 2ab
    matrix-product form (``torch.cdist`` switches to it above 25 rows):
    its cancellation noise (~1e-6 relative) would make these distances
    disagree with the grid kernel's.  The number of selected rows sets the
    trip count, so it is read on the host (and the reference count with
    it, to scan only the valid reference rows): the grid query's host
    syncs."""
    dev = src_xyz.device
    scap = src_xyz.shape[0]
    maxd = _maxd(maxd, dev)
    sel = sel & (torch.arange(scap, dtype=torch.int32, device=dev) < src_count)
    dist = torch.full((scap,), torch.inf, dtype=torch.float32, device=dev)
    idx = torch.full((scap,), -1, dtype=torch.int32, device=dev)
    ilist = torch.nonzero(sel).squeeze(1)  # host sync: the trip count
    ref = ref_xyz[:int(ref_count)]
    if ref.shape[0] == 0:
        return dist, idx
    for b in range(0, ilist.shape[0], block):
        bidx = ilist[b:b + block]
        d = src_xyz[bidx][:, None, :] - ref[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        best = torch.argmin(d2, dim=-1, keepdim=True)
        bd = torch.sqrt(torch.gather(d2, 1, best)[:, 0])
        ok = bd <= maxd
        dist[bidx] = torch.where(ok, bd, torch.inf)
        idx[bidx] = torch.where(ok, best[:, 0].to(torch.int32), -1)
    return dist, idx


def nn_grid_params(src_np, ref_np, maxd: float, budget: int = 8_000_000,
                   cap_max: int = 128,
                   fallback_budget: float = 2e9):
    """Host-side grid parameter choice for the column-grid NN, copied from
    the JAX module (same ladders, budgets and percentiles, so both packages
    pick the same grid for the same clouds): cell = maxd/3.5 (ring
    coverage of the full radius), percentile-clipped extents over BOTH
    clouds plus a motion margin (ICP moves the source; strays are fixed up
    exactly), bucketed dims and caps.  The COLUMN axis is chosen per scene:
    a flat sheet seen along the wrong axis puts whole level-set curves into
    single columns.

    Column caps need NOT cover the densest column: over-cap reference
    columns raise ``_cols_build``'s drop_ring and every query whose ring
    touches one goes through the brute-force fixup, so dense scenes pick
    the smallest cap whose estimated fixup work (the tainted ring dilated
    by 2*_M, as ``_cols_build`` does) stays under ``fallback_budget``
    query*ref element operations.

    Returns (perm, gy, gz, cap_r, cap_q, origin_cells int32[3]) --
    coordinates and origin in PERMUTED axis order (grid x = cloud axis
    perm[0]) -- or None when no axis fits the budgets (the caller keeps the
    two-scale path)."""
    if maxd <= 0 or len(src_np) == 0 or len(ref_np) == 0:
        return None
    cell = float(maxd) / 3.5
    pts = np.concatenate([src_np, ref_np], axis=0)
    lo_a = np.percentile(pts, 0.5, axis=0)
    hi_a = np.percentile(pts, 99.5, axis=0)
    margin = 8  # cells: source motion + clip slack

    def bucket(v, mults):
        for m in mults:
            if v <= m:
                return m
        return None

    # The JAX module sizes this ladder for TPU VMEM (3*77*cap*128 f32 under
    # 60 MiB) and compile time; kernel 5 on the H100 takes any cap the
    # ladder yields.  Retuning it for Hopper is later work.
    cap_ladder = tuple(
        c for c in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
        if c <= cap_max and 3 * 77 * c * 128 * 4 <= 60 * (1 << 20)
    )

    best = None
    for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        p = list(perm)
        lo = lo_a[p]
        hi = hi_a[p]
        origin = np.floor(lo / cell).astype(np.int64) - margin
        ext = np.floor(hi / cell).astype(np.int64) - origin + 1 + margin
        gy = bucket(int(ext[1]), (32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024))
        gz = bucket(int(ext[2]), (32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024))
        if gy is None or gz is None or gy * gz > 1_000_000:
            continue  # (the int32 sort-key limit in _cols_build)

        def col_occ(cloud):
            """(occupancy image [gy, gz], cell coords, in-grid mask)."""
            v = np.floor(cloud[:, p] / cell).astype(np.int64) - origin
            inb = (
                (v[:, 1] >= 0) & (v[:, 1] < gy)
                & (v[:, 2] >= 0) & (v[:, 2] < gz)
            )
            occ = np.zeros((gy, gz), np.int64)
            np.add.at(occ, (v[inb, 1], v[inb, 2]), 1)
            return occ, v, inb

        occ_r, vr, rin = col_occ(ref_np)
        occ_q, vq, qin = col_occ(src_np)
        max_r = int(occ_r.max()) if occ_r.size else 0
        max_q = int(occ_q.max()) if occ_q.size else 0
        cap_r = bucket(max(max_r, 1), cap_ladder) or cap_ladder[-1]
        cap_q = bucket(max(max_q, 1), cap_ladder) or cap_ladder[-1]

        # the brute-force fixup volume this cap choice implies: over-cap or
        # out-of-extent reference columns taint their whole dilated ring,
        # plus source points that are themselves out of grid or rank-dropped
        drop = occ_r > cap_r
        if (~rin).any():
            by = np.clip(vr[~rin, 1], 0, gy - 1)
            bz = np.clip(vr[~rin, 2], 0, gz - 1)
            drop[by, bz] = True
        if drop.any():
            f = drop
            for ax in (0, 1):
                base = f
                for j in range(1, 2 * _M + 1):
                    f = f | np.roll(base, j, ax) | np.roll(base, -j, ax)
            q_tainted = f[np.clip(vq[:, 1], 0, gy - 1),
                          np.clip(vq[:, 2], 0, gz - 1)] | ~qin
            n_fb = int(q_tainted.sum())
        else:
            n_fb = int((~qin).sum())
        if occ_q.max(initial=0) > cap_q:
            over_q = occ_q[np.clip(vq[:, 1], 0, gy - 1),
                           np.clip(vq[:, 2], 0, gz - 1)] > cap_q
            n_fb = min(len(src_np), n_fb + int(over_q.sum()))
        fb_work = float(n_fb) * len(ref_np)
        if fb_work > fallback_budget:
            continue

        vol = gy * gz * max(cap_r, cap_q)
        if vol > budget:
            continue
        # prefer axes that avoid fixups: the fixup is O(n_fb * rcap) every
        # iteration, vol only sizes the kernel scan; n_fb is bucketed a
        # little so near-ties fall through to the volume comparison
        key = (n_fb // max(1, len(src_np) // 50), vol)
        if best is None or key < best[0]:
            best = (key, perm, gy, gz, cap_r, cap_q, origin.astype(np.int32))
    if best is None:
        return None
    return best[1:]


def nn_grid_prepare(ref_xyz, ref_count, cell, *, gy, gz, cap, vmin):
    """Reference-side grid build for the column-grid NN (loop-invariant for
    ICP).  Returns (x, y, z planes, slot_orig, drop_ring)."""
    xs, ys, zs, slot_orig, _valid, drop_ring, _ps = _cols_build(
        ref_xyz, ref_count, cell, gy=gy, gz=gz, cap=cap, chunk=256, vmin_override=vmin,
    )
    return xs, ys, zs, slot_orig, drop_ring


def nn_grid_query(src_xyz, src_count, prep, cell, maxd, *, gy, gz, cap_r, cap_q, vmin):
    """Nearest reference point within ``maxd`` for every source point through
    kernel 5, exact wherever the grid certifies it.  Returns (dist [scap],
    idx [scap], need_fix [scap]): (+inf, -1) where no reference lies within
    maxd, and need_fix for the valid queries the grid cannot certify
    (out-of-grid or rank-dropped queries, and queries whose ring touches a
    dropped reference column), which the caller recomputes with
    :func:`bruteforce_nn_subset`."""
    r_xs, r_ys, r_zs, r_orig, r_drop = prep
    q_xs, q_ys, q_zs, q_orig, _qv, _qd, _qps = _cols_build(
        src_xyz, src_count, cell, gy=gy, gz=gz, cap=cap_q, chunk=256, vmin_override=vmin,
    )
    d2m, cid = nn_select(r_xs, r_ys, r_zs, q_xs, q_ys, q_zs, gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q)
    return _nn_grid_decode(d2m, cid, r_orig, r_drop, q_orig, src_xyz.shape[0], src_count, maxd,
                           gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q)


def _nn_grid_decode(d2m, cid, r_orig, r_drop, q_orig, scap, src_count, maxd, *, gy, gz, cap_r, cap_q):
    """Kernel 5's per-slot (d2, cid) to per-source (dist, idx, need_fix):
    cid -> reference slot -> reference index through ``slot_orig``, the
    ``drop_ring`` taint, and the scatter back to source order."""
    dev = d2m.device
    gyz = gy * gz
    capp_r = -(-cap_r // 8) * 8
    slots_q = gyz * cap_q
    maxd = _maxd(maxd, dev)
    d2f = d2m.reshape(slots_q)
    cidf = cid.reshape(slots_q)
    plane_row = torch.arange(slots_q, dtype=torch.int32, device=dev) // cap_q
    offs = torch.tensor(ring_offsets(gz), dtype=torch.int32, device=dev)
    jblk = torch.clamp(cidf // capp_r, 0, offs.shape[0] - 1)
    row = cidf - (cidf // capp_r) * capp_r
    found = cidf != INT32_MAX
    ref_slot = (plane_row + offs[jblk.long()]) * cap_r + torch.clamp(row, 0, cap_r - 1)
    ref_slot = torch.clamp(ref_slot, 0, gyz * cap_r - 1)
    ref_idx = torch.where(found, r_orig[ref_slot.long()], -1)
    dist_slot = torch.sqrt(torch.clamp_min(d2f, 0.0))
    ok = found & (dist_slot <= maxd) & (ref_idx >= 0)
    dist_slot = torch.where(ok, dist_slot, torch.inf)
    ref_idx = torch.where(ok, ref_idx, -1)

    # queries whose ring saw a dropped reference column are untrustworthy
    tainted = torch.repeat_interleave(r_drop, cap_q)

    # scatter back to source order; queries without a slot stay unresolved
    okq = q_orig >= 0
    tgt = torch.where(okq, q_orig, scap).long()
    dist = torch.full((scap + 1,), torch.inf, dtype=torch.float32, device=dev)
    dist[tgt] = torch.where(okq, dist_slot, torch.inf)
    idx = torch.full((scap + 1,), -1, dtype=torch.int32, device=dev)
    idx[tgt] = torch.where(okq, ref_idx, -1)
    resolved = torch.zeros((scap + 1,), dtype=torch.bool, device=dev)
    resolved[tgt] = okq & ~tainted
    svalid = torch.arange(scap, dtype=torch.int32, device=dev) < src_count
    return dist[:scap], idx[:scap], svalid & ~resolved[:scap]


def grid_cell(maxd) -> float:
    """The column grid's cell for a correspondence radius, in float32 as
    the JAX package computes it (maxd * f32(1/3.5))."""
    return float(np.float32(np.float32(max(float(maxd), 1e-9)) * np.float32(1.0 / 3.5)))


def grid_searcher(ref_xyz, ref_count, maxd, vmin, *, perm, gy, gz, cap_r, cap_q):
    """The column-grid search with its exact fixup against a fixed
    reference: builds the reference grid once (loop-invariant for ICP) and
    returns ``query(src_xyz, src_count) -> (dist, idx)``.  The grid's
    column axis is scene-chosen: coordinates are permuted by ``perm`` for
    the grid ops only (distances and indices do not depend on it)."""
    pidx = list(perm)
    cell = grid_cell(maxd)
    prep = nn_grid_prepare(ref_xyz[:, pidx], ref_count, cell, gy=gy, gz=gz, cap=cap_r, vmin=vmin)

    def query(src_xyz, src_count):
        d, i, fix = nn_grid_query(src_xyz[:, pidx], src_count, prep, cell, maxd,
                                  gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q, vmin=vmin)
        fd, fi = bruteforce_nn_subset(src_xyz, src_count, fix, ref_xyz, ref_count, maxd)
        return _masked(src_count, torch.where(fix, fd, d), torch.where(fix, fi, i))

    return query


def _nn_grid_full(src_xyz, src_count, ref_xyz, ref_count, maxd, vmin, *, perm, gy, gz, cap_r, cap_q):
    """One-shot grid NN: kernel 5 and the exact fixup."""
    return grid_searcher(ref_xyz, ref_count, maxd, vmin, perm=perm, gy=gy, gz=gz, cap_r=cap_r,
                         cap_q=cap_q)(src_xyz, src_count)


def nn_search_host_auto(src_xyz, src_count, ref_xyz, ref_count, maxd):
    """NN dispatcher: on CUDA tensors the column grid (kernel 5) whenever
    :func:`nn_grid_params` finds a grid for the concrete clouds, else the
    two-scale :func:`nn_search` -- the JAX package's semantics for a scene
    that fits no grid.  On CPU tensors the two-scale search, as the JAX
    package takes on the CPU.  Host-level: the grid parameters are chosen
    from the clouds, which are read to the host for it."""
    if src_xyz.device.type == "cuda":
        sn, rn = int(src_count), int(ref_count)
        if sn and rn:
            params = nn_grid_params(
                src_xyz[:sn].cpu().numpy(), ref_xyz[:rn].cpu().numpy(), float(maxd),
            )
            if params is not None:
                perm, gy, gz, cap_r, cap_q, origin = params
                return _nn_grid_full(src_xyz, src_count, ref_xyz, ref_count, maxd, origin,
                                     perm=perm, gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q)
    return nn_search(src_xyz, src_count, ref_xyz, ref_count, maxd)
