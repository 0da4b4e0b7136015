"""Statistical outlier removal primitives.

The port of the pieces of cwipc_util_tpu/ops/outliers.py that the fused
chain runs.  Semantics follow the reference's use of PCL
StatisticalOutlierRemoval (src/cwipc_filters.cpp:181-278): per point the
mean distance to its k nearest neighbours, the global mean and (n-1)
standard deviation of those means, and keep where md <= mu + mult * sigma.

``_mean_knn_dist_window`` is the Morton-window approximation of the first
step and the plain version of kernel 2 (ops/window_knn.py).
``_mean_knn_dist_bruteforce`` is the exact method for small clouds; the
column-grid method for large ones is ops/cols_knn.py.
``_mean_knn_dist_grid`` is the neighbourhood-grid method (``grid``): exact
while each cell holds at most ``cell_cap`` points and every point's k-th
neighbour lies in its 3x3x3 cell ring, as for a cloud downsampled at c
with cells >= 3c and k <= 30; a neighbour the ring lacks counts as 2 cells
away.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..core.buffers import PointBuffer
from .compaction import compact

F32_MAX = 3.4028234663852886e38


@contextlib.contextmanager
def _full_f32_matmul():
    """Run float32 matrix products in full float32 on the card, whatever
    the process default says: TF32 keeps about three decimal digits (the
    JAX package pins Precision.HIGHEST for its products)."""
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = prev


def _knn_sum_rows(rows, row_idx, xyz, col_mask, k: int) -> torch.Tensor:
    """Sum of the k smallest distances from each of ``rows`` [B, 3] to the
    points of ``xyz`` [N, 3], excluding column ``row_idx`` (self) and the
    columns that ``col_mask`` sets to F32_MAX.

    d2 is formed from the coordinate differences, ((dx*dx) + (dy*dy)) +
    (dz*dz), as kernel 4 forms it.  The JAX package's |a|^2 + |b|^2 - 2ab
    expansion (one matrix product) cancels: with coordinates a metre or two
    from the origin it moves a distance of a few centimetres by far more
    than float32 rounding, which flipped keep decisions away from the
    threshold against a float64 oracle (chip_smoke.py phase 6's uniformly
    sampled wall, whose points the fixup takes nearly all)."""
    dx, dy, dz = (rows[:, a, None] - xyz[None, :, a] for a in range(3))
    d2 = dx * dx + dy * dy + dz * dz + col_mask[None, :]
    cols = torch.arange(xyz.shape[0], device=xyz.device)
    d2 = torch.where(cols[None, :] == row_idx[:, None], F32_MAX, d2)
    small = torch.topk(d2, k, dim=-1, largest=False).values
    dists = torch.sqrt(torch.clamp_min(small, 0.0))
    dists = torch.where(torch.isfinite(dists) & (small < F32_MAX / 2), dists, 0.0)
    return dists.sum(-1)


def _mean_knn_dist_bruteforce(xyz: torch.Tensor, count: torch.Tensor, k: int, block: int = 1024) -> torch.Tensor:
    """Per-point mean distance to the k nearest neighbours (excluding
    self), by blocks of ``block`` rows against the whole buffer."""
    cap = xyz.shape[0]
    valid = torch.arange(cap, dtype=torch.int32, device=xyz.device) < count
    col_mask = torch.where(valid, 0.0, F32_MAX)
    out = []
    for start in range(0, cap, block):
        rows = xyz[start:start + block]
        idx = torch.arange(start, start + rows.shape[0], device=xyz.device)
        out.append(_knn_sum_rows(rows, idx, xyz, col_mask, k) / float(k))
    return torch.where(valid, torch.cat(out), 0.0)


def _keep_from_mean_dists(mean_dist: torch.Tensor, valid: torch.Tensor, mult: float) -> torch.Tensor:
    """PCL's global mean/stddev threshold test over per-point mean distances."""
    n = valid.sum(dtype=torch.float32)
    md = torch.where(valid, mean_dist, 0.0)
    return _keep_from_moments(mean_dist, valid, mult, n, md.sum(), (md * md).sum())


def _threshold(mult: float, n, s, sq):
    """The keep threshold mu + mult * sigma from the moments (n, sum, sum
    of squares) of the mean-distance population; +inf for mult = inf."""
    if math.isinf(float(mult)):
        # the documented "pure downsample" mode: inf * sigma is NaN when
        # sigma == 0, which would drop every point instead of keeping all
        return torch.full_like(s, math.inf)
    n_safe = torch.clamp_min(n, 1.0)
    mean = s / n_safe
    # PCL: variance = (sq_sum - sum^2/n) / (n-1)
    var = (sq - s * s / n_safe) / torch.clamp_min(n - 1.0, 1.0)
    sigma = torch.sqrt(torch.clamp_min(var, 0.0))
    return mean + float(mult) * sigma


def _keep_from_moments(mean_dist, valid, mult, n, s, sq) -> torch.Tensor:
    """Threshold test from externally supplied moments of the population."""
    return valid & (mean_dist <= _threshold(mult, n, s, sq))


def _mean_knn_dist_window(xyz: torch.Tensor, count: torch.Tensor, k: int, window: int = 32) -> torch.Tensor:
    """Approximate kNN mean distance over the +/-window array neighbours.

    Assumes Morton (spatially local) order, as ops/voxelize.py emits it.
    Neighbours outside [0, count) are missing: they sort last, count 0 and
    the divisor stays kk = min(k, 2*window), as in the JAX spec.
    """
    cap = xyz.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=xyz.device)
    x, y, z = xyz.unbind(-1)
    rows = []
    for w in range(-window, window + 1):
        if w == 0:
            continue
        dx = x - torch.roll(x, -w)
        dy = y - torch.roll(y, -w)
        dz = z - torch.roll(z, -w)
        d2 = dx * dx + dy * dy + dz * dz  # (dx² + dy²) + dz², no FMA
        nb = idx + w
        rows.append(torch.where((nb >= 0) & (nb < count), d2, F32_MAX))
    kk = min(k, 2 * window)
    smallest = torch.sort(torch.stack(rows), dim=0).values[:kk]
    dists = torch.where(smallest < F32_MAX / 2, torch.sqrt(torch.clamp_min(smallest, 0.0)), 0.0)
    md = dists.sum(0) / float(kk)
    return torch.where(idx < count, md, 0.0)


_AXIS_BITS = 10  # bits per axis of the grid method's packed cell key
_AXIS_MAX = (1 << _AXIS_BITS) - 1
_INT32_MAX = 2**31 - 1
_GRID_BLOCK = 8192  # rows whose [rows, 27 * cell_cap] candidates are gathered at once


def _mean_knn_dist_grid(xyz: torch.Tensor, count: torch.Tensor, cell, k: int, cell_cap: int = 32) -> torch.Tensor:
    """Grid-bucketed kNN mean distance over the 3x3x3 cell ring (the JAX
    ``_mean_knn_dist_grid``): points sorted by a 10-bit-per-axis cell key,
    each of the 27 neighbour cells found by ``searchsorted``, up to
    ``cell_cap`` candidates gathered from each, the k smallest by
    ``topk``."""
    cap = xyz.shape[0]
    dev = xyz.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = idx < count
    cell_t = torch.tensor(float(np.float32(cell)), dtype=torch.float32, device=dev)
    v = torch.floor(xyz / cell_t).to(torch.int32)
    vmin = torch.where(valid[:, None], v, _INT32_MAX).amin(dim=0)
    v = torch.clamp(v - vmin, 0, _AXIS_MAX)
    key = torch.where(valid, (v[:, 0] << (2 * _AXIS_BITS)) | (v[:, 1] << _AXIS_BITS) | v[:, 2], _INT32_MAX)
    skey, perm = torch.sort(key, stable=True)
    sxyz, sv = xyz[perm], v[perm]
    off = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    offsets = torch.stack(torch.meshgrid(off, off, off, indexing="ij"), -1).reshape(27, 3)
    slots = torch.arange(cell_cap, dtype=torch.int64, device=dev)
    out = []
    for start in range(0, cap, _GRID_BLOCK):
        rows_xyz, rows_v = sxyz[start:start + _GRID_BLOCK], sv[start:start + _GRID_BLOCK]
        b = rows_xyz.shape[0]
        rows_i = torch.arange(start, start + b, device=dev)
        nb = rows_v[:, None, :] + offsets[None]  # [b, 27, 3]
        in_grid = ((nb >= 0) & (nb <= _AXIS_MAX)).all(-1)
        nb_key = (nb[..., 0] << (2 * _AXIS_BITS)) | (nb[..., 1] << _AXIS_BITS) | nb[..., 2]
        lo = torch.searchsorted(skey, nb_key.reshape(-1), side="left").reshape(b, 27)
        hi = torch.searchsorted(skey, nb_key.reshape(-1), side="right").reshape(b, 27)
        hi = torch.where(in_grid, hi, lo)
        cand = lo[:, :, None] + slots
        cand_ok = (cand < hi[:, :, None]).reshape(b, -1)
        cand = torch.clamp(cand, 0, cap - 1).reshape(b, -1)
        diff = sxyz[cand] - rows_xyz[:, None, :]
        d2 = (diff * diff).sum(-1)
        d2 = torch.where(cand_ok & (cand != rows_i[:, None]), d2, F32_MAX)
        small = torch.topk(d2, k, dim=-1, largest=False).values
        dists = torch.where(small < F32_MAX / 2, torch.sqrt(torch.clamp_min(small, 0.0)), 2.0 * cell_t)
        out.append(dists.sum(-1) / float(k))
    md = torch.zeros(cap, dtype=torch.float32, device=dev).index_copy_(0, perm, torch.cat(out))
    return torch.where(valid, md, 0.0)


def remove_outliers(buf: PointBuffer, k: int, mult: float, method: str = "exact", cell=None,
                    cell_cap: int = 32, window: int = 32) -> PointBuffer:
    """Statistical outlier removal over the whole buffer (no tiling).

    ``exact`` is the brute-force kNN; ``window`` the Morton-window
    approximation through kernel 2 (ops/window_knn.py); ``grid`` the
    neighbourhood-grid method at grid cell ``cell``."""
    if method == "grid":
        if cell is None:
            raise ValueError("remove_outliers: the grid method needs a cell size")
        md = _mean_knn_dist_grid(buf.xyz, buf.count, cell, k, cell_cap=cell_cap)
    elif method == "window":
        from .window_knn import window_knn_mean_distance_cm

        x, y, z = (buf.xyz[:, a].contiguous() for a in range(3))
        md = window_knn_mean_distance_cm(x, y, z, buf.count, k, window)
    elif method == "exact":
        md = _mean_knn_dist_bruteforce(buf.xyz, buf.count, k)
    else:
        raise ValueError(f"remove_outliers: unknown method {method!r} (exact, window, grid)")
    keep = _keep_from_mean_dists(md, buf.valid_mask(), mult)
    return compact(buf, keep)
