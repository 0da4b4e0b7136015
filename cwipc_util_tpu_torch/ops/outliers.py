"""Statistical outlier removal primitives.

The port of the pieces of cwipc_util_tpu/ops/outliers.py that the fused
chain runs.  Semantics follow the reference's use of PCL
StatisticalOutlierRemoval (src/cwipc_filters.cpp:181-278): per point the
mean distance to its k nearest neighbours, the global mean and (n-1)
standard deviation of those means, and keep where md <= mu + mult * sigma.

``_mean_knn_dist_window`` is the Morton-window approximation of the first
step and the plain version of kernel 2 (ops/window_knn.py).  The exact
and grid methods are not ported yet.
"""

from __future__ import annotations

import math

import torch

F32_MAX = 3.4028234663852886e38


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
