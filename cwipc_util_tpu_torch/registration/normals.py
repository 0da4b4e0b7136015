"""Surface-normal estimation on the cloud's device.

The port of cwipc_util_tpu/registration/normals.py (XLA and a batched
``eigh`` there, not Pallas; plain torch here).  Points are sorted along a
Morton curve, each point's neighbourhood is its +/-window neighbours in
that order within ``radius``, the local covariance is accumulated from
contiguous shifts, and the normal is the eigenvector of the smallest
eigenvalue of the batched 3x3 covariance, oriented away from the centroid.

The sort is by (Morton key, original index): stable, so points with equal
keys keep their index order.  The eigenvectors come from cyclic Jacobi
sweeps written in torch (:func:`_eigh3`), not ``torch.linalg.eigh``: on
the H100 its batched cuSOLVER path rejected the registration flow's
[16384, 3, 3] batch (CUSOLVER_STATUS_INVALID_VALUE from
``cusolverDnXsyevBatched_bufferSize``), and the Jacobi form runs the same
arithmetic on either device.
"""

from __future__ import annotations

import torch

from ..core.buffers import PointBuffer
from ..ops.voxelize import _MORTON_MAX, morton3

_SENTINEL = 2**31 - 1
_JACOBI_SWEEPS = 6  # cyclic Jacobi on 3x3 converges quadratically; 6 sweeps reach f32 precision


def _eigh3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues [..., 3] (unsorted) and eigenvectors [..., 3, 3] (as
    columns) of symmetric 3x3 matrices, by cyclic Jacobi rotations."""
    a = a.clone()
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a).clone()
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[..., p, q]
            nz = apq != 0
            theta = (a[..., q, q] - a[..., p, p]) / torch.where(nz, 2.0 * apq, 1.0)
            t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(nz, torch.where(theta == 0, 1.0, t), 0.0)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            # A <- P^T A P and V <- V P, P the rotation in the (p, q) plane
            for m in (a, v):
                mp, mq = m[..., :, p].clone(), m[..., :, q].clone()
                m[..., :, p] = c[..., None] * mp - s[..., None] * mq
                m[..., :, q] = s[..., None] * mp + c[..., None] * mq
            ap, aq = a[..., p, :].clone(), a[..., q, :].clone()
            a[..., p, :] = c[..., None] * ap - s[..., None] * aq
            a[..., q, :] = s[..., None] * ap + c[..., None] * aq
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def estimate_normals(buf: PointBuffer, radius: float, window: int = 16) -> torch.Tensor:
    """Outward-oriented unit normals [capacity, 3] (zeros for padding).

    radius: neighbourhood radius (neighbours beyond it are excluded, the
    reference's KDTreeSearchParamHybrid(radius, max_nn) contract)."""
    cap = buf.capacity
    dev = buf.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = idx < buf.count
    r = torch.tensor(radius, dtype=torch.float32, device=dev)

    # Morton-order the points (cell = radius so the window covers the ball)
    inv = 1.0 / torch.clamp_min(r, 1e-9)
    v = torch.floor(buf.xyz * inv).to(torch.int32)
    vmin = torch.where(valid[:, None], v, _SENTINEL).amin(dim=0)
    vm = torch.clamp(v - torch.where(vmin == _SENTINEL, 0, vmin)[None, :], 0, _MORTON_MAX)
    key = torch.where(valid, morton3(vm[:, 0], vm[:, 1], vm[:, 2]), _SENTINEL)
    _, sidx = torch.sort(key, stable=True)
    sxyz = buf.xyz[sidx]

    r2 = r * r
    # moments of d = neighbour - query, not of absolute coordinates: |d| <=
    # radius, so E[dd^T] - E[d]E[d]^T stays conditioned in f32 for a cloud
    # metres from the origin
    s = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    sw = torch.zeros((cap,), dtype=torch.float32, device=dev)
    sww = torch.zeros((cap, 3, 3), dtype=torch.float32, device=dev)
    for w in range(-window, window + 1):
        rolled = torch.roll(sxyz, -w, dims=0)
        nb = idx + w
        d = rolled - sxyz
        ok = (nb >= 0) & (nb < buf.count) & (idx < buf.count) & ((d * d).sum(-1) <= r2)
        wgt = ok.to(torch.float32)[:, None]
        s = s + d * wgt
        sw = sw + wgt[:, 0]
        sww = sww + (d[:, :, None] * d[:, None, :]) * wgt[:, :, None]

    n = torch.clamp_min(sw, 1.0)[:, None]
    mean = s / n
    cov = sww / n[:, :, None] - mean[:, :, None] * mean[:, None, :]
    # smallest-eigenvalue eigenvector of each 3x3 covariance
    vals, vecs = _eigh3(cov)
    k = torch.argmin(vals, dim=-1)
    normal = torch.gather(vecs, 2, k[:, None, None].expand(cap, 3, 1))[:, :, 0]

    # orient outward from the cloud centroid (the reference flips Open3D's
    # toward-camera orientation, registration/util.py:131-141)
    total = torch.clamp_min(buf.count.to(torch.float32), 1.0)
    centroid = torch.where(valid[:, None], buf.xyz, 0.0).sum(0) / total
    outward = (normal * (sxyz - centroid)).sum(-1) < 0
    normal = torch.where(outward[:, None], -normal, normal)

    # back to the original order
    out = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    out[sidx] = normal
    return torch.where(valid[:, None], out, 0.0)
