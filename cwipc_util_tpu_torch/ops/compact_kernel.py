"""Kernel 3: order-preserving stream compaction.

Replaces cwipc_util_tpu/ops/pallas_compact.py (``_kernel``, its
pallas_call at :192, wrappers ``compact_pallas_cm`` :138 and
``compact_pallas`` :173).  On CUDA tensors :func:`compact_kernel_cm`
launches ``csrc/compact.cu``; on CPU tensors it runs
:func:`compact_plain_cm`, the plain PyTorch version.

Bound on the H100: memory (about 33 bytes a point moved, under 8 MB at the
chain's 229,376 points).  A device-wide scan of the keep flags gives each
kept point its rank and it writes its four 32-bit words there; the floats
travel as raw bits, so inf, nan and -0.0 pass unchanged.
"""

from __future__ import annotations

import torch

from .. import _kernels

TILE = 1024  # scan.cuh's points per block


def compact_plain_cm(x, y, z, rgba, keep, count):
    """Plain PyTorch version of kernel 3 (any device)."""
    cap = x.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=x.device)
    kept = keep & (idx < count)
    slot = torch.where(kept, torch.cumsum(kept, 0) - 1, cap)  # slot cap: dropped
    words = torch.stack([x.view(torch.int32), y.view(torch.int32), z.view(torch.int32), rgba])
    out = torch.zeros((4, cap + 1), dtype=torch.int32, device=x.device).index_copy_(1, slot, words)
    out = out[:, :cap].contiguous()
    return (out[0].view(torch.float32), out[1].view(torch.float32), out[2].view(torch.float32),
            out[3], kept.sum(dtype=torch.int32))


def compact_kernel_cm(x, y, z, rgba, keep, count):
    """Keep the points with keep & (index < count), in order.

    x, y, z f32 [n], rgba int32 [n], keep bool [n], count 0-d int32.
    Returns (x', y', z', rgba', kept count); slots past the kept count are
    zero."""
    what = "compact_kernel_cm"
    n = x.shape[0]
    for name, t in (("x", x), ("y", y), ("z", z)):
        _kernels.expect(what, name, t, torch.float32, (n,))
    _kernels.expect(what, "rgba", rgba, torch.int32, (n,))
    _kernels.expect(what, "keep", keep, torch.bool, (n,))
    _kernels.expect(what, "count", count, torch.int32, ())
    if _kernels.route(what, x, y, z, rgba, keep, count) == "cpu":
        return compact_plain_cm(x, y, z, rgba, keep, count)
    lib = _kernels.load()
    dev = x.device
    ntiles = -(-n // TILE)
    tile_counts = torch.empty(max(ntiles, 1), dtype=torch.int32, device=dev)
    tile_offsets = torch.empty_like(tile_counts)
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    nkept = torch.empty((), dtype=torch.int32, device=dev)
    P = _kernels.ptr
    with torch.cuda.device(dev):
        err = lib.cwipc_compact(
            P(x), P(y), P(z), P(rgba), P(keep), P(count), n, P(tile_counts), P(tile_offsets),
            P(out[0]), P(out[1]), P(out[2]), P(out[3]), P(nkept), _kernels.stream(x),
        )
    _kernels.check(lib, err, what)
    compact_kernel_cm.launches += 1
    return (out[0].view(torch.float32), out[1].view(torch.float32), out[2].view(torch.float32),
            out[3], nkept)


compact_kernel_cm.launches = 0
