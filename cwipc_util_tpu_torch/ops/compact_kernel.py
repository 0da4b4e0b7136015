"""Kernel 3: order-preserving stream compaction.

Replaces cwipc_util_tpu/ops/pallas_compact.py (``_kernel``, its
pallas_call at :192, wrappers ``compact_pallas_cm`` :138 and
``compact_pallas`` :173).  On CUDA tensors :func:`compact_kernel_cm`
launches ``csrc/compact.cu``; on CPU tensors it runs
:func:`compact_plain_cm`, the plain PyTorch version.

Bound on the H100: memory (about 33 bytes a point moved, under 8 MB at the
chain's 229,376 points).  One call is a memset of one work buffer (the
outputs, the kept count and the look-back scratch, :func:`compact_plan`)
and one launch, a chained scan with decoupled look-back: each tile ranks
its kept points and resolves its offset from the tiles before it, and
each kept point writes its four 32-bit words to its rank; the floats
travel as raw bits, so inf, nan and -0.0 pass unchanged.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import _kernels

TILE = 1024  # scan.cuh's points per block


@dataclass(frozen=True)
class CompactPlan:
    """The one work buffer compact.cu takes for n points, in int32 words."""

    tiles: int  # tiles of TILE points: the blocks of the launch
    status_at: int  # where the 64-bit look-back status words start (even: 8-byte aligned)
    words: int  # the outputs [4, n], the kept count, the tile counter, padding, the status words


@functools.lru_cache(maxsize=256)
def compact_plan(n: int) -> CompactPlan:
    """compact.cu's work buffer for n points."""
    tiles = -(-n // TILE)
    status_at = (4 * n + 3) // 2 * 2  # after the outputs, the kept count and the tile counter
    return CompactPlan(tiles=tiles, status_at=status_at, words=status_at + 2 * tiles)


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
    work = torch.empty(compact_plan(n).words, dtype=torch.int32, device=x.device)
    lib = _kernels.load()
    with _kernels.device_guard(x):
        err = lib.cwipc_compact(x.data_ptr(), y.data_ptr(), z.data_ptr(), rgba.data_ptr(), keep.data_ptr(),
                                count.data_ptr(), n, work.data_ptr(), _kernels.stream(x))
    _kernels.check(lib, err, what)
    compact_kernel_cm.launches += 1
    cx, cy, cz = work[:3 * n].view(torch.float32).view(3, n).unbind(0)
    return cx, cy, cz, work[3 * n:4 * n], work[4 * n]


compact_kernel_cm.launches = 0
