"""Kernel 1: segmented reduction over Morton-sorted voxel runs.

Replaces cwipc_util_tpu/ops/pallas_segment_reduce.py (``_kernel``, its
pallas_call at :278, wrapper ``segment_reduce_sorted`` :237).  On CUDA
tensors :func:`segment_reduce_sorted` launches ``csrc/segment_reduce.cu``;
on CPU tensors it runs :func:`segment_reduce_sorted_plain`, the plain
PyTorch version of the same function.

Bound on the H100: memory (12 bytes a point in, 36 bytes a run out: about
20 MB at the chain's 1M points; no arithmetic to speak of).  The outputs,
the run count, a tile counter and the look-back status words share one
work buffer (:func:`segment_plan`).  One call is a memset of the part
after the outputs and one launch: each tile of TILE points ranks its run
starts, resolves its run offset by decoupled look-back, sums the runs that
start in it (the last one walked past the tile's end) in registers and
shared memory, and writes each of them once; blocks after the last tile
zero the columns past the run count.  The CUDA source describes it.

Output contract (the JAX wrapper's rows 0-7 and key, in a layout of its
own): ``rows`` f32 [8, out_capacity] = sums of fx, fy, fz (fx = (q + 0.5) /
1024), sums of r, g, b, the point count and the OR of the tile bytes;
``key`` int32 [out_capacity], each run's Morton key; ``nseg`` 0-d int32,
the number of runs, not capped.  Columns past the last run are zero.
Every value is an exact integer (or multiple of 1/2048) in f32 for runs
under 8192 points, so the kernel and the plain version agree bit for bit
with each other and with the TPU kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import _kernels

SENTINEL = 2**31 - 1
NROWS = 8
TILE = 1024  # scan.cuh's points per tile
ZERO_COLS = 4096  # segment_reduce.cu's columns a tail block zeroes


@dataclass(frozen=True)
class SegmentPlan:
    """The one work buffer segment_reduce.cu takes for n points and ocap
    columns, in int32 words: rows f32 [8, ocap] at 0, the run keys [ocap]
    at ``key_at``, the run count at ``nseg_at``, the tile counter after it,
    then one 64-bit look-back status word per tile from ``status_at``."""

    tiles: int  # tiles of TILE points
    blocks: int  # the launch's blocks: the tiles, then the tail blocks that zero [nseg, ocap)
    key_at: int
    nseg_at: int
    status_at: int  # even: 8-byte aligned
    words: int


@functools.lru_cache(maxsize=256)
def segment_plan(n: int, ocap: int) -> SegmentPlan:
    """segment_reduce.cu's work buffer for n points and ocap columns."""
    tiles = -(-n // TILE)
    nseg_at = NROWS * ocap + ocap
    status_at = (nseg_at + 3) // 2 * 2  # after the run count and the tile counter
    return SegmentPlan(tiles=tiles, blocks=tiles + -(-ocap // ZERO_COLS), key_at=NROWS * ocap,
                       nseg_at=nseg_at, status_at=status_at, words=status_at + 2 * tiles)


def segment_reduce_sorted_plain(smk, sfr, srgba, out_capacity: int):
    """Plain PyTorch version of kernel 1 (any device)."""
    n = smk.shape[0]
    ocap = int(out_capacity)
    dev = smk.device
    valid = smk != SENTINEL
    prev = torch.cat([torch.full((1,), SENTINEL, dtype=torch.int32, device=dev), smk[:-1]])
    start = valid & (smk != prev)
    run = torch.cumsum(start, 0) - 1
    nseg = start.sum(dtype=torch.int32)
    use = valid & (run < ocap)
    col = torch.where(use, run, ocap)  # column ocap collects what is dropped
    q = sfr.to(torch.int64)
    c = srgba.to(torch.int64)
    chans = torch.stack([
        (q >> 20) & 1023, (q >> 10) & 1023, q & 1023,
        (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF,
        torch.ones_like(q),
    ])
    acc = torch.zeros((7, ocap + 1), dtype=torch.int64, device=dev).index_add_(1, col, chans)
    tile = (c >> 24) & 0xFF
    bit = torch.arange(8, dtype=torch.int64, device=dev)[:, None]
    bit_sums = torch.zeros((8, ocap + 1), dtype=torch.int64, device=dev).index_add_(
        1, col, (tile[None, :] >> bit) & 1
    )
    tile_or = ((bit_sums > 0).to(torch.int64) << bit).sum(0)
    key = torch.zeros(ocap + 1, dtype=torch.int32, device=dev).scatter_(
        0, torch.where(start & use, run, ocap), smk
    )
    cnt = acc[6]
    rows = torch.cat([
        (2 * acc[0:3] + cnt).to(torch.float32) * (1.0 / 2048.0),
        acc[3:7].to(torch.float32),
        tile_or[None].to(torch.float32),
    ])
    return rows[:, :ocap].contiguous(), key[:ocap].contiguous(), nseg


def segment_reduce_sorted(smk, sfr, srgba, out_capacity: int):
    """Reduce the sorted voxel runs: returns (rows f32 [8, out_capacity],
    key int32 [out_capacity], nseg 0-d int32).

    ``smk`` holds the sorted Morton keys with INT32_MAX padding, ``sfr``
    the packed 10-bit in-voxel offsets, ``srgba`` the rgba words, all int32
    [n] on one device."""
    what = "segment_reduce_sorted"
    n = smk.shape[0]
    ocap = int(out_capacity)
    if _kernels.expect_rows(what, ("smk", "sfr", "srgba"), (smk, sfr, srgba), torch.int32, n) == "cpu":
        return segment_reduce_sorted_plain(smk, sfr, srgba, ocap)
    plan = segment_plan(n, ocap)
    work = torch.empty(plan.words, dtype=torch.int32, device=smk.device)
    lib = _kernels.load()
    with _kernels.device_guard(smk):
        err = lib.cwipc_segment_reduce(smk.data_ptr(), sfr.data_ptr(), srgba.data_ptr(), n, ocap, work.data_ptr(),
                                       _kernels.stream(smk))
    _kernels.check(lib, err, what)
    segment_reduce_sorted.launches += 1
    rows = work[:plan.key_at].view(torch.float32).view(NROWS, ocap)
    return rows, work[plan.key_at:plan.nseg_at], work[plan.nseg_at]


segment_reduce_sorted.launches = 0
