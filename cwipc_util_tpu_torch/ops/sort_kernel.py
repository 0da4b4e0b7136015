"""Kernel 6: sort of int32 keys carrying int32 payloads.

Replaces cwipc_util_tpu/ops/pallas_sort.py (``_kernel``, its pallas_call
at :169, wrappers ``sort_by_key`` :136 and ``sort3`` :183).  On CUDA
tensors :func:`sort_by_key` launches ``csrc/sort.cu`` (a onesweep LSD radix
sort: one upfront histogram of all four digits, then one decoupled
look-back pass per digit that is not the same for every key, the last one
carrying the payloads); on CPU tensors it runs :func:`sort_by_key_plain`,
``torch.sort(stable=True)`` and gathers.

The contract is the JAX wrapper's: int32 arrays of one length N, N a power
of two >= 8192; keys in signed int32 order (INT32_MAX pads); payload bits
pass unchanged, NaN patterns included.  Equal keys may come in any order;
both versions here happen to be stable, and nothing may rely on that.

The host side of the kernel is plain Python that the CPU tests reach:
:func:`sort_plan` (the scratch and launches of one sort) and
:func:`passes_run` (which digit passes the kernel runs, from the upfront
histogram that :func:`digit_histogram` computes in plain PyTorch).

Bound on the H100: memory, the keys and payloads read and written once
(24 MB at 1,048,576 keys and two payloads, 7.5 us at 3.35 TB/s).

Like the JAX package, no path sorts with it: ``voxelize._sort_front``
keeps ``torch.sort``, as the JAX downsample keeps ``lax.sort``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import _kernels
from ..core.errors import CwipcError

MIN_N = 8192
RADIX = 256
PASSES = 4
TILE_KEYS = 4096  # sort.cu's keys per tile (one block each)
MAX_PAYLOADS = 4  # payloads one launch of sort.cu carries


def _check(what: str, key: torch.Tensor, payloads) -> int:
    n = key.shape[0] if key.dim() == 1 else -1
    if n < MIN_N or n & (n - 1):
        raise CwipcError(f"{what}: need 1-d arrays of a power-of-two length >= {MIN_N}, got {tuple(key.shape)}")
    if n >= 1 << 31:
        raise CwipcError(f"{what}: {n} keys do not fit int32 indices")
    for i, t in enumerate((key, *payloads)):
        _kernels.expect(what, "key" if i == 0 else f"payload {i - 1}", t, torch.int32, (n,))
    return n


@dataclass(frozen=True)
class SortPlan:
    """What one launch of sort.cu needs for n keys."""

    tiles: int  # tiles of TILE_KEYS keys: the blocks of each pass
    status_words: int  # 64-bit look-back words: one per (pass, tile, digit)
    scratch_bytes: int  # digit counts [4][256] and tile counters [4] (int32), then the status words
    launches: int  # the memset, the histogram and one launch per pass


@functools.lru_cache(maxsize=64)
def sort_plan(n: int) -> SortPlan:
    """The scratch and launches of one sort of n keys (n a multiple of
    TILE_KEYS).  A pass whose digit is uniform still launches; its blocks
    return at once."""
    if n <= 0 or n % TILE_KEYS:
        raise CwipcError(f"sort_plan: n = {n} is not a positive multiple of {TILE_KEYS}")
    tiles = n // TILE_KEYS
    words = PASSES * tiles * RADIX
    return SortPlan(tiles=tiles, status_words=words, scratch_bytes=4 * (PASSES * RADIX + PASSES) + 8 * words,
                    launches=2 + PASSES)


def digit_histogram(key: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sort.cu's upfront histogram: int64 [4, 256],
    the count of each 8-bit digit of the sign-flipped keys, least
    significant digit first."""
    u = key.to(torch.int64) + 2**31  # the sign bit flipped, as unsigned
    return torch.stack([torch.bincount((u >> (8 * p)) & (RADIX - 1), minlength=RADIX) for p in range(PASSES)])


def passes_run(hist, n: int) -> tuple[int, ...]:
    """The digit passes the kernel runs, from the [4, 256] histogram: those
    whose digit is not the same for all n keys; the last pass alone (the
    identity) when every digit is."""
    ran = tuple(p for p in range(PASSES) if not bool((hist[p] == n).any()))
    return ran or (PASSES - 1,)


def sort_by_key_plain(key: torch.Tensor, *payloads: torch.Tensor):
    """Plain PyTorch version of kernel 6 (any device)."""
    skey, order = torch.sort(key, stable=True)
    return (skey, *(torch.gather(p, 0, order) for p in payloads))


def _sort_cuda(key: torch.Tensor, payloads) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """One launch of sort.cu on at most MAX_PAYLOADS payloads: the sorted
    (key, *payloads) and the work buffer, whose first 1,028 int32 hold the
    device's digit counts [4, 256] and tile counters [4] (a counter reads
    the tile count for a pass that ran and 0 for one that was skipped)."""
    n = key.shape[0]
    plan = sort_plan(n)
    dev = key.device
    lib = _kernels.load()
    # the scratch, then keys a, keys b, index a, index b (n each)
    head = -(-plan.scratch_bytes // 16) * 4  # int32, so that the ping-pong arrays start 16-byte aligned
    work = torch.empty(head + 4 * n, dtype=torch.int32, device=dev)
    outs = torch.empty((1 + len(payloads), n), dtype=torch.int32, device=dev)
    w0, o0, row = work.data_ptr(), outs.data_ptr(), 4 * n
    unused = [None] * (MAX_PAYLOADS - len(payloads))  # null pointers
    pin = [t.data_ptr() for t in payloads] + unused
    pout = [o0 + row * (1 + i) for i in range(len(payloads))] + unused
    ping = [w0 + 4 * head + row * i for i in range(4)]
    with _kernels.device_guard(key):
        err = lib.cwipc_sort_pairs(key.data_ptr(), n, len(payloads), *pin, o0, *pout, *ping, w0,
                                   plan.scratch_bytes, _kernels.stream(key))
    _kernels.check(lib, err, "sort_by_key")
    return outs.unbind(0), work


def sort_by_key(key: torch.Tensor, *payloads: torch.Tensor):
    """Sort int32 [N] arrays by the first: returns (key, *payloads), each
    sorted by key (N a power of two >= 8192).  More than MAX_PAYLOADS
    payloads take one launch per group of them: the sort is deterministic
    and stable, so every launch orders the keys the same way."""
    what = "sort_by_key"
    _check(what, key, payloads)
    if _kernels.route(what, key, *payloads) == "cpu":
        return sort_by_key_plain(key, *payloads)
    out = None
    for g in range(0, max(len(payloads), 1), MAX_PAYLOADS):
        got, _ = _sort_cuda(key, payloads[g:g + MAX_PAYLOADS])
        sort_by_key.launches += 1
        out = got if out is None else out + got[1:]
    return out


sort_by_key.launches = 0


def sort3(key: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor):
    """Sort three int32 [N] arrays by the first; see :func:`sort_by_key`."""
    return sort_by_key(key, pa, pb)
