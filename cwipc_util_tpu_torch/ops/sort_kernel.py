"""Kernel 6: sort of int32 keys carrying int32 payloads.

Replaces cwipc_util_tpu/ops/pallas_sort.py (``_kernel``, its pallas_call
at :169, wrappers ``sort_by_key`` :136 and ``sort3`` :183).  On CUDA
tensors :func:`sort_by_key` launches ``csrc/sort.cu`` (an LSD radix sort of
(key, index) pairs, then one gather per payload); on CPU tensors it runs
:func:`sort_by_key_plain`, ``torch.sort(stable=True)`` and gathers.

The contract is the JAX wrapper's: int32 arrays of one length N, N a power
of two >= 8192; keys in signed int32 order (INT32_MAX pads); payload bits
pass unchanged, NaN patterns included.  Equal keys may come in any order;
both versions here happen to be stable, and nothing may rely on that.

Bound on the H100: memory, the keys and payloads read and written once
(24 MB at 1,048,576 keys and two payloads, 7.5 us at 3.35 TB/s).

Like the JAX package, no path sorts with it: ``voxelize._sort_front``
keeps ``torch.sort``, as the JAX downsample keeps ``lax.sort``.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..core.errors import CwipcError

MIN_N = 8192
RADIX = 256
BLOCK_KEYS = 4096  # sort.cu's keys per block


def _check(what: str, key: torch.Tensor, payloads) -> int:
    n = key.shape[0] if key.dim() == 1 else -1
    if n < MIN_N or n & (n - 1):
        raise CwipcError(f"{what}: need 1-d arrays of a power-of-two length >= {MIN_N}, got {tuple(key.shape)}")
    if n >= 1 << 31:
        raise CwipcError(f"{what}: {n} keys do not fit int32 indices")
    for i, t in enumerate((key, *payloads)):
        _kernels.expect(what, "key" if i == 0 else f"payload {i - 1}", t, torch.int32, (n,))
    return n


def sort_by_key_plain(key: torch.Tensor, *payloads: torch.Tensor):
    """Plain PyTorch version of kernel 6 (any device)."""
    skey, order = torch.sort(key, stable=True)
    return (skey, *(torch.gather(p, 0, order) for p in payloads))


def sort_by_key(key: torch.Tensor, *payloads: torch.Tensor):
    """Sort int32 [N] arrays by the first: returns (key, *payloads), each
    sorted by key (N a power of two >= 8192)."""
    what = "sort_by_key"
    n = _check(what, key, payloads)
    if _kernels.route(what, key, *payloads) == "cpu":
        return sort_by_key_plain(key, *payloads)
    lib = _kernels.load()
    dev = key.device
    nblocks = -(-n // BLOCK_KEYS)
    keys_ab = torch.empty((2, n), dtype=torch.int32, device=dev)
    idx_ab = torch.empty((2, n), dtype=torch.int32, device=dev)
    counts = torch.empty((2, RADIX * nblocks), dtype=torch.int32, device=dev)
    digits = torch.empty((2 * RADIX + 1,), dtype=torch.int32, device=dev)
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in payloads]
    P = _kernels.ptr
    stream = _kernels.stream(key)
    with torch.cuda.device(dev):
        err = lib.cwipc_sort_pairs(
            P(key), n, P(keys_ab[0]), P(keys_ab[1]), P(idx_ab[0]), P(idx_ab[1]),
            P(counts[0]), P(counts[1]), P(digits[:RADIX]), P(digits[RADIX:2 * RADIX]),
            P(digits[2 * RADIX:]), stream,
        )
        _kernels.check(lib, err, what)
        for src, dst in zip(payloads, outs):
            _kernels.check(lib, lib.cwipc_gather_i32(P(src), P(idx_ab[1]), n, P(dst), stream), what)
    sort_by_key.launches += 1
    return (keys_ab[1], *outs)


sort_by_key.launches = 0


def sort3(key: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor):
    """Sort three int32 [N] arrays by the first; see :func:`sort_by_key`."""
    return sort_by_key(key, pa, pb)
