"""Kernel 7: the selection scan probe.

Replaces benchmarks/sel_roofline.py (``_scan_kernel``, its pallas_call at
:114 in ``_scan_program`` :112): the TPU's micro-kernel for the "compare and
count" scan that kernel 4's bisection runs, kept as the port's yardstick of
how fast that scan can go on the card.  On CUDA tensors :func:`scan_program`
launches ``csrc/scan_probe.cu``; on CPU tensors it runs
:func:`scan_program_plain`.

``x`` is [S, ntiles * 128]; the result is f32 [8, ntiles * 128], each row
the same accumulator: over t = 0..T-1 in order, in f32, per column

=====  ==============================================  ==================
form   per step                                         input
=====  ==============================================  ==================
i32    count of ``x <= t*65537 + 12345``                int32
i16    count of ``x <= int16(t*17 + 11)``               int16
bf16   count of ``x <= bf16(f32(t)*0.001 + 0.5)``       bfloat16
mxu    the i32 count, on the tensor cores               int32
add    the column's int32 sum, wrapping                 int32
=====  ==============================================  ==================

Counts are exact integers in both versions.  The TPU kernel sums the bf16
indicator in bf16, which rounds above 256 (and the i16 count in int16):
the two packages agree bit for bit while S stays at most 256.

:func:`make_inputs` builds the inputs as ``scan_rates`` does (numpy's
``default_rng(0)``), so the card scans the data the TPU scanned.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..core.errors import CwipcError

FORMS = ("i32", "i16", "bf16", "mxu", "add")
DTYPES = {"i32": torch.int32, "i16": torch.int16, "bf16": torch.bfloat16, "mxu": torch.int32, "add": torch.int32}
S, T, NTILES = 1536, 64, 64  # sel_roofline.py's shape: the mid-tier scan


def make_inputs(s: int = S, ntiles: int = NTILES) -> dict:
    """Host inputs per form, as ``scan_rates`` makes them: the int32 bits
    of [0, 2^30), their top 15 bits as int16, and uniform [0, 1) floats
    rounded to bfloat16."""
    rng = np.random.default_rng(0)
    bits32 = rng.integers(0, 1 << 30, (s, ntiles * 128), dtype=np.int32)
    floats = rng.random((s, ntiles * 128), dtype=np.float32)
    i16 = torch.from_numpy((bits32 >> 15).astype(np.int16))
    b32 = torch.from_numpy(bits32)
    return {"i32": b32, "add": b32, "mxu": b32, "i16": i16, "bf16": torch.from_numpy(floats).to(torch.bfloat16)}


def _mid(form: str, t: int):
    if form in ("i32", "mxu"):
        return int(np.int32(np.uint32((t * 65537 + 12345) & 0xFFFFFFFF).view(np.int32)))
    if form == "i16":
        return int(np.uint16((t * 17 + 11) & 0xFFFF).view(np.int16))
    m = np.float32(t) * np.float32(0.001) + np.float32(0.5)
    return torch.tensor(float(m), dtype=torch.float32).to(torch.bfloat16)


def _check(what: str, x: torch.Tensor, form: str, t: int) -> None:
    if form not in FORMS:
        raise CwipcError(f"{what}: form {form!r} is not one of {FORMS}")
    if x.dim() != 2 or x.shape[1] % 128:
        raise CwipcError(f"{what}: x must be [S, ntiles * 128], got {tuple(x.shape)}")
    if x.dtype != DTYPES[form]:
        raise CwipcError(f"{what}: form {form!r} takes {DTYPES[form]}, got {x.dtype}")
    if not x.is_contiguous():
        raise CwipcError(f"{what}: x is not contiguous")
    if t < 0:
        raise CwipcError(f"{what}: negative step count {t}")


def scan_program_plain(x: torch.Tensor, form: str, t: int = T) -> torch.Tensor:
    """Plain PyTorch version of kernel 7 (any device)."""
    _check("scan_program_plain", x, form, t)
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    if form == "add":
        s64 = x.to(torch.int64).sum(0)
        step = (((s64 + 2**31) % 2**32) - 2**31).to(torch.int32).to(torch.float32)
    for i in range(t):
        if form != "add":
            step = (x <= _mid(form, i)).sum(0).to(torch.float32)
        acc = acc + step
    return acc.expand(8, -1).contiguous()


def scan_program(x: torch.Tensor, form: str, t: int = T) -> torch.Tensor:
    """The probe's output f32 [8, ncols] for x [S, ncols]."""
    what = "scan_program"
    _check(what, x, form, t)
    if _kernels.route(what, x) == "cpu":
        return scan_program_plain(x, form, t)
    lib = _kernels.load()
    s, c = x.shape
    cnt = torch.empty((max(t, 1), c), dtype=torch.int32, device=x.device)
    out = torch.empty((8, c), dtype=torch.float32, device=x.device)
    with _kernels.device_guard(x):
        err = lib.cwipc_scan_probe(x.data_ptr(), FORMS.index(form), s, c, t, cnt.data_ptr(), out.data_ptr(),
                                   _kernels.stream(x))
    _kernels.check(lib, err, what)
    scan_program.launches += 1
    return out


scan_program.launches = 0
