"""Build, load and call the hand-written CUDA kernels in ``csrc/``.

The sources compile at first use, with ``nvcc`` alone, into one shared
library with a plain C interface, loaded through ctypes: one compile per
source, all started together, then one link with the same flags:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu             (each)
    nvcc <same flags> -shared -o _build/libcwipc_kernels_<hash>.so <objs>

* The library lands in ``_build/`` beside this file (git-ignored), named
  by a hash of the sources and flags, so a changed source rebuilds.
* Two processes may build at once: each takes a file lock, looks again,
  and compiles to a private name that is renamed into place.
* ``nvcc`` is looked for on ``PATH``, under ``$CUDA_HOME/bin`` and under
  ``/usr/local/cuda/bin``.  A missing compiler or a failed build raises
  :class:`CwipcError` (with nvcc's stderr); nothing falls back.
* Nothing builds or loads on import, or for CPU tensors: only the first
  kernel launch on a CUDA tensor calls :func:`load`.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` raises if it is not 0.
A wrapper's host work before its launch is on every call's path, so the
helpers here stay cheap: pointers and the stream go to ctypes as plain
ints, and :func:`device_guard` switches devices only where the tensor's
is not already current.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .core.errors import CwipcError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
NVCC_FALLBACK_DIRS = ("/usr/local/cuda/bin",)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (all return int, a cudaError_t)
_SIGNATURES = {
    # key, fr, rgba, n, ocap, work, stream
    "cwipc_segment_reduce": (_P, _P, _P, _I, _I, _P, _P),
    # x, y, z, count, n, window, kk, md, stream
    "cwipc_window_knn": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    # x, y, z, rgba, keep, count, n, work, stream
    "cwipc_compact": (_P, _P, _P, _P, _P, _P, _I, _P, _P),
    # xs, ys, zs, cap, gz, k, row0, nrows, stage, bounds, sums, kth, prof, stream
    "cwipc_cols_select": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # xs, ys, zs, cap, gz, k, row0, nrows, sums, kth, prof, stream (a probe of kernel 4's earlier design)
    "cwipc_cols_select_column_probe": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # rx, ry, rz, qx, qy, qz, cap_r, cap_q, gz, gyz, stage, d2, cid, stream
    "cwipc_nn_select": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # keys, n, npay, 4 payloads in, keys_out, 4 payloads out, keys_a, keys_b, idx_a, idx_b,
    # scratch, scratch_bytes, stream
    "cwipc_sort_pairs": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         ctypes.c_longlong, _P),
    # x, form, s, c, t_steps, per_step, warps_per_strip, strips_per_block, out, stream
    "cwipc_scan_probe": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates += [os.path.join(d, "nvcc") for d in NVCC_FALLBACK_DIRS]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise CwipcError(
        "cannot build the CUDA kernels: nvcc is not on PATH, under"
        " $CUDA_HOME/bin or under " + ", ".join(NVCC_FALLBACK_DIRS)
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Start every command at once, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [proc.communicate()[1] for proc in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise CwipcError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists."""
    digest = _digest()
    out = BUILD_DIR / f"libcwipc_kernels_{digest}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f"{digest}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
        objs = [BUILD_DIR / f".{src.stem}.{digest}.{os.getpid()}.o" for src in _sources()]
        try:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                      for src, obj in zip(_sources(), objs)])
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
            for obj in objs:
                obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.cwipc_kernels_error_string.argtypes = [ctypes.c_int]
            lib.cwipc_kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cwipc_kernels_error_string(err).decode()
        raise CwipcError(f"{what}: CUDA error {err} at launch: {msg}")


def stream(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on the tensor's device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def device_guard(t: torch.Tensor):
    """A context that makes the tensor's CUDA device current for a launch:
    none where it already is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def route(what: str, *tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda': where a wrapper runs, from its tensors' device.

    The plain PyTorch version serves CPU tensors only; CUDA tensors go to
    the kernel.  Any other device, or a mix, raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise CwipcError(f"{what}: tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise CwipcError(f"{what}: no kernel for device {dev}")
    return dev.type


def expect_rows(what: str, names: tuple, tensors: tuple, dtype: torch.dtype, n: int) -> str:
    """:func:`expect` and :func:`route` for tensors that must all be
    contiguous [n] of one dtype on one device, in one pass where they hold
    (they run on every call's path); where one does not, those two raise.
    Returns 'cpu' or 'cuda'."""
    shape = (n,)
    dev = tensors[0].device
    for t in tensors:
        if t.dtype is not dtype or t.shape != shape or t.device != dev or not t.is_contiguous():
            for name, u in zip(names, tensors):
                expect(what, name, u, dtype, shape)
            return route(what, *tensors)
    return dev.type if dev.type in ("cpu", "cuda") else route(what, *tensors)


def expect(what: str, name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Check one kernel argument's dtype, shape and contiguity."""
    if t.dtype != dtype:
        raise CwipcError(f"{what}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise CwipcError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise CwipcError(f"{what}: {name} is not contiguous")
