"""Kernel 2: Morton-window kNN mean distance.

Replaces cwipc_util_tpu/ops/pallas_window_knn.py (``_window_knn_kernel``,
its pallas_call at :203, wrappers ``window_knn_mean_distance`` :139 and
``_cm`` :151).  On CUDA tensors :func:`window_knn_mean_distance_cm` launches
``csrc/window_knn.cu``; on CPU tensors it runs the plain PyTorch version,
:func:`window_knn_mean_distance_plain` (the spec
``outliers._mean_knn_dist_window`` on channel-major rows).

Bound on the H100: memory by the bytes (16 a point, under 4 MB at the
chain's 229,376 points), the instruction rate in practice; the distances and their
selection stay in registers.  The selection follows the TPU kernel's two
regimes: where at most six of the 2W candidates go (the fast chain's k 30
of 32), max-passes drop the largest; otherwise a merge-and-keep-lower
network keeps the kk smallest (the CUDA source counts both).  Unlike the
TPU kernel, which truncated 6 mantissa bits of d² to pack a candidate
index, the CUDA kernel selects on exact values, so it matches the XLA spec
up to the order of the final sum of square roots.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..core.errors import CwipcError
from .outliers import _mean_knn_dist_window

MAX_WINDOW = 32  # csrc/window_knn.cu's halo and network width bound
DROP_MAX = 6  # csrc/window_knn.cu's most max-passes, the TPU kernel's (pallas_window_knn.py:100)


def window_knn_mean_distance_plain(x, y, z, count, k: int, window: int):
    """Plain PyTorch version of kernel 2 (any device)."""
    return _mean_knn_dist_window(torch.stack([x, y, z], dim=-1), count, k, window)


def window_knn_mean_distance_cm(x, y, z, count, k: int, window: int = 32):
    """Per-point mean distance to the k nearest among the +/-window array
    neighbours, on coordinate rows x, y, z (f32 [n]) with a 0-d int32
    ``count``.  Returns md f32 [n], 0 past count."""
    what = "window_knn_mean_distance_cm"
    n = x.shape[0]
    kind = _kernels.expect_rows(what, ("x", "y", "z"), (x, y, z), torch.float32, n)
    if count.dtype is not torch.int32 or count.dim() != 0 or count.device != x.device:
        _kernels.expect(what, "count", count, torch.int32, ())
        _kernels.route(what, x, count)
    if not 1 <= window <= MAX_WINDOW or k < 1:
        raise CwipcError(f"{what}: need 1 <= window <= {MAX_WINDOW} and k >= 1, got {window}, {k}")
    if kind == "cpu":
        return window_knn_mean_distance_plain(x, y, z, count, k, window)
    lib = _kernels.load()
    md = torch.empty(n, dtype=torch.float32, device=x.device)
    with _kernels.device_guard(x):
        err = lib.cwipc_window_knn(x.data_ptr(), y.data_ptr(), z.data_ptr(), count.data_ptr(), n, window,
                                   min(k, 2 * window), md.data_ptr(), _kernels.stream(x))
    _kernels.check(lib, err, what)
    window_knn_mean_distance_cm.launches += 1
    return md


window_knn_mean_distance_cm.launches = 0
