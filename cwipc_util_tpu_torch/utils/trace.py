"""Spans of the exact chain's stages, for ``torch.profiler``.

A span is a ``record_function`` range.  It goes into whatever profiler
session is recording (``cwipc_view --profile``, a benchmark's traced
frames), in the same trace and on the same clock as the session's kernel,
copy and memset records, so the card's idle time can be put on the stage
the host was in.  With no session recording, :func:`span` reads the
profiler's own flag and returns one shared null context: nothing is
entered.

The spans, nested as the calls nest:

* ``cwipc.exact``: ops/chain.py ``downsample_outliers_tilefilter_exact``;
* ``cwipc.downsample``: ops/voxelize.py ``downsample_cm`` (also under the
  fast chain and the codec);
* ``cwipc.grid_build``: ops/cols_knn.py ``_cols_build``, as
  ``cols_knn_mean_distance`` calls it;
* ``cwipc.fixup``: ops/cols_knn.py ``bruteforce_md_subset``.

``cwipc_remove_outliers``'s column-grid route shows the last two too.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a ``torch.profiler`` session records this thread (a session
    records the thread that started it)."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a session records,
    else a shared null context."""
    return torch.profiler.record_function(name) if enabled() else _OFF
