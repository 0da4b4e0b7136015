"""The comparison that decides ``correct`` for the exact cleaning chain.

The program's output for a frame is the kept points (float32 centroids,
rgba words) in its order, and their count.  Each output point names its
voxel: its centroid lies at least half a 1/1024 step inside the cell, so
``floor(x / cell)`` recovers the cell.  Against the reference of the
same frame (``exact_chain.run``) the numbers are:

* ``stray``: output points whose cell is no voxel of the reference, or
  that repeat a voxel or break the Morton order.  Exact: limit 0.
* ``keep_margin``: over the voxels kept by one side only, the largest
  distance of the reference's md from its threshold, as a share of the
  threshold.  A decision may differ only where float32 rounding of md
  can carry it over the threshold.
* ``centroid_err_m``: the largest distance, along any axis, between an
  output point and the reference's centroid of its voxel, in metres.
* ``color_wrong``: output points whose r, g, b or tile byte differ from
  the reference's.  Exact: limit 0.

Each number is the worst over the frames judged; ``LIMITS`` holds the
limit each is compared with (``PERF.md`` gives the readings they were set
from).
"""

from __future__ import annotations

import torch

from .exact_chain import morton

LIMITS = {"stray": 0, "keep_margin": 1e-3, "centroid_err_m": 1e-4, "color_wrong": 0}


def judge_frame(ref: dict, out_xyz: torch.Tensor, out_rgba: torch.Tensor, out_n: int, cellsize: float) -> dict:
    """The four numbers for one frame: ``ref`` from ``exact_chain.run`` in
    float64, the output's first ``out_n`` points on ref's device."""
    dev = ref["key"].device
    xyz = out_xyz[:out_n].to(dev, torch.float64)
    rgba = out_rgba[:out_n].to(dev).to(torch.int64) & 0xFFFFFFFF
    cell = float(torch.tensor(cellsize, dtype=torch.float32))
    vm = torch.floor(xyz / cell).to(torch.int64) - ref["vmin"]
    inside = ((vm >= 0) & (vm < 1024)).all(1)
    key = torch.where(inside, morton(vm.clamp(0, 1023)), -1)
    m = ref["key"].shape[0]
    j = torch.searchsorted(ref["key"], key).clamp_max(m - 1)
    found = inside & (ref["key"][j] == key)
    ordered = torch.ones_like(found)
    ordered[1:] = key[1:] > key[:-1]
    stray = int((~(found & ordered)).sum())

    jf = j[found]
    mine = torch.zeros(m, dtype=torch.bool, device=dev)
    mine[jf] = True
    differ = mine ^ ref["keep"]
    thr = ref["thr"]
    margin = ((ref["md"][differ] - thr).abs() / thr).max() if bool(differ.any()) else torch.zeros((), dtype=thr.dtype)

    err = (xyz[found] - ref["centroid"][jf].to(torch.float64)).abs().max() if jf.numel() else torch.zeros(())
    want = (ref["tile"][jf] << 24) | (ref["rgb"][jf, 0] << 16) | (ref["rgb"][jf, 1] << 8) | ref["rgb"][jf, 2]
    color = int((rgba[found] != want).sum())
    return {"stray": stray, "keep_margin": float(margin), "centroid_err_m": float(err), "color_wrong": color}


def worst(readings: list[dict]) -> dict:
    """The worst of each number over the frames judged."""
    return {name: max(r[name] for r in readings) for name in LIMITS}


def verdict(numbers: dict) -> bool:
    """True where every number is within its limit."""
    return all(numbers[name] <= limit for name, limit in LIMITS.items())
