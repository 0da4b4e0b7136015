"""Voxel-grid downsample: Morton sort + segmented reduce of the runs.

The port of the fast path of cwipc_util_tpu/ops/voxelize.py.  Each
occupied voxel emits one point: the mean of its points' x, y, z, r, g, b
and the OR of their tiles (PCL VoxelGrid semantics, single grid — see the
JAX module's docstring).  Steps, as in the JAX chip path:

1. the front: ``v = floor(xyz * (1/cell))`` in f32, rebased by the cloud
   minimum, interleaved into a 30-bit Morton key (10 bits per axis); the
   in-voxel offset quantized to 10 bits per axis and packed into one int32;
2. one ``torch.sort`` of the key, whose order carries the packed offset
   and rgba along (stability is not needed: the sums below are exact);
3. kernel 1 (ops/segment_reduce.py) reduces the runs of equal keys;
4. ``_reduce_runs_cm`` rebuilds centroids as (v + sum(frac)/cnt) * cell
   and truncated mean colors, exactly as ``_reduce_runs_pallas_cm`` does.

The output is therefore bit-equal to the JAX package's chip path and
allclose (about one ulp) to its XLA CPU path, which averages
``(v + frac) * cell`` instead.  Points come out in Morton order.

The exact-key path for scenes 1023 cells or wider is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.buffers import PointBuffer, pack_rgba
from .segment_reduce import SENTINEL, segment_reduce_sorted

# Quantized coordinates are clamped to +/-2^29 so the sentinel (INT32_MAX)
# stays strictly larger than any real voxel id.
_CLAMP = 1 << 29
_MORTON_BITS = 10
_MORTON_MAX = (1 << _MORTON_BITS) - 1


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are two zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _unpart1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2: extract every third bit back to 10 bits."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton3(vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor) -> torch.Tensor:
    """30-bit Morton interleave of three 10-bit coordinates (int32 in/out)."""
    return (_part1by2(vz) << 2) | (_part1by2(vy) << 1) | _part1by2(vx)


def _cell_f32(cellsize) -> tuple[float, float]:
    """(cell, 1/cell), each rounded to f32 as the JAX package rounds them."""
    cell = np.float32(cellsize)
    return float(cell), float(np.float32(1.0) / cell)


def _sort_front(buf: PointBuffer, cellsize):
    """Steps 1-2: Morton keys and packed offsets, sorted by key.

    Returns (smk, sfr, srgba, vmin_safe): the sorted keys (INT32_MAX past
    the count), packed offsets and rgba, all int32 [capacity], and the
    rebase origin int32 [3]."""
    _, inv = _cell_f32(cellsize)
    valid = buf.valid_mask()
    scaled = buf.xyz * inv
    v = torch.clamp(torch.floor(scaled).to(torch.int32), -_CLAMP, _CLAMP)
    vmin = torch.where(valid[:, None], v, SENTINEL).amin(dim=0)
    vmin_safe = torch.where(vmin == SENTINEL, 0, vmin)
    vm = torch.clamp(v - vmin_safe, 0, _MORTON_MAX)
    mkey = torch.where(valid, morton3(vm[:, 0], vm[:, 1], vm[:, 2]), SENTINEL)
    q = torch.clamp(((scaled - v.to(torch.float32)) * 1024.0).to(torch.int32), 0, 1023)
    fracs = (q[:, 0] << 20) | (q[:, 1] << 10) | q[:, 2]
    smk, order = torch.sort(mkey)
    sfr = torch.gather(fracs, 0, order)
    srgba = torch.gather(buf.rgba, 0, order)
    return smk, sfr, srgba, vmin_safe


def _reduce_runs_cm(rows, key, nseg, vmin_safe, cellsize, ocap: int):
    """Step 4: centroids and colors from kernel 1's run sums; channel-major
    (x, y, z, rgba, count), zero past the count."""
    cell, _ = _cell_f32(cellsize)
    cnt = rows[6]
    denom = torch.clamp_min(cnt, 1.0)
    vx = _unpart1by2(key) + vmin_safe[0]
    vy = _unpart1by2(key >> 1) + vmin_safe[1]
    vz = _unpart1by2(key >> 2) + vmin_safe[2]
    mx = (vx.to(torch.float32) + rows[0] / denom) * cell
    my = (vy.to(torch.float32) + rows[1] / denom) * cell
    mz = (vz.to(torch.float32) + rows[2] / denom) * cell
    mean_rgb = (rows[3:6] / denom).to(torch.int32)  # PCL truncates on store
    tile = rows[7].to(torch.int32)
    out_count = torch.clamp_max(nseg, ocap)
    out_valid = torch.arange(ocap, dtype=torch.int32, device=rows.device) < out_count
    rgba = pack_rgba(mean_rgb[0], mean_rgb[1], mean_rgb[2], tile)
    return (
        torch.where(out_valid, mx, 0.0),
        torch.where(out_valid, my, 0.0),
        torch.where(out_valid, mz, 0.0),
        torch.where(out_valid, rgba, 0),
        out_count,
    )


def downsample_cm(buf: PointBuffer, cellsize, out_capacity: int):
    """Channel-major fast-path downsample for the fused chain: returns
    (x, y, z, rgba, count), each of capacity ``out_capacity``; voxels past
    it are dropped."""
    smk, sfr, srgba, vmin_safe = _sort_front(buf, cellsize)
    rows, key, nseg = segment_reduce_sorted(smk, sfr, srgba, out_capacity)
    return _reduce_runs_cm(rows, key, nseg, vmin_safe, cellsize, out_capacity)


def downsample(buf: PointBuffer, cellsize, out_capacity: int | None = None) -> PointBuffer:
    """Voxel-grid downsample at ``cellsize`` (> 0) on the fast path, for
    scenes under 1023 cells per axis.  The output has capacity
    ``out_capacity`` (default: the input's), in Morton order."""
    ocap = buf.capacity if out_capacity is None else out_capacity
    x, y, z, rgba, cnt = downsample_cm(buf, cellsize, ocap)
    return PointBuffer(xyz=torch.stack([x, y, z], dim=-1), rgba=rgba, count=cnt)
