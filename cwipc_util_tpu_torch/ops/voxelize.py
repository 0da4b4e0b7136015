"""Voxel-grid downsample: Morton sort + segmented reduce of the runs.

The port of cwipc_util_tpu/ops/voxelize.py.  Each
occupied voxel emits one point: the mean of its points' x, y, z, r, g, b
and the OR of their tiles (PCL VoxelGrid semantics, single grid — see the
JAX module's docstring).  Steps, as in the JAX chip path:

1. the front: ``v = floor(xyz * (1/cell))`` in f32, rebased by the cloud
   minimum, interleaved into a 30-bit Morton key (10 bits per axis); the
   in-voxel offset quantized to 10 bits per axis and packed into one int32;
2. one ``torch.sort`` of the key, whose order carries the packed offset
   and rgba along (stability is not needed: the sums below are exact).
   Kernel 6 (ops/sort_kernel.py) sorts the same operands; it is not wired
   in here, as the JAX downsample keeps ``lax.sort``;
3. kernel 1 (ops/segment_reduce.py) reduces the runs of equal keys;
4. ``_reduce_runs_cm`` rebuilds centroids as (v + sum(frac)/cnt) * cell
   and truncated mean colors, exactly as ``_reduce_runs_pallas_cm`` does.

The output is therefore bit-equal to the JAX package's chip path and
allclose (about one ulp) to its XLA CPU path, which averages
``(v + frac) * cell`` instead.  Points come out in Morton order.

Scenes 1023 cells or wider take the exact-key path (``exact_keys``, the
JAX ``voxelize.py:259-303``): the points are ordered by (Morton key, vx,
vy, vz), and ``_reduce_segments`` averages each run of equal voxel
coordinates in f32.  The JAX package's merged (vy, vz) form gives the same
voxels in the same order, so it has no separate path here.  The sort is two
stable ``torch.sort`` calls on packed int64 keys; the sums are
``index_add_``, as the JAX package leaves them to an XLA segment sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.buffers import PointBuffer, pack_rgba, unpack_rgba
from ..core.errors import CwipcError
from ..utils.trace import span
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


def _cell_f32(cellsize):
    """(cell, 1/cell), each rounded to f32 as the JAX package rounds them
    (IEEE f32 division is correctly rounded on the host and on the card):
    Python floats for a number, 0-dim f32 tensors for a 0-dim tensor, so a
    cell size computed on the device (the codec's step) is never read by
    the host."""
    if isinstance(cellsize, torch.Tensor):
        cell = cellsize.to(torch.float32)
        return cell, torch.ones_like(cell) / cell
    cell = np.float32(cellsize)
    return float(cell), float(np.float32(1.0) / cell)


def _voxel_keys(valid: torch.Tensor, scaled: torch.Tensor):
    """The voxel coordinates v = floor(scaled), clamped, int32 [n, 3]; the
    rebase origin (the valid points' minimum, 0 without any), int32 [3];
    the Morton keys of the rebased coordinates clamped to 10 bits, int32
    [n], INT32_MAX where not valid."""
    v = torch.clamp(torch.floor(scaled).to(torch.int32), -_CLAMP, _CLAMP)
    vmin = torch.where(valid[:, None], v, SENTINEL).amin(dim=0)
    vmin_safe = torch.where(vmin == SENTINEL, 0, vmin)
    vm = torch.clamp(v - vmin_safe, 0, _MORTON_MAX)
    return v, vmin_safe, torch.where(valid, morton3(vm[:, 0], vm[:, 1], vm[:, 2]), SENTINEL)


def _front(buf: PointBuffer, cellsize):
    """Step 1: the Morton keys (INT32_MAX past the count) and the packed
    in-voxel offsets, int32 [capacity], and the rebase origin int32 [3]."""
    _, inv = _cell_f32(cellsize)
    scaled = buf.xyz * inv
    v, vmin_safe, mkey = _voxel_keys(buf.valid_mask(), scaled)
    q = torch.clamp(((scaled - v.to(torch.float32)) * 1024.0).to(torch.int32), 0, 1023)
    fracs = (q[:, 0] << 20) | (q[:, 1] << 10) | q[:, 2]
    return mkey, fracs, vmin_safe


def _sort_front(buf: PointBuffer, cellsize):
    """Steps 1-2: the front, sorted by key with ``torch.sort``.

    Returns (smk, sfr, srgba, vmin_safe): the sorted keys, packed offsets
    and rgba, all int32 [capacity], and the rebase origin int32 [3]."""
    mkey, fracs, vmin_safe = _front(buf, cellsize)
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
    with span("cwipc.downsample"):
        smk, sfr, srgba, vmin_safe = _sort_front(buf, cellsize)
        rows, key, nseg = segment_reduce_sorted(smk, sfr, srgba, out_capacity)
        return _reduce_runs_cm(rows, key, nseg, vmin_safe, cellsize, out_capacity)


def _reduce_segments(new_seg, sx, sy, sz, srgba, count, ocap: int) -> PointBuffer:
    """Average the runs that ``new_seg`` starts in the sorted points: the
    port of the JAX ``_reduce_segments_xla``.  Per run, f32 sums of x, y,
    z, r, g, b and the count (``index_add_``), the mean colour truncated as
    PCL stores it, and the OR of the tiles.  Points at or past ``count``,
    and runs at or past ``ocap``, go to a sink row that is cut off."""
    cap = new_seg.shape[0]
    dev = new_seg.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    seg = torch.cumsum(new_seg, 0, dtype=torch.int32) - 1
    last = torch.clamp(count - 1, 0, max(cap - 1, 0)).long()
    # index_select, not seg[last]: a 0-dim index tensor would be read by the host
    total = torch.where(count > 0, seg.index_select(0, last.view(1)).view(()) + 1, 0) if cap else torch.zeros_like(count)
    row = torch.where((idx < count) & (seg < ocap), seg, ocap).long()
    r, g, b, tile = unpack_rgba(srgba)
    bits = (tile[:, None] >> torch.arange(8, dtype=torch.int32, device=dev)) & 1
    channels = torch.cat([
        torch.stack([sx, sy, sz, r.float(), g.float(), b.float(), torch.ones_like(sx)], -1),
        bits.float(),
    ], -1)
    sums = torch.zeros((ocap + 1, 15), dtype=torch.float32, device=dev).index_add_(0, row, channels)[:ocap]
    denom = torch.clamp_min(sums[:, 6], 1.0)[:, None]
    mean = sums[:, 0:6] / denom
    out_tile = ((sums[:, 7:15] > 0).to(torch.int32) << torch.arange(8, dtype=torch.int32, device=dev)).sum(
        -1, dtype=torch.int32)
    out_count = torch.clamp_max(total, ocap).to(torch.int32)
    out_valid = torch.arange(ocap, dtype=torch.int32, device=dev) < out_count
    mean_rgb = mean[:, 3:6].to(torch.int32)  # PCL truncates on store
    rgba = pack_rgba(mean_rgb[:, 0], mean_rgb[:, 1], mean_rgb[:, 2], out_tile)
    return PointBuffer(
        xyz=torch.where(out_valid[:, None], mean[:, 0:3], 0.0),
        rgba=torch.where(out_valid, rgba, 0),
        count=out_count,
    )


def _downsample_exact(buf: PointBuffer, cellsize, ocap: int) -> PointBuffer:
    """The exact-key path: voxels ordered by (Morton key, vx, vy, vz), so
    a clamped Morton key never merges two voxels.

    The lexicographic order is two stable sorts of int64 keys, the minor
    key first: ka = (Morton key, vx) and kb = (vy, vz), each coordinate
    offset to be non-negative.  Padding points carry the sentinel Morton
    key, so they sort last."""
    _, inv = _cell_f32(cellsize)
    valid = buf.valid_mask()
    v, _, mkey = _voxel_keys(valid, buf.xyz * inv)
    v64 = v.long()
    ka = (mkey.long() << 32) | (torch.where(valid, v64[:, 0], SENTINEL) + 2**31)
    kb = torch.where(valid, ((v64[:, 1] + 2**30) << 31) | (v64[:, 2] + 2**30), 0)
    order = torch.sort(kb, stable=True).indices
    order = order[torch.sort(ka[order], stable=True).indices]
    ska, skb = ka[order], kb[order]
    first = torch.arange(ka.shape[0], device=ka.device) == 0
    new_seg = first | (ska != torch.roll(ska, 1)) | (skb != torch.roll(skb, 1))
    sxyz = buf.xyz[order]
    return _reduce_segments(new_seg, sxyz[:, 0], sxyz[:, 1], sxyz[:, 2], buf.rgba[order], buf.count, ocap)


def downsample(buf: PointBuffer, cellsize, out_capacity: int | None = None,
               exact_keys: bool = False, merged_exact: bool = False) -> PointBuffer:
    """Voxel-grid downsample at ``cellsize`` (> 0): a Python number or a
    0-dim float tensor on the buffer's device.  The output has capacity
    ``out_capacity`` (default: the input's), in Morton order.

    The fast path (default) needs the scene under 1023 cells per axis;
    ``exact_keys`` takes any scene (``ops.cwipc_downsample`` picks).
    ``merged_exact`` is accepted for the JAX signature and ignored: the
    JAX package's merged (vy, vz) key gives the same voxels in the same
    order, and here both forms would cost the same two int64 sorts."""
    ocap = buf.capacity if out_capacity is None else out_capacity
    if isinstance(cellsize, torch.Tensor) and (cellsize.dim() != 0 or cellsize.device != buf.device):
        raise CwipcError(f"downsample: a tensor cell size must be 0-dim on {buf.device}, got shape"
                         f" {tuple(cellsize.shape)} on {cellsize.device}")
    if exact_keys:
        return _downsample_exact(buf, cellsize, ocap)
    x, y, z, rgba, cnt = downsample_cm(buf, cellsize, ocap)
    return PointBuffer(xyz=torch.stack([x, y, z], dim=-1), rgba=rgba, count=cnt)
