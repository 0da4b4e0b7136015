"""The work a kernel of the exact chain has to do for a frame, from the
frame's inputs and the configuration: never from how a kernel does it.

Each function takes the counts of one frame (``frame_counts``) and gives
(operations, bytes): each input byte counted once, each output byte
once.  A roofline share is the least time these allow, max(bytes / the
card's memory rate, operations / the peak of the unit), over the kernel's
device time.  Where the work depends on the data, it is what this frame
needs: valid points, not the buffer's capacity.
"""

from __future__ import annotations

import torch

RING = 4  # the exact chain's coverage radius in cells (a covered md has its k-th within 4 cells)


def ring_offsets() -> list[tuple[int, int]]:
    """The (dy, dz) column offsets whose cells can hold a point within
    RING cells of a point in column (0, 0): 77 of the 9 x 9, the corners'
    nearest corner being sqrt(18) > 4 cells away."""
    return [(dy, dz) for dy in range(-RING, RING + 1) for dz in range(-RING, RING + 1)
            if (max(abs(dy) - 1, 0) ** 2 + max(abs(dz) - 1, 0) ** 2) < RING * RING]


def frame_counts(ref: dict, chain: dict, points_in: int) -> dict:
    """The counts the work functions read, from the reference's voxels of
    one frame: points in, voxels, kept voxels, and the candidate pairs of
    the column ring (each column's occupancy clamped to the grid's cap,
    the grid anchored at the least cell as the chain anchors it)."""
    vox = ref["vox"] - ref["vox"].amin(0)
    gy, gz, cap = chain["gy"], chain["gz"], chain["cap"]
    ok = (vox[:, 1] < gy) & (vox[:, 2] < gz)
    occ = torch.zeros(gy * gz, dtype=torch.int64, device=vox.device)
    occ.index_add_(0, vox[ok, 1] * gz + vox[ok, 2], torch.ones_like(vox[ok, 1]))
    occ = torch.nn.functional.pad(occ.clamp_max(cap).view(gy, gz), (RING, RING, RING, RING))
    centre = occ[RING:RING + gy, RING:RING + gz]
    ring = torch.zeros_like(centre)
    for dy, dz in ring_offsets():
        ring += occ[RING + dy:RING + dy + gy, RING + dz:RING + dz + gz]
    pairs = int((centre * (ring - 1)).clamp_min(0).sum())
    return {"points_in": int(points_in), "voxels": int(ref["key"].shape[0]),
            "kept": int(ref["keep"].sum()), "ring_pairs": pairs}


def k1_segment_reduce(c: dict) -> tuple[float, float]:
    """Kernel 1, the segmented reduce of the key-sorted points: per point
    its key, packed offset and rgba in (12 bytes) and 8 adds; per voxel
    its key and 8 sums out (36 bytes)."""
    return 8.0 * c["points_in"], 12.0 * c["points_in"] + 36.0 * c["voxels"]


def k4_select(c: dict) -> tuple[float, float]:
    """Kernel 4, exact k-NN selection over the column ring: 8 flops a
    candidate pair (3 differences, 3 squares, 2 adds); each voxel's x, y,
    z in (12 bytes), its sum and k-th distance out (8 bytes)."""
    return 8.0 * c["ring_pairs"], 20.0 * c["voxels"]


def k3_compact(c: dict) -> tuple[float, float]:
    """Kernel 3, the order-preserving compaction: per voxel x, y, z, rgba
    and the keep flag in (17 bytes), per kept voxel 16 bytes out."""
    return float(c["voxels"]), 17.0 * c["voxels"] + 16.0 * c["kept"]


def least_seconds(work: tuple[float, float], peaks: dict, unit: str) -> float:
    """max(bytes / memory rate, operations / the unit's peak)."""
    ops, nbytes = work
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks[unit])
