"""Point-cloud operators on wrapper objects — the reference op API.

The port of the slice's entry points of cwipc_util_tpu/ops/__init__.py.
Each op takes and returns a :class:`cwipc_pointcloud_wrapper`; the work
runs on the wrapper's device.  Timestamp and cellsize bookkeeping as in
the reference: downsample's result cellsize is max(input cellsize,
|requested|) (cwipc_filters.cpp:103-106); tilefilter passes both through.

Not ported yet: remove_outliers, tilemap, colormap, crop, join.
"""

from __future__ import annotations

import torch

from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper
from . import compaction, voxelize

__all__ = ["cwipc_downsample", "cwipc_tilefilter"]


def _wrap(buf, template: cwipc_pointcloud_wrapper, cellsize=None):
    return cwipc_pointcloud_wrapper(
        buf,
        template.timestamp(),
        template.cellsize() if cellsize is None else cellsize,
    )


def cwipc_downsample(
    pc: cwipc_pointcloud_wrapper, voxelsize: float
) -> cwipc_pointcloud_wrapper:
    """Voxelize to cubes of the given size; negative selects the plain grid
    (the same math here)."""
    cellsize = abs(float(voxelsize))
    if pc.cellsize() >= cellsize:
        cellsize = pc.cellsize()
    if cellsize <= 0:
        # zero-size voxels: no-op copy (a 1/cellsize quantization would
        # divide by zero)
        return pc.clone()
    buf = pc._access_buffer()
    # The single-Morton-key fast path is exact within a 1024^3-cell domain.
    # The bounding box comes from the host cache when there is one.
    if pc.count() == 0:
        extent_cells = 0.0
    elif pc._np_cache is not None:
        arr = pc._np_cache
        extent_cells = float(
            max(
                arr["x"].max() - arr["x"].min(),
                arr["y"].max() - arr["y"].min(),
                arr["z"].max() - arr["z"].min(),
            )
        ) / cellsize
    else:
        valid = buf.valid_mask()[:, None]
        lo = torch.where(valid, buf.xyz, 3.0e38).amin(dim=0)
        hi = torch.where(valid, buf.xyz, -3.0e38).amax(dim=0)
        extent_cells = float((hi - lo).max()) / cellsize
    if extent_cells >= 1023.0:
        raise CwipcError(
            "cwipc_downsample: scenes 1023 cells or wider need the exact-key"
            " downsample, which is not yet ported"
        )
    out = voxelize.downsample(buf, cellsize)
    return _wrap(out, pc, cellsize=cellsize)


def cwipc_tilefilter(pc: cwipc_pointcloud_wrapper, tile: int) -> cwipc_pointcloud_wrapper:
    """Select points whose tile equals `tile` (0 selects all points)."""
    buf = compaction.tilefilter(pc._access_buffer(), tile)
    return _wrap(buf, pc)
