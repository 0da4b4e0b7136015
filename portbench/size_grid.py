"""How a configuration's fixed sizes were found: the input capacity, the
post-downsample capacity and the column grid (gy, gz, cap).

    python3 portbench/size_grid.py <config> [--seeds 1 2 3 4] [--device cuda]

For every frame of the sequence at each seed it takes the reference's
voxel downsample and prints the most points, the most voxels, the (y, z)
extents in cells and the fullest column, then the sizes as the port's
public route sizes them (``cwipc_remove_outliers``: extents rounded up to
32 cells, the fullest column up to 4; capacities the next power of two).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import spec  # noqa: E402
from reference.exact_chain import downsample  # noqa: E402


def pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def sizes(cfg: dict, seeds, device) -> dict:
    cell = cfg["chain"]["cellsize"]
    most_pts = most_vox = ext_y = ext_z = fullest = 0
    make_sequence = spec.generator(cfg)
    for seed in seeds:
        frames, _ = make_sequence(cfg, seed, device)
        for xyz, rgba, count in frames:
            n = int(count)
            vox = downsample(xyz, rgba, n, cell)["vox"]
            vr = vox - vox.amin(0)
            ext_y, ext_z = max(ext_y, int(vr[:, 1].max()) + 1), max(ext_z, int(vr[:, 2].max()) + 1)
            _, per_col = torch.unique(vr[:, 1] * 4096 + vr[:, 2], return_counts=True)
            fullest = max(fullest, int(per_col.max()))
            most_pts, most_vox = max(most_pts, n), max(most_vox, vox.shape[0])
    return {"most_points": most_pts, "most_voxels": most_vox, "extent_y": ext_y, "extent_z": ext_z,
            "fullest_column": fullest, "capacity": pow2(most_pts), "out_capacity": pow2(most_vox),
            "gy": -(-ext_y // 32) * 32, "gz": -(-ext_z // 32) * 32, "cap": max(8, -(-fullest // 4) * 4)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    cfg = spec.config_file(a.config)
    print(json.dumps({"config": a.config, "seeds": a.seeds, **sizes(cfg, a.seeds, a.device)}))


if __name__ == "__main__":
    main()
