"""A traced or timed run of a path that has no cell yet: today the fast
chain (``downsample_outliers_tilefilter``, W 16), which the host's
launches pace (PERF.md, sections 5 and 7).

    python3 portbench/explore.py --config body-8ivfb-1m --seed 5 --seconds 10 --trace 1

It runs the harness's own loop (harness/cell.py) on a configuration under
the fast chain's closed loop, unchecked, and prints the result line as
run.py does, with the metrics named below.  Needs the card.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

FAST = {"loop": "closed", "entry": "downsample_outliers_tilefilter",
        "args": ["cellsize", "k", "mult", "tile", "out_capacity", "window"], "judge": None, "trace_cycles": 4}
WINDOW = 16
METRICS = {0: [("frames_per_s", "frames/s"), ("frame_ms_p95", "ms"), ("setup_s", "s")],
           1: [("launches_per_frame", "launches"), ("host_syncs_per_frame", "syncs"), ("device_idle_pct", "%")]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("explore.py: needs a CUDA card", file=sys.stderr)
        return 3
    from harness import cell, spec

    cfg = spec.config_file(a.config)
    cfg["chain"]["window"] = WINDOW
    metrics = [{"name": n, "unit": u} for n, u in METRICS[a.trace]]
    line, _ = cell.run_cell(cfg=cfg, traffic=FAST, metrics=metrics, seed=a.seed, seconds=a.seconds,
                            traced=bool(a.trace), t_start=T_START)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
