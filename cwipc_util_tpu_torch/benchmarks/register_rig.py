"""Time ``cwipc register`` on a synthetic 4-camera rig, stage by stage.

The rig is the one of ``chip_smoke.py`` phase 17 (b): the 160k-point
synthetic body seen by 4 simulated cameras (simulatecams seed 5, 2 mm
noise seed 6), each camera's points moved by a random 3 cm / 0.06 rad
transform and written to a PLY recording.  ``register --nocoarse
--nofloor -v`` then runs on the recordings in process, ``--reps`` times,
each from a fresh cameraconfig, with a synchronize before and after.
Each run prints one JSON line: its wall seconds, the script's own stage
seconds and its overall correspondences.

    python cwipc_util_tpu_torch/benchmarks/register_rig.py [--root CHECKOUT] [--reps N]
        [--npoints N] [--device cpu]

``--root`` times the package of another checkout (a parent commit
unpacked beside this one, say), so two versions can be compared on one
card: run them in turns, A B B A.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

CAMERAS, SEED = 4, 5
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def perturbation(seed: int, max_translation: float, max_rotation: float) -> np.ndarray:
    """A random rigid transform, as ``cwipc create_analysis_test`` makes them."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-max_translation, max_translation, 3)
    angle = rng.uniform(-max_rotation, max_rotation)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.identity(4)
    T[:3, :3] = np.identity(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)
    T[:3, 3] = t
    return T


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO,
                        help="checkout whose cwipc_util_tpu_torch is timed (default: this one)")
    parser.add_argument("--reps", type=int, default=2, help="register runs (default 2)")
    parser.add_argument("--npoints", type=int, default=160000, help="points of the synthetic body (default 160000)")
    parser.add_argument("--device", default="cuda", help="device of the clouds and the registration (default cuda)")
    args = parser.parse_args()

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import cwipc_util_tpu_torch as port
    from cwipc_util_tpu_torch.filters.noise import NoiseFilter
    from cwipc_util_tpu_torch.filters.simulatecams import SimulatecamsFilter
    from cwipc_util_tpu_torch.registration.util import cwipc_transform
    from cwipc_util_tpu_torch.scripts import cwipc_register

    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        raise SystemExit(f"register_rig: imported {port.__file__}, not the package of {root}")
    device = torch.device(args.device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize()

    work = tempfile.mkdtemp(prefix="cwipc-register-rig-")
    here = os.getcwd()
    try:
        body = port.cwipc_synthetic(0, args.npoints, device=device)
        body.start()
        pc = body.get()
        body.stop()
        pc = NoiseFilter(0.002, seed=SEED + 1).filter(SimulatecamsFilter(CAMERAS, hard=False, seed=SEED).filter(pc))
        counts = []
        for cam in range(CAMERAS):
            moved = cwipc_transform(port.cwipc_tilefilter(pc, 1 << cam), perturbation(100 + cam, 0.03, 0.06))
            counts.append(moved.count())
            port.cwipc_write(os.path.join(work, f"camera{cam}.ply"), moved, port.CWIPC_FLAGS_BINARY)
        os.chdir(work)
        for rep in range(args.reps):
            config = os.path.join(work, "cameraconfig.json")
            if os.path.exists(config):
                os.remove(config)
            out = io.StringIO()
            sys.argv = ["cwipc register", "--nocoarse", "--nofloor", "-v", "--device", args.device, work]
            sync()
            t_0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cwipc_register.main()
            sync()
            wall = time.perf_counter() - t_0
            text = out.getvalue()
            stages = re.findall(r"register: (alignment \w+)[^(]*\(analyzer ran (\d+\.\d+)s\)"
                                r"|register: (.*) ran for (\d+\.\d+)s", text)
            print(json.dumps({
                "root": root, "rep": rep, "rc": rc, "points": counts, "wall_s": wall,
                "stages_s": {a or c: float(b or d) for a, b, c, d in stages},
                "overall": [float(v) for v in re.findall(r"overall correspondence (\d+\.\d+)", text)],
            }), flush=True)
            if rc:
                print(text[-2000:], file=sys.stderr)
                return rc
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
