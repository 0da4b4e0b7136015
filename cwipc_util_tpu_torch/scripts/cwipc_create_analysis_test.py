"""cwipc create_analysis_test: build registration test fixtures.

The port of cwipc_util_tpu/scripts/cwipc_create_analysis_test.py: the
cloud is made, split into tiles and given its noise on ``--device``
(default CUDA).

Re-implementation of the reference's fixture generator
(reference: python/cwipc/scripts/cwipc_create_analysis_test.py): take a
cloud (synthetic by default), split it into simulated camera tiles, add
noise, and perturb each tile with a known ground-truth transform — the
input for registration tests with a known answer.
"""

import json
import math
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from .. import cwipc_write, cwipc_write_debugdump
from ..filters.noise import NoiseFilter
from ..filters.simulatecams import SimulatecamsFilter
from ..registration.util import cwipc_transform
from ._scriptsupport import ArgumentParser, activesource_factory_from_args, beginOfRun, endOfRun


def perturbation(seed: int, max_translation: float, max_rotation: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.uniform(-max_translation, max_translation, 3)
    angle = rng.uniform(-max_rotation, max_rotation)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.identity(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)
    T = np.identity(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class AnalysisTestCreator:
    """The fixture generator (reference: cwipc_create_analysis_test.py:21-137):
    describe the simulated cameras and their perturbations, load/generate
    the input cloud, apply the description, save cloud + ground truth."""

    def __init__(self, args):
        self.args = args
        self.verbose = args.verbose > 0
        self.pointcloud = None
        self.result = None
        self.description: List[Dict[str, Any]] = []
        self.ground_truth: Dict[str, Any] = {}

    def create_default_description(self) -> None:
        """One entry per simulated camera: tilemask, perturbation seed and
        bounds (reference: cwipc_create_analysis_test.py:49-68)."""
        self.description = [
            dict(
                tilemask=1 << cam,
                seed=self.args.seed + cam,
                translation=self.args.translation,
                rotation=self.args.rotation,
            )
            for cam in range(self.args.ncamera)
        ]

    def load_input(self, source: Optional[str] = None) -> None:
        """Grab one cloud from the configured source (synthetic unless
        --playback was given)."""
        src = activesource_factory_from_args(self.args)()
        src.start()
        self.pointcloud = src.get()
        src.stop()
        assert self.pointcloud is not None

    def run(self) -> bool:
        from .. import cwipc_join_multi, cwipc_tilefilter

        if not self.description:
            self.create_default_description()
        pc = self.pointcloud
        # soft assignment: points near sector boundaries go to either camera,
        # giving the tiles the overlap fine alignment needs
        pc = SimulatecamsFilter(self.args.ncamera, hard=False, seed=self.args.seed).filter(pc)
        if self.args.noise:
            pc = NoiseFilter(self.args.noise, seed=self.args.seed + 1).filter(pc)

        # perturb each tile with a known transform; save the ground truth
        parts = []
        self.ground_truth = {}
        for entry in self.description:
            tilemask = entry["tilemask"]
            tile_pc = cwipc_tilefilter(pc, tilemask)
            T = perturbation(entry["seed"], entry["translation"], entry["rotation"])
            parts.append(cwipc_transform(tile_pc, T))
            # the aligner should recover the inverse
            self.ground_truth[str(tilemask)] = np.linalg.inv(T).tolist()
        self.result = cwipc_join_multi(parts)
        return True

    def save_output(self, target: str) -> None:
        assert self.result is not None
        if target.endswith(".cwipcdump"):
            cwipc_write_debugdump(target, self.result)
        else:
            cwipc_write(target, self.result)
        gt_file = target + ".gt.json"
        with open(gt_file, "w") as fp:
            json.dump(self.ground_truth, fp, indent=2)
        print(f"create_analysis_test: wrote {target} "
              f"({self.result.count()} points) and {gt_file}")


def main() -> int:
    parser = ArgumentParser(description="Create a registration analysis test fixture")
    parser.add_argument("--ncamera", type=int, default=4, help="Number of simulated cameras")
    parser.add_argument("--noise", type=float, default=0.002, help="Per-point noise distance")
    parser.add_argument("--translation", type=float, default=0.02, help="Max per-camera translation")
    parser.add_argument("--rotation", type=float, default=0.05, help="Max per-camera rotation (radians)")
    parser.add_argument("--seed", type=int, default=42, help="Ground-truth RNG seed")
    parser.add_argument("output", help="Output pointcloud file (.ply or .cwipcdump)")
    args = parser.parse_args()
    beginOfRun(args)
    if not args.synthetic and not args.playback:
        args.synthetic = True

    creator = AnalysisTestCreator(args)
    creator.load_input()
    creator.create_default_description()
    ok = creator.run()
    if ok:
        creator.save_output(args.output)
    endOfRun(args)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
