"""The control: the reference computed in bfloat16 (the precision below
the configuration's float32) put in the program's place must fail the
check, on three seeds.  On the CPU at the tiny size; on the card
(``-m card``) at each cell's own size, as the limits were read there."""

from __future__ import annotations

import pytest
import torch

from harness import bodies, spec
from reference import exact_chain, judge

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


def _control_numbers(cfg: dict, seed: int, device: str, frames: int) -> list[dict]:
    ch = cfg["chain"]
    slab = spec.traffic("exact-closed")["slab_cells"] * ch["cellsize"]
    held, _ = bodies.make_sequence(cfg, seed, device, capacity=cfg["capacity"])
    out = []
    for xyz, rgba, count in held[:frames]:
        n = int(count)
        kw = dict(cellsize=ch["cellsize"], k=ch["k"], mult=ch["mult"], tile=ch["tile"], slab=slab)
        ref = exact_chain.run(xyz, rgba, n, **kw)
        low = exact_chain.run(xyz, rgba, n, dtype=torch.bfloat16, **kw)
        kept = low["kept"]
        words = (low["tile"][kept] << 24) | (low["rgb"][kept, 0] << 16) | (low["rgb"][kept, 1] << 8) | low["rgb"][kept, 2]
        out.append(judge.judge_frame(ref, low["centroid"][kept].to(torch.float32), words.to(torch.int32),
                                     int(kept.shape[0]), ch["cellsize"]))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_on_the_cpu(tiny_config, seed):
    for numbers in _control_numbers(tiny_config, seed, "cpu", frames=1):
        assert not judge.verdict(numbers)
        assert numbers["centroid_err_m"] > judge.LIMITS["centroid_err_m"]
        assert numbers["keep_margin"] > judge.LIMITS["keep_margin"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_bench()["workloads"]])
def test_control_fails_at_the_cells_size(cuda, cell):
    bench = spec.load_bench()
    cfg = spec.config(bench, spec.workload(bench, cell)["config"])
    for seed in SEEDS:
        for numbers in _control_numbers(cfg, seed, cuda, frames=2):
            assert not judge.verdict(numbers)
