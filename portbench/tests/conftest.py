"""Shared set-up of the benchmark's own tests (run with
``python -m pytest portbench/tests``).

* ``card``: a marker for tests that need a CUDA card.  Whether one is
  there is decided inside the test (the ``cuda`` fixture), never while a
  module is imported, so every worker collects the same tests.
* ``tiny_config``: the 8i configuration cut to a few thousand points and
  a 3 cm cell, with its capacities and grid sized for that, so the exact
  chain's plain versions run on the CPU in a second or two a frame.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return "cuda"


def tiny(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["body"].update(lattice_m=0.012, oversample=4.0, floor_voxel=2)
    cfg["frames"] = 2
    cfg["capacity"] = 32768
    cfg["chain"].update(cellsize=0.03, out_capacity=4096, gy=64, gz=32, cap=20)
    return cfg


@pytest.fixture(scope="session")
def tiny_config() -> dict:
    with open(HERE / "configs" / "body-8ivfb-1m.json") as f:
        return tiny(json.load(f))
