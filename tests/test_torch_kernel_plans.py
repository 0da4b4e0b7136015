"""The host-side plans of kernels 5 and 6, which the CPU can run though the
CUDA kernels cannot (they run on the card, in chip_smoke.py phases 8-12).

* Kernel 6 (csrc/sort.cu): ``passes_run`` on the upfront histogram
  (``digit_histogram``, the plain version of the kernel's) runs a pass
  only where the digit is not the same for every key, and the fourth pass
  alone when every digit is: checked on all-equal keys, sentinels only,
  small ranges, the full int32 range and 30-bit Morton keys, and shown
  exact: stable counting sorts over just those passes order the keys as
  ``torch.sort`` does.  ``sort_plan``'s scratch for N = 8192 to 2^24: one
  64-bit status word per (pass, tile of 4,096, digit) after the digit
  counts and tile counters, and six launches a sort.
* Kernel 5 (csrc/nn_select.cu): ``strip_plan``'s shared memory fits the
  48 KB a block gets without the opt-in attribute at every cap_r from 1 to
  MAX_CAP (every cap ``nn_grid_params`` can choose among them) and every
  cap_q, and its passes can stage the whole ring union.
* The constants the plans mirror are the CUDA sources' own.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.ops import nn_select, sort_kernel
from cwipc_util_tpu_torch.ops.knn import nn_grid_params
from cwipc_util_tpu_torch.ops.sort_kernel import digit_histogram, passes_run, sort_plan
from cwipc_util_tpu_torch.ops.voxelize import morton3

CSRC = Path(sort_kernel.__file__).resolve().parent.parent / "csrc"


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([0-9]+);", (CSRC / source).read_text())
    assert m, (source, name)
    return int(m.group(1))


def test_plans_mirror_the_sources():
    assert sort_kernel.TILE_KEYS == _constant("sort.cu", "PASS_THREADS") * _constant("sort.cu", "KPT")
    assert sort_kernel.MAX_PAYLOADS == _constant("sort.cu", "MAX_PAYLOADS")
    assert nn_select.STRIP == _constant("nn_select.cu", "STRIP")
    assert nn_select.THREADS == _constant("nn_select.cu", "THREADS")
    assert nn_select.STAGE_MAX == _constant("nn_select.cu", "STAGE_MAX")
    assert nn_select.MAX_CAP == _constant("nn_select.cu", "MAX_CAP_Q")


def _keys(kind: str, n: int) -> torch.Tensor:
    rng = np.random.default_rng(n)
    if kind == "all equal":
        k = np.full(n, -7, np.int32)
    elif kind == "sentinels only":
        k = np.full(n, 2**31 - 1, np.int32)
    elif kind == "0..n-1":
        k = np.arange(n, dtype=np.int32)
    elif kind == "full int32 range":
        k = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    else:  # 30-bit Morton keys of 10-bit coordinates, 10 % sentinels (the fast chain's padding)
        v = torch.from_numpy(rng.integers(0, 1024, (n, 3)).astype(np.int32))
        k = morton3(v[:, 0], v[:, 1], v[:, 2]).numpy()
        k[rng.random(n) < 0.1] = 2**31 - 1
    return torch.from_numpy(k)


@pytest.mark.parametrize("kind, want", [
    ("all equal", (3,)),
    ("sentinels only", (3,)),
    ("0..n-1", (0, 1)),
    ("full int32 range", (0, 1, 2, 3)),
    ("30-bit Morton keys", (0, 1, 2, 3)),
])
def test_sort_passes_run(kind, want):
    n = 8192
    key = _keys(kind, n)
    hist = digit_histogram(key)
    assert hist.shape == (4, 256) and (hist.sum(1) == n).all()
    flipped = key.numpy().view(np.uint32) ^ np.uint32(0x80000000)
    for p in range(4):
        np.testing.assert_array_equal(hist[p].numpy(), np.bincount((flipped >> (8 * p)) & 255, minlength=256))
    ran = passes_run(hist, n)
    assert ran == want
    # skipping the uniform passes is exact: stable counting sorts over the
    # passes that run give torch.sort's order
    order = np.arange(n)
    for p in ran:
        digit = (flipped[order] >> (8 * p)) & 255
        order = order[np.argsort(digit, kind="stable")]
    assert torch.equal(key[torch.from_numpy(order)], torch.sort(key, stable=True).values)


@pytest.mark.parametrize("n", [1 << e for e in range(13, 25)])
def test_sort_plan_scratch(n):
    plan = sort_plan(n)
    tiles = n // 4096
    assert plan.tiles == tiles
    assert plan.status_words == 4 * tiles * 256
    assert plan.scratch_bytes == 4 * (4 * 256 + 4) + 8 * plan.status_words
    assert plan.launches == 6


def test_sort_plan_rejects_partial_tiles():
    for n in (0, 4095, 8192 + 1):
        with pytest.raises(CwipcError):
            sort_plan(n)


def _ladder_caps():
    """Every (cap_r, cap_q) nn_grid_params returned for a sweep of scenes."""
    rng = np.random.default_rng(5)
    caps = set()
    for n, side in ((500, 0.4), (4000, 0.3), (20000, 0.2), (60000, 0.15)):
        pts = (rng.random((n, 3)) * side).astype(np.float32)
        g = nn_grid_params(pts, pts + np.float32(0.001), 0.03)
        if g is not None:
            caps.add((g[3], g[4]))
    return caps


def test_strip_plan_fits_shared_memory():
    caps = _ladder_caps()
    assert len(caps) >= 2
    cap_qs = sorted({q for _, q in caps} | {1, 5, 13, 128, nn_select.MAX_CAP})
    for cap_r in range(1, nn_select.MAX_CAP + 1):
        for cap_q in cap_qs:
            plan = nn_select.strip_plan(cap_r, cap_q)
            assert plan.smem_bytes <= nn_select.SMEM_LIMIT, (cap_r, cap_q, plan)
            assert 1 <= plan.stage <= nn_select.STAGE_MAX
            assert plan.stage * plan.max_passes >= nn_select.UNION_COLS * cap_r
            assert plan.threads == nn_select.THREADS
    for cap_r, cap_q in caps:
        assert nn_select.strip_plan(cap_r, cap_q).smem_bytes <= nn_select.SMEM_LIMIT
    with pytest.raises(CwipcError):
        nn_select.strip_plan(8, nn_select.MAX_CAP + 1)
