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
* Kernel 4 (csrc/cols_select.cu): ``select_plan``'s shared memory fits
  the 48 KB a block gets without the opt-in attribute at every cap from 1
  to 7,812 (the largest ``_cols_grid_params`` can choose within its 8M
  slots on a 32 x 32 plane), and its passes can stage the whole ring union;
  a numpy emulation of the strip's index arithmetic gives each query
  column exactly its 77 ring columns; and the seed-made walls with 200
  copies of one point that chip_smoke.py phase 6 runs get grids of cap
  over 160, which the column-per-block design could not take.
* Kernel 3 (csrc/compact.cu): ``compact_plan``'s one buffer (outputs, kept
  count, tile counter, 8-byte aligned status words) at n = 0 to 2^20.
* The constants the plans mirror are the CUDA sources' own.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import cwipc_util_tpu_torch as port
from cwipc_util_tpu_torch.core.errors import CwipcError
from cwipc_util_tpu_torch.ops import (
    _cols_grid_params,
    _estimate_spacing,
    cols_select,
    compact_kernel,
    nn_select,
    sort_kernel,
)
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
    assert cols_select.STRIP == _constant("cols_select.cu", "STRIP")
    assert cols_select.THREADS == _constant("cols_select.cu", "THREADS")
    assert cols_select.STAGE_MAX == _constant("cols_select.cu", "STAGE_MAX")
    assert compact_kernel.TILE == _constant("scan.cuh", "TILE")


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


MAX_GRID_CAP = 8_000_000 // (32 * 32)  # _cols_grid_params: 8M slots over the smallest plane, 32 x 32


def test_select_plan_fits_shared_memory():
    for cap in range(1, MAX_GRID_CAP + 1):
        plan = cols_select.select_plan(cap)
        assert plan.smem_bytes <= cols_select.SMEM_LIMIT, (cap, plan)
        assert 1 <= plan.stage <= cols_select.STAGE_MAX
        assert plan.stage * plan.max_passes >= cols_select.UNION_COLS * cap
        assert plan.threads == cols_select.THREADS
    assert cols_select.select_plan(28).max_passes == 2  # the bench grid's cap: a full union takes two
    with pytest.raises(CwipcError):
        cols_select.select_plan(0)


@pytest.mark.parametrize("gy, gz, row0, nrows", [(24, 24, 0, 576), (7, 13, 5, 80), (32, 152, 100, 4000)])
def test_strip_union_holds_each_ring(gy, gz, row0, nrows):
    """cols_select.cu's index arithmetic, emulated: block b's union column u
    = (dyi, zc) reads bounds index j = q0 + dyi * gz + zc (plane row
    row0 + j); query column i of the strip takes the union columns
    dyi * UNION_W + i + corner ... + SIDE - corner.  Each query row must get
    exactly the plane rows of its 77-column ring, every index in range."""
    m, side, strip = 4, 9, cols_select.STRIP
    uw = strip + 2 * m
    off = m * gz + m
    nb = nrows + 2 * off
    ring = set(nn_select.ring_offsets(gz))
    assert len(ring) == 77
    for q0 in range(0, nrows, strip):
        j = q0 + np.arange(side)[:, None] * gz + np.arange(uw)[None, :]  # [dyi, zc]
        assert j.min() >= 0
        for i in range(min(strip, nrows - q0)):
            got = []
            for dyi in range(side):
                corner = 1 if dyi in (0, side - 1) else 0
                cols = j[dyi, i + corner:i + side - corner]
                assert cols.max() < nb  # a ring column is always within the bounds
                got += list(row0 + cols)
            assert len(got) == 77
            query_row = row0 + q0 + i + off
            assert {r - query_row for r in got} == ring


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 1 << 20])
def test_compact_plan(n):
    plan = compact_kernel.compact_plan(n)
    assert plan.tiles == -(-n // compact_kernel.TILE)
    assert plan.status_at % 2 == 0 and plan.status_at >= 4 * n + 2  # outputs, kept count, tile counter
    assert plan.words == plan.status_at + 2 * plan.tiles  # a 64-bit status word per tile


@pytest.mark.parametrize("sampling", ["camera", "uniform"])
def test_wall_with_copies_needs_a_cap_over_160(sampling):
    """The fault the strip design closes: stacked copies of one point make
    ``cwipc_remove_outliers`` choose a column grid of cap over 160, which
    the column-per-block kernel refused (its MAX_CAP)."""
    mat = chip_smoke.wall_with_copies(sampling)
    assert mat.shape == (chip_smoke.WALL_N + chip_smoke.WALL_COPIES, 7)
    pc = port.cwipc_from_numpy_matrix(mat, 0, device="cpu")
    k = chip_smoke.K
    cell = max(1.0, float(np.sqrt(k / np.pi)) / 3.0) * _estimate_spacing(pc)  # as _remove_outliers_single
    params = _cols_grid_params(mat[:, :3].astype(np.float64), cell)
    assert params is not None
    _perm, gy, gz, cap, _origin = params
    assert cap > 160 and gy * gz * cap <= 8_000_000
    assert cols_select.select_plan(cap).smem_bytes <= cols_select.SMEM_LIMIT
