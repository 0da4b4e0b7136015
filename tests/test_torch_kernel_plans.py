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
* Kernel 1 (csrc/segment_reduce.cu): ``segment_plan``'s one buffer (rows,
  run keys, run count, tile counter, 8-byte aligned status words, views
  that do not overlap) at n = 0 to 2^20; and a numpy emulation of the
  kernel's tile ownership (a tile skips its leading points that continue
  the previous tile's run, owns the runs that start in it, and the owner
  of its last run walks on past its end, 32 points and then a tile at a
  time) equal bit for bit to the plain version, at TILE and at a tile of
  8, on runs that end at a tile edge, start at a tile's last point, span
  one, two and many tiles, and cover all of n.
* Kernel 2 (csrc/window_knn.cu): a torch emulation of its two selection
  regimes (drop max-passes; the merge-and-keep-lower network), loop for
  loop as the kernel runs them, allclose to the plain version for six
  (k, window) pairs, with duplicate points and count 0, 100 and n.
* Kernel 7 (csrc/scan_probe.cu): ``scan_plan`` at sel_roofline.py's shape
  (one wave of 132 SMs x 16 warps on the total path; one load a warp on
  the per-step path), at a ragged S and at one tile, with the per-step
  path chosen exactly where S * T > 2^24 (and always for ``add``); and a
  torch emulation of both paths (each warp's row blocks, the rows a lane
  holds, the pad rows and their subtraction, the flushed f32 counters, the
  per-step sums kept STEP_CHUNK steps at a time and added in step order)
  bit-equal to the plain version in every form.
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
    scan_probe,
    segment_reduce,
    sort_kernel,
    window_knn,
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
    assert segment_reduce.TILE == _constant("scan.cuh", "TILE")
    assert segment_reduce.NROWS == _constant("segment_reduce.cu", "NROWS")
    assert segment_reduce.ZERO_COLS == _constant("segment_reduce.cu", "ZERO_COLS")
    assert segment_reduce.SENTINEL == int(re.search(r"constexpr int SENTINEL = (0x[0-9a-f]+);",
                                                    (CSRC / "segment_reduce.cu").read_text()).group(1), 16)
    assert window_knn.MAX_WINDOW == _constant("window_knn.cu", "MAX_WINDOW")
    assert window_knn.DROP_MAX == _constant("window_knn.cu", "DROP_MAX")
    for name in ("STRIP", "LANE_ROWS", "ROWS", "MAX_WARPS", "STEP_CHUNK"):
        assert getattr(scan_probe, name) == _constant("scan_probe.cu", name), name
    assert scan_probe.EXACT == 1 << int(re.search(r"constexpr long long EXACT = 1LL << ([0-9]+);",
                                                 (CSRC / "scan_probe.cu").read_text()).group(1))


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


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 3 * 1024 + 5, 1 << 20])
def test_segment_plan(n):
    for ocap in (0, 1, 7, 4096, 229376):
        plan = segment_reduce.segment_plan(n, ocap)
        nr = segment_reduce.NROWS
        assert plan.tiles == -(-n // segment_reduce.TILE)
        assert plan.blocks == plan.tiles + -(-ocap // segment_reduce.ZERO_COLS)
        # rows [0, 8 ocap), keys [8 ocap, 9 ocap), the run count, the tile counter, the status words
        assert plan.key_at == nr * ocap and plan.nseg_at == plan.key_at + ocap
        assert plan.status_at % 2 == 0 and plan.status_at >= plan.nseg_at + 2
        assert plan.words == plan.status_at + 2 * plan.tiles
        work = torch.arange(plan.words, dtype=torch.int32)
        rows = work[:plan.key_at].view(torch.float32).view(nr, ocap)
        key, nseg = work[plan.key_at:plan.nseg_at], work[plan.nseg_at]
        spans = [(rows.storage_offset(), rows.numel()), (key.storage_offset(), key.numel()),
                 (nseg.storage_offset(), 1), (plan.nseg_at + 1, 1), (plan.status_at, 2 * plan.tiles)]
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            assert a0 + a1 <= b0  # in order, no overlap
        assert spans[-1][0] + spans[-1][1] == plan.words


WARP = 32  # the walk's first step: one warp


def _emulate_segment_reduce(smk, sfr, srgba, ocap, tile):
    """segment_reduce.cu's ownership rule in numpy: each tile counts its run
    starts (the look-back gives the offsets), skips its leading points that
    continue the previous tile's run, sums the runs that start in it, and
    the owner of its last run walks on past its end while the key holds: a
    warp's 32 points, then a tile's at a time.  Returns (rows, key, nseg)."""
    sentinel = segment_reduce.SENTINEL
    key = smk.astype(np.int64)
    n = len(key)
    q = sfr.view(np.uint32).astype(np.int64)
    c = srgba.view(np.uint32).astype(np.int64)
    vals = np.stack([(q >> 20) & 1023, (q >> 10) & 1023, q & 1023,
                     (c >> 16) & 255, (c >> 8) & 255, c & 255, np.ones(n, np.int64)])
    tile_bits = (c >> 24) & 255
    valid = key != sentinel
    start = valid & ((np.arange(n) == 0) | (key != np.concatenate([[sentinel], key[:-1]])))
    tiles = -(-n // tile)
    counts = np.array([int(start[t * tile:(t + 1) * tile].sum()) for t in range(tiles)], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)  # the look-back's prefixes
    rows = np.zeros((8, ocap), np.float32)
    out_key = np.zeros(ocap, np.int32)
    for t in range(tiles):
        lo, hi = t * tile, min((t + 1) * tile, n)
        nr = int(counts[t])
        run = np.cumsum(start[lo:hi]) - 1  # local run; -1: a leading continuation, skipped
        own = valid[lo:hi] & (run >= 0)
        sums = np.zeros((7, nr), np.int64)
        ors = np.zeros(nr, np.int64)
        for r in range(7):
            np.add.at(sums[r], run[own], vals[r, lo:hi][own])
        np.bitwise_or.at(ors, run[own], tile_bits[lo:hi][own])
        if nr > 0 and hi < n and valid[hi - 1]:  # the walk
            kl, j, step = key[hi - 1], hi, WARP
            while True:
                pos = np.arange(j, j + step)
                cont = np.zeros(step, bool)
                cont[pos < n] = key[pos[pos < n]] == kl
                upto = step if cont.all() else int(np.argmin(cont))
                sums[:, nr - 1] += vals[:, j:j + upto].sum(1)
                ors[nr - 1] |= np.bitwise_or.reduce(tile_bits[j:j + upto], initial=0)
                if upto < step:
                    break
                j, step = j + step, tile
        cols = offsets[t] + np.arange(nr)
        w = cols < ocap
        rows[0:3, cols[w]] = (2 * sums[0:3, w] + sums[6, w]).astype(np.float32) * np.float32(1 / 2048)
        rows[3:7, cols[w]] = sums[3:7, w].astype(np.float32)
        rows[7, cols[w]] = ors[w].astype(np.float32)
        out_key[cols[w]] = key[lo:hi][start[lo:hi]][w]
    return rows, out_key, int(offsets[-1])


def _runs_from_lengths(lengths, cap, seed, sentinel_gap=False):
    """Sorted keys with runs of the given lengths, then sentinels to cap."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 29, len(lengths), replace=False)).astype(np.int32)
    smk = np.full(cap, segment_reduce.SENTINEL, np.int32)
    body = np.repeat(keys, lengths)
    smk[:len(body)] = body
    sfr = rng.integers(0, 1 << 30, cap).astype(np.int32)
    srgba = rng.integers(-(2**31), 2**31, cap).astype(np.int32)
    return smk, sfr, srgba


def _ownership_cases(t):
    rng = np.random.default_rng(t)
    s3 = -(-(t + WARP + 2) // t) * t + t - 1  # the last point of a tile after the first run
    return {
        "runs ending at tile edges": ([t, t, 2 * t, t // 2, t // 2, 3 * t], 9 * t),
        "a run starting at a tile's last point": ([t - 1, 5, t - 5, t + 1, 2], 4 * t),
        "runs of one, two and many tiles": ([1, 2 * t + 3, 5 * t, 1, 2, t], 10 * t + 16),
        # the first run fills tile 0 and 32 points more; the third starts at a
        # tile's last point and goes on for 32 points and a tile
        "walks of exactly 32 and of 32 + a tile": ([t + WARP, s3 - t - WARP, 1 + WARP + t, 3], s3 + 2 * t + WARP + 8),
        "one run over all n": ([8 * t], 8 * t),
        "short random runs": (list(rng.integers(1, 9, 6 * t // 4)), 8 * t),
    }


@pytest.mark.parametrize("tile", [segment_reduce.TILE, 8])
@pytest.mark.parametrize("case", list(_ownership_cases(8)))
def test_segment_reduce_tile_ownership(tile, case):
    lengths, cap = _ownership_cases(tile)[case]
    assert sum(lengths) <= cap
    smk, sfr, srgba = _runs_from_lengths(lengths, cap, seed=len(case))
    for ocap in (cap, len(lengths) // 2):  # every run kept; runs past ocap dropped
        rows, key, nseg = _emulate_segment_reduce(smk, sfr, srgba, ocap, tile)
        prows, pkey, pnseg = segment_reduce.segment_reduce_sorted_plain(
            *(torch.from_numpy(a) for a in (smk, sfr, srgba)), ocap)
        assert nseg == int(pnseg) == len(lengths)
        np.testing.assert_array_equal(rows.view(np.uint32), prows.numpy().view(np.uint32))
        np.testing.assert_array_equal(key, pkey.numpy())


F32_MAX = float(np.finfo(np.float32).max)


def _emulate_window_knn(x, y, z, count, k, window):
    """window_knn.cu's selection, loop for loop, over all points at once:
    the drop regime's tree max, mask and removal of the lowest index among
    equals, or the merge-and-keep-lower network; sums in the kernel's
    order."""
    n = x.shape[0]
    np_ = 16 if window <= 8 else 32 if window <= 16 else 64
    kk = min(k, 2 * window)
    idx = torch.arange(n)
    drop_regime = 2 * window - kk <= window_knn.DROP_MAX
    d = []
    for w in [*range(-window, 0), *range(1, window + 1)]:
        nb = (idx + w).clamp(0, n - 1)
        dx, dy, dz = x - x[nb], y - y[nb], z - z[nb]
        ok = (idx + w >= 0) & (idx + w < count)
        d.append(torch.where(ok, (dx * dx + dy * dy) + dz * dz, F32_MAX))
    d += [torch.full((n,), -1.0 if drop_regime else F32_MAX)] * (np_ - 2 * window)
    s = torch.zeros(n)
    if drop_regime:
        for _ in range(2 * window - kk):
            m = [torch.maximum(d[j], d[j + np_ // 2]) for j in range(np_ // 2)]
            h = np_ // 4
            while h > 0:
                m = [torch.maximum(m[j], m[j + h]) for j in range(h)]
                h //= 2
            hit = torch.stack([d[j] == m[0] for j in range(np_)], 1)
            first = hit.to(torch.int64).argmax(1)  # the lowest set bit
            d = [torch.where(first == j, -1.0, d[j]) for j in range(np_)]
        for j in range(np_):
            use = (d[j] >= 0) & (d[j] < F32_MAX / 2)
            s = torch.where(use, s + torch.sqrt(torch.where(use, d[j], 0.0)), s)
    else:
        p = 1
        while p < kk:
            p *= 2

        def exchange(a, b, up):
            lo, hi = torch.minimum(d[a], d[b]), torch.maximum(d[a], d[b])
            d[a], d[b] = (lo, hi) if up else (hi, lo)

        size = 2
        while size <= p:
            stride = size // 2
            while stride > 0:
                for a in range(np_):
                    if a ^ stride > a:
                        exchange(a, a ^ stride, (a & size) == 0)
                stride //= 2
            size *= 2
        span = p
        while span < np_:
            for a in range(np_):
                if a & (2 * span - 1) < p:
                    d[a] = torch.minimum(d[a], d[a + span])
            stride = p // 2
            while stride > 0:
                for a in range(np_):
                    if a & (2 * span - 1) < p and a ^ stride > a:
                        exchange(a, a ^ stride, (a & (2 * span)) == 0)
                stride //= 2
            span *= 2
        for j in range(kk):
            use = d[j] < F32_MAX / 2
            s = torch.where(use, s + torch.sqrt(torch.where(use, d[j], 0.0)), s)
    return torch.where(idx < count, s / float(kk), 0.0)


@pytest.mark.parametrize("k, window", [(30, 16), (30, 32), (5, 8), (1, 1), (64, 32), (31, 16)])
def test_window_knn_selection_regimes(k, window):
    rng = np.random.default_rng(k + window)
    n = 1000
    pts = np.sort(rng.random((n, 3), dtype=np.float32), axis=0)
    pts[1::7] = pts[0::7][: len(pts[1::7])]  # duplicate points: ties at d2 = 0
    pts[2::7] = pts[0::7][: len(pts[2::7])]
    x, y, z = (torch.from_numpy(np.ascontiguousarray(pts[:, a])) for a in range(3))
    for count in (0, 100, n):
        cnt = torch.tensor(count, dtype=torch.int32)
        got = _emulate_window_knn(x, y, z, count, k, window)
        want = window_knn.window_knn_mean_distance_plain(x, y, z, cnt, k, window)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-7), (count, float((got - want).abs().max()))
        assert not got[count:].any()


@pytest.mark.parametrize("form", scan_probe.FORMS)
def test_scan_plan_sel_roofline(form):
    plan = scan_probe.scan_plan(1536, 64, 64 * 128, form)
    assert plan.row_blocks == 12 and plan.loads == 1
    assert plan.blocks * plan.strips_per_block * scan_probe.STRIP == 64 * 128  # every column, once
    # 1,024 strips x 2 warps, one wave of 132 SMs x 16 warps; T fits one chunk of per-step sums
    assert plan.per_step == (form == "add") and plan.warps_per_strip == 2 and plan.strips_per_block == 2
    assert plan.threads == 128 and plan.blocks == 512
    assert plan.blocks * plan.threads // 32 <= scan_probe.SMS * scan_probe.WARPS_PER_SM
    assert plan.smem_bytes == (4 * 64 * 8 * 4 if form == "add" else 0)


@pytest.mark.parametrize("s, ntiles, rb, wps, spb, blocks", [(1000, 64, 8, 2, 2, 512), (1536, 1, 12, 12, 1, 16),
                                                             (1000, 1, 8, 8, 1, 16), (0, 1, 0, 1, 4, 4),
                                                             (1, 64, 1, 1, 4, 256)])
def test_scan_plan_shapes(s, ntiles, rb, wps, spb, blocks):
    plan = scan_probe.scan_plan(s, 64, ntiles * 128, "i32")
    assert (plan.row_blocks, plan.warps_per_strip, plan.strips_per_block, plan.blocks) == (rb, wps, spb, blocks)
    assert plan.threads <= scan_probe.MAX_WARPS * 32 and plan.threads == 32 * wps * spb


@pytest.mark.parametrize("s", [1, 1536, 4096, 1 << 20])
def test_scan_plan_per_step_exactly_past_2_24(s):
    t_max = scan_probe.EXACT // s  # the last T whose S * T is at most 2^24
    for form in ("i32", "i16", "bf16", "mxu"):
        assert not scan_probe.scan_plan(s, t_max, 128, form).per_step
        assert scan_probe.scan_plan(s, t_max + 1, 128, form).per_step
    assert scan_probe.scan_plan(s, 1, 128, "add").per_step
    big = scan_probe.scan_plan(4096, 4200, 128, "i32")  # 32 row blocks over 16 warps: reloaded each chunk
    assert big.per_step and big.warps_per_strip == 16 and big.loads == -(-4200 // scan_probe.STEP_CHUNK)
    once = scan_probe.scan_plan(1536, 16384, 128, "i32")  # 12 row blocks, a warp each: loaded once
    assert once.per_step and once.warps_per_strip == 12 and once.loads == 1


_PADS = {"i32": -(2**31), "mxu": -(2**31), "i16": -(2**15), "bf16": float("-inf"), "add": 0}


def _emulate_scan_probe(x, form, t, per_step, wps):
    """scan_probe.cu's arithmetic over torch tensors, warp by warp: the rows
    lane g of a warp holds, the pad rows, the totals or the per-step sums,
    their combination across the strip's warps and the f32 step order."""
    s, c = x.shape
    rows, br = scan_probe.ROWS, scan_probe.BLOCK_ROWS
    nrb = -(-s // br)
    xs = x.to(torch.float64 if form == "bf16" else torch.int64)
    xs = torch.cat([xs, torch.full((nrb * br - s, c), _PADS[form], dtype=xs.dtype)])
    mids = [float(scan_probe._mid(form, i)) if form == "bf16" else scan_probe._mid(form, i) for i in range(t)]
    pads = 0 if form == "add" else nrb * br - s

    def lane_rows(rb, g):
        return xs[rb * br + g + scan_probe.LANE_ROWS * torch.arange(rows)]  # [ROWS, c]

    def step_value(v, mid):  # a lane's sum at one step, wrapping as uint32
        return (v.sum(0) if form == "add" else (v <= mid).sum(0)) % 2**32

    if not per_step:
        tot = torch.zeros(c, dtype=torch.int64)
        for wr in range(wps):
            for rb in range(wr, nrb, wps):
                for g in range(scan_probe.LANE_ROWS):
                    v = lane_rows(rb, g)
                    a = torch.zeros((4, c), dtype=torch.float32)  # the four counters, k % 4
                    for mid in mids:
                        a += (v <= mid).view(rows // 4, 4, c).sum(0).to(torch.float32)
                    tot += ((a[0] + a[1]) + (a[2] + a[3])).to(torch.int64)
        total = (tot - pads * t) % 2**32
        return torch.where(total >= 2**31, total - 2**32, total).to(torch.float32)
    acc = torch.zeros(c, dtype=torch.float32)
    for t0 in range(0, t, scan_probe.STEP_CHUNK):
        steps = range(t0, min(t, t0 + scan_probe.STEP_CHUNK))
        chunk = torch.zeros((len(steps), c), dtype=torch.int64)
        for wr in range(wps):
            for rb in range(wr, nrb, wps):
                for i, step in enumerate(steps):
                    chunk[i] += sum(step_value(lane_rows(rb, g), mids[step]) for g in range(scan_probe.LANE_ROWS))
        for i in range(len(steps)):
            v = (chunk[i] - pads) % 2**32
            acc = acc + torch.where(v >= 2**31, v - 2**32, v).to(torch.float32)
    return acc


@pytest.mark.parametrize("form", scan_probe.FORMS)
@pytest.mark.parametrize("s, t", [(1000, 3), (130, 70), (128, 2), (0, 2)])
def test_scan_probe_emulation(form, s, t):
    x = scan_probe.make_inputs(s, 1)[form][:, :16].contiguous()  # two strips
    plan = scan_probe.scan_plan(s, t, 128, form)
    want = scan_probe.scan_program_plain(torch.nn.functional.pad(x, (0, 112)), form, t)[0, :16]
    for per_step in ({plan.per_step, True} if form != "add" else {True}):
        for wps in {plan.warps_per_strip, 3}:
            got = _emulate_scan_probe(x, form, t, per_step, wps)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (per_step, wps)
