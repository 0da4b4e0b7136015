#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cwipc_util_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card.
It builds the CUDA kernels from ``cwipc_util_tpu_torch/csrc`` and then, in
phases that each stop the run at the first failure:

1. start: CUDA present, kernels built, the card's name and power limit;
2. each kernel against its plain PyTorch version on the card, at the
   chains' shapes (kernels 1 and 3 at both chains' capacities, kernel 3
   with the exact chain's keep masks, kernel 2 at the chain's window and
   at the window method's default of 32) and at edge cases (kernels 1 and
   3 bit-equal, kernel 1 with runs that end at a tile edge, start at a
   tile's last point, walk 32 points or 32 and a tile past a tile's end,
   and one run over all 1,048,576 slots, timed; kernel 2 allclose with
   rtol 1e-5, atol 1e-7, for six (k, window) pairs that take both its
   selection regimes, on a cloud with duplicate points: only the order of
   its final sum differs; kernel 4 on every occupied slot: the covered/uncovered
   classification equal, kth bit-equal where covered, sums allclose with
   rtol 1e-5, atol 1e-5, and a row range equal to the rows of the whole
   run bit for bit; among its cases dense columns whose strip unions it
   stages in passes);
3. the fused chain ``downsample_outliers_tilefilter`` on the 1M-point
   synthetic bench cloud (bench.py's settings), with no host sync allowed:
   217,570 voxels exactly, 103,015 +/- 10 kept points, the same result as
   the chain run through the plain versions, and every kernel launched;
4. times with CUDA events: the chain, its stages, kernels 1-3 next to
   their plain versions, and kernel 3 next to ``rows[keep]``, in turns;
   kernel 2 also at window 32;
5. the exact chain ``downsample_outliers_tilefilter_exact`` on the same
   cloud (bench.py's exact settings): 217,570 voxels, kept points equal to
   a float64 cKDTree oracle computed here (184,397 +/- 1 at tile 0,
   92,195 +/- 1 at tile 1), 112 uncovered points fixed up, 90.52 +/- 0.01 %
   voxel-set agreement with the fast chain, kept points in the input's
   order, kernels 1, 3 and 4 launched;
6. the public ``cwipc_remove_outliers`` on a 40k-point synthetic cloud,
   with and without perTile, and on a 2 x 1.8 m wall of 40,000 points
   with 200 copies of one point (sampled as a camera's pixels and
   uniformly; grids of cap over 160), against the same oracle, kernel 4
   launched and held to its plain version on each column grid the op
   builds;
7. times: the exact chain, its stages, kernel 4 next to its plain version;
   kernel 4's phase profile (clock64 spans of its blocks) beside that of
   a probe of its earlier design (one block per query column), the two
   timed in turns;
8. kernel 5 against its plain version at edge cases: d2 bit-equal and ids
   equal on every slot, empty query slots and empty rings at
   (F32_MAX, INT32_MAX);
9. multi-camera registration, ``MultiCameraIterative`` with the default
   GICP aligner and symmetric analyzer, on the 3-camera, 30,000-point
   ground-truth scene of ``cwipc create_analysis_test`` (seed 42, noise
   2 mm, perturbations 3 cm / 0.06 rad): the register script's worst
   per-camera mode correspondence below 0.006 and below a third of its
   value before, kernels 3 and 5 launched, every aligner run on the grid;
   the grid NN of each aligner pair against a float64 cKDTree oracle,
   kernel 5 against its plain version on every grid pair the flow built,
   and kernel 3 bit-equal to its plain version on every compaction the
   flow made (its inputs recorded as the flow ran);
10. a 160,000-point pair (the whole body with 2 mm noise, and a copy moved
   by the seed-42 perturbation with its own noise): the grid NN and the
   two-scale search against the oracle, one GICP run on kernel 5 and on
   its plain version (both recover the perturbation within 4 mm and
   0.02 rad and agree within 1 mm and 5e-3 rad), one analyzer query;
11. times: the flow and its phases, one ICP run at 30k and 160k points,
   the grid query's parts, kernel 5 next to its plain version on the
   flow's largest grid, kernel 5 summed over every call of the flow with
   its summed bound, the grid search next to the two-scale search;
12. kernel 6 (the key+payload sort) against its plain version: keys
   bit-equal and each key's payload tuples equal, at 72 edge cases (all
   keys equal, sorted, reversed, negative, sentinels; n 8192, 1<<15,
   1<<20; 0-3 payloads), with 6 payloads (two launches) and on the fast
   chain's own 1,048,576 sort operands, whose kernel-6 order fed to
   kernel 1 and the centroids gives the fast downsample's 217,570 voxels
   bit for bit; for each edge-case key set, 1M random 30-bit keys and the
   fast chain's keys, the device's upfront histogram equal to
   ``digit_histogram`` and the passes its tile counters show it ran equal
   to the host-side plan's ``passes_run``;
13. kernel 7 (the scan probe) bit-equal to its plain version in all five
   forms at S 1536, T 64, 64 tiles, on sel_roofline.py's inputs;
14. the ops and filter path: cwipc_downsample of the bench cloud at 1 mm
   (~2,000 cells) and of 1M points over 200 m at 5 mm (40,000 cells), both
   on the exact-key path, against a numpy oracle; the grid outlier method on the
   217,570 voxels (cell 12 mm, cap 32, k 12) against a float64 cKDTree
   oracle wherever the k-th neighbour lies within one cell; the KD-tree
   route of cwipc_remove_outliers on a cloud no column grid fits; one 1M
   frame through filters.factory (voxelize, remove_outliers, crop,
   transform44, colorize, analyze), each stage against a numpy or cKDTree
   oracle, with kernels 1, 3 and 4 launched and kernel 4 held to its plain
   version on the grid it builds;
15. times: kernel 6 next to its plain version and torch.sort + gathers,
   in turns, with both's device time by kernel (torch.profiler) and host
   time a call; kernel 3's host time a call by part (checks, allocation,
   device guard, pointers, the ctypes call) beside the earlier wrapper's
   parts, and its device time by kernel next to ``packed[keep]``'s;
   kernels 1 and 2's host time a call by part (kernel 1's one allocation
   beside its earlier six, kernel 2's checks beside its earlier ones) and
   their device time by kernel (kernel 2 at windows 16 and 32);
   kernel 7 per form in element-steps/s, kernel 4's scan yardstick, the
   exact-key downsamples, the grid method and the filter frame;
16. the codec (``codec_phase``): the synthetic source's default 160,000-
   point frame and the 1M-point body with half its tiles raised by 0x80,
   each through a solo encoder at 9 bits (kernel 1), at 9 bits with tile
   mask 1 (kernels 3 and 1), a group {9, 8, 7} (one shared pass) and a
   solo encoder at 10 bits (the exact-key downsample): the launches of
   kernels 1 and 3 and the host reads (CUDA's sync debug mode) of each
   encode, one each; every kernel call of that run equal to its plain
   version; the device program bit-equal to its run on a CPU copy, the
   streams byte-equal to the CPU copy's, the group's deepest member to a
   solo encode, the decoded stream equal to the host twin's outside the
   cells of the points where floor(x / step) and floor(x * (1 / step))
   disagree (everywhere where there are none); 10 frames through
   cwipc_sink_encoder -> MemoryLink -> cwipc_source_decoder with the solo
   decoder's counts; encode and decode ms a frame, the encode's parts and
   the kernels' device time inside an encode.  It prints the color route
   (JPEG needs cv2) and whether the native shim, built with make into
   ``cwipc_util_tpu_torch/_build/native/``, loaded.

Each phase line ends with the wall seconds the phase took.  The kernels
line gives, per kernel, its time, its plain version's, its bound (the
larger of its bytes over 3.35 TB/s and its operations over the peak rate:
float32 at 67 TFLOP/s, an H100 SXM's published peaks; for kernel 7 the
INT32 issue rate, 64 lanes x the SMs x the SM clock, or the f16 tensor
cores' 989 TFLOP/s; counted from this run's inputs: only the rows, slots
and points the function must read) and, where one PyTorch call computes
the same function, that call's time.  ``launches`` is the count of the
main path's run; kernels 6 and 7 are on no path (as in the JAX package),
and theirs is the count of phase 12's sort -> kernel 1 run and phase 13's
probe run.  ``codec_launches`` is the count of phase 16's codec run.

Run alone, outside a checkout, or without CUDA, it exits 2 and prints no
result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# bench.py's main path: 1000 x 1000 synthetic body, 4 mm cells, k=30,
# mult=1, tile=1, window 16, post-downsample capacity 229,376
HSTEPS = 1000
CAPACITY = 1 << 20
CELL = 2.0 / HSTEPS * 2.0
K = 30
MULT = 1.0
TILE = 1
WINDOW = 16
OCAP = 229376
WANT_VOXELS = 217570
WANT_KEPT = 103015
KEPT_BAND = 10
REPS = 20
# bench.py's exact chain: post-downsample capacity 1<<18, column grid
# gy x gz = 504 x 152 columns of cap 28 slots
EX_OCAP = 1 << 18
GY, GZ, GCAP = 504, 152, 28
CHUNK = 256
WANT_EX_KEPT = {0: 184397, 1: 92195}  # the float64 oracle's counts
WANT_RESID = 112
WANT_AGREE = 90.52
F32_MAX = 3.4028234663852886e38

SENTINEL = 2**31 - 1
# an H100 SXM's published peaks (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# registration: cwipc create_analysis_test's ground-truth scene
# (tests/test_scripts.py:417-420) and a 160k-point pair
REG_N, REG_NOISE, REG_TRANSLATION, REG_ROTATION, REG_SEED = 30000, 0.002, 0.03, 0.06, 42
PAIR_N = 160000
PAIR_MAXD = 0.03  # covers the pair's largest displacement (3.4 cm at 99.9 %) and fits a grid
# kernel 6: the edge-case lengths; kernel 7: sel_roofline.py's shape (the
# mid-tier scan: S rows, T steps, 128-column tiles)
SORT_NS = (8192, 1 << 15, 1 << 20)
SCAN_S, SCAN_T, SCAN_TILES = 1536, 64, 64
# an H100's INT32 lanes per SM (times the SM count and clock for the issue
# rate) and its dense f16 tensor-core peak (NVIDIA's data sheet)
INT32_LANES = 64
F16_TENSOR_FLOPS = 989e12
K4_MAX_STEPS = 31  # halving hi - lo < 2^31 takes at most 31 compare-and-count steps
# the exact-key downsamples: the bench cloud at 1 mm (~2,000 cells) and
# 1M uniform points over 200 m at 5 mm (40,000 cells, every voxel a singleton)
DOWN_FINE = 0.001
WIDE_N, WIDE_HALF, WIDE_CELL = 1_000_000, 100.0, 0.005
# the grid method as parallel/fusion.py:40-43 runs it: cells 3 x the 4 mm voxels
GRID_CELL, GRID_K, GRID_CAP = 3 * CELL, 12, 32
# the KD-tree route's cloud: a 2 mm cluster and a spread over a 2 m cube
KD_CLUSTER, KD_SPREAD, KD_SIDE = 2560, 2048, 2.0
# kernel 4 at a cap over 160: a 2 x 1.8 m wall of 40,000 points with 2 mm of
# noise and 200 copies of one point, as a merged multi-camera capture stacks them
WALL_N, WALL_SIZE, WALL_NOISE, WALL_COPIES, WALL_SEED = 40000, (2.0, 1.8), 0.002, 200, 7
# the filter frame's crop: 0.8 <= y < 1.5 m of the 2 m body
CROP = (-1.0, 1.0, 0.8, 1.5, -1.0, 1.0)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the float32 operations over the peak rate (kernel 7 counts its integer
    and tensor-core operations itself)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def same_bits(a, b):
    """Equal shapes and equal 32-bit patterns."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def time_ms(fn, reps=REPS, warm=3):
    """Median CUDA-event milliseconds of fn over reps runs after warm ones."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(kernel, plain, library=None, plain_reps=REPS, plain_warm=3):
    """Medians of a kernel, its plain version and, where there is one, the
    PyTorch call that computes the same function, timed in turns on one
    card: plain, library, kernel, kernel, library, plain.  Returns
    (kernel ms, plain ms, library ms or None, the runs in that order,
    without the library's where there is none)."""
    p1 = time_ms(plain, reps=plain_reps, warm=plain_warm)
    l1 = time_ms(library) if library else None
    k1, k2 = time_ms(kernel), time_ms(kernel)
    l2 = time_ms(library) if library else None
    p2 = time_ms(plain, reps=plain_reps, warm=plain_warm)
    lms = statistics.median([l1, l2]) if library else None
    runs = (p1, l1, k1, k2, l2, p2) if library else (p1, k1, k2, p2)
    return statistics.median([k1, k2]), statistics.median([p1, p2]), lms, runs


def host_s(fn, reps=3):
    """Median host seconds of fn ending in a synchronize."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t_0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t_0)
    return statistics.median(out)


def maxabs(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def r_cut(cell):
    """The covered test's radius: 4 cells, less a relative 1e-6."""
    import numpy as np

    return float(np.float32(4.0) * np.float32(cell) * np.float32(1.0 - 1e-6))


def hold_select(planes, cell, what, k, gy, gz, cap, voxel_unique=False, chunk=CHUNK):
    """Kernel 4 against its plain version on one grid, on every occupied
    slot: the covered/uncovered classification equal, kth bit-equal where
    covered, sums allclose (rtol 1e-5, atol 1e-5); empty slots at (0,
    F32_MAX).  ``chunk`` bounds the plain version's memory.  Returns
    (kernel's (sums, kth), plain's, occupied, covered)."""
    import torch

    from cwipc_util_tpu_torch.ops.cols_select import cols_select, cols_select_plain

    got = cols_select(*planes, k=k, gy=gy, gz=gz, cap=cap, chunk=chunk, voxel_unique=voxel_unique)
    want = cols_select_plain(*planes, k=k, gy=gy, gz=gz, cap=cap, chunk=chunk, voxel_unique=voxel_unique)
    torch.cuda.synchronize()
    off = 4 * gz + 4
    occ = planes[0][off:off + gy * gz] < F32_MAX / 2
    cut = r_cut(cell)
    check(torch.equal((got[1] < cut)[occ], (want[1] < cut)[occ]),
          f"kernel 4 ({what}): the covered/uncovered classification differs from its plain version")
    cov = occ & (want[1] < cut)
    check(same_bits(got[1][cov], want[1][cov]), f"kernel 4 ({what}): kth differs on covered slots")
    check(torch.allclose(got[0][cov], want[0][cov], rtol=1e-5, atol=1e-5),
          f"kernel 4 ({what}): sums differ on covered slots: max abs {maxabs(got[0][cov], want[0][cov])}")
    check(not got[0][~occ].any() and bool((got[1][~occ] == F32_MAX).all()),
          f"kernel 4 ({what}): empty slots must read sums 0, kth F32_MAX")
    return got, want, occ, cov


def subsequence_mask(got_rows, rows, what):
    """Which rows an order-keeping result kept, matched by their bytes in
    order (equal rows, such as duplicate points, match the first unmatched
    one)."""
    import numpy as np

    mask = np.zeros(len(rows), bool)
    j = 0
    for i, r in enumerate(rows):
        if j < len(got_rows) and r.tobytes() == got_rows[j].tobytes():
            mask[i] = True
            j += 1
    check(j == len(got_rows), f"{what}: the result is not an ordered subsequence of the input")
    return mask


def wall_with_copies(sampling, seed=WALL_SEED):
    """[n, 7] float32 (x, y, z, r, g, b, tile): WALL_N points of a wall,
    WALL_SIZE m in y and z with WALL_NOISE m of depth noise in x, in the
    row order a camera scans them, then WALL_COPIES copies of a point in its
    middle.  ``sampling`` "camera": a 200 x 200 pixel grid with half the
    noise across it; "uniform": uniform in y and z."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, side = WALL_N, int(round(WALL_N ** 0.5))
    if sampling == "camera":
        yy, zz = np.meshgrid((np.arange(side) + 0.5) * WALL_SIZE[0] / side,
                             (np.arange(side) + 0.5) * WALL_SIZE[1] / side, indexing="xy")
        yz = np.stack([yy.ravel(), zz.ravel()], -1) + rng.normal(0.0, WALL_NOISE / 2, (n, 2))
    else:
        yz = rng.uniform(0.0, 1.0, (n, 2)) * WALL_SIZE
        yz = yz[np.lexsort((yz[:, 0], np.floor(yz[:, 1] / 0.01)))]
    wall = np.concatenate([rng.normal(0.0, WALL_NOISE, (n, 1)), yz], -1)
    pts = np.concatenate([wall, np.repeat(wall[n // 2 + side // 2][None], WALL_COPIES, 0)])
    mat = np.zeros((len(pts), 7), np.float32)
    mat[:, :3] = pts
    mat[:, 3:6] = rng.integers(0, 256, (len(pts), 3))
    return mat


def oracle(xyz64, k=K, mult=MULT):
    """float64 cKDTree mean distances to the k nearest and the keep threshold."""
    import numpy as np
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(xyz64).query(xyz64, k=k + 1, workers=-1)
    md64 = dist[:, 1:].mean(axis=1)
    n = len(md64)
    var = ((md64 * md64).sum() - md64.sum() ** 2 / n) / max(n - 1, 1)
    return md64, md64.mean() + mult * np.sqrt(max(var, 0.0))


def kept_mask(got_rows, cand_rows, what):
    """Which candidate rows a result kept, matched by their bytes."""
    import numpy as np

    kept = {r.tobytes() for r in got_rows}
    mask = np.array([r.tobytes() in kept for r in cand_rows], bool)
    check(len(kept) == len(got_rows) == int(mask.sum()), f"{what}: kept rows are not rows of the input")
    return mask


def near_flips(mask, want, md64, thr64, what):
    """Keep flips against the oracle; all must lie within 1e-5 * thr of
    the threshold."""
    import numpy as np

    flip = mask != want
    check(bool(np.all(np.abs(md64[flip] - thr64) <= 1e-5 * thr64)),
          f"{what}: {int(flip.sum())} keep flips against the oracle, not all near the threshold")
    return int(flip.sum())


def perturbation(seed, max_translation, max_rotation):
    """A random rigid transform, as cwipc create_analysis_test makes them
    (cwipc_util_tpu/scripts/cwipc_create_analysis_test.py:24-35)."""
    import math

    import numpy as np

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


# ---------------------------------------------------------------------------
# phases 12-15: kernels 6 and 7, the ops and filter path, their times
# ---------------------------------------------------------------------------


def canonical(key, *pays):
    """The arrays ordered by (key, payloads...): equal for two sorts exactly
    when their keys and each key's multiset of payload tuples agree."""
    import torch

    order = torch.arange(key.shape[0], device=key.device)
    for p in reversed(pays):
        order = order[torch.sort(p[order], stable=True).indices]
    order = order[torch.sort(key[order], stable=True).indices]
    return [a[order] for a in (key, *pays)]


def morton_np(vm):
    """30-bit Morton keys of int64 [n, 3] coordinates in 0..1023."""
    import numpy as np

    def part(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    vm = vm.astype(np.int64)
    return (part(vm[:, 2]) << 2) | (part(vm[:, 1]) << 1) | part(vm[:, 0])


def points_xyz(arr):
    import numpy as np

    return np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)


def hold_downsample(got, src, cell, quantized, what):
    """A downsample's output records against a numpy oracle of its input:
    the voxels of floor(xyz * f32(1/cell)) in the port's order (the Morton
    key of the rebased coordinates clamped to 10 bits, then vx, vy, vz),
    and per voxel the integer floor of the mean colour, the OR of the tiles
    and the float64 mean of the points.  Centroids may differ by 4 f32 ulps
    of the largest coordinate for each point a voxel sums, and by
    cell / 2048 where the fast path quantizes the in-voxel offsets."""
    import numpy as np

    xyz = points_xyz(src)
    inv = np.float32(1.0) / np.float32(cell)
    v = np.floor(xyz * inv).astype(np.int64)
    mkey = morton_np(np.clip(v - v.min(0), 0, 1023))
    order = np.lexsort((v[:, 2], v[:, 1], v[:, 0], mkey))
    vs = v[order]
    new = np.ones(len(vs), bool)
    new[1:] = np.any(vs[1:] != vs[:-1], axis=1)
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(vs)))
    check(len(got) == len(starts), f"{what}: {len(got)} voxels, the oracle {len(starts)}")
    mean = np.add.reduceat(xyz[order].astype(np.float64), starts, axis=0) / counts[:, None]
    s = src[order]
    for ch in ("r", "g", "b"):
        want = np.add.reduceat(s[ch].astype(np.int64), starts) // counts
        check(np.array_equal(got[ch].astype(np.int64), want), f"{what}: mean {ch} differs from the oracle")
    check(np.array_equal(got["tile"], np.bitwise_or.reduceat(s["tile"], starts)),
          f"{what}: tile OR differs from the oracle")
    atol = 4 * float(np.spacing(np.float32(np.abs(xyz).max()))) * int(counts.max())
    if quantized:
        atol += float(np.float32(cell)) / 2048
    err = float(np.abs(points_xyz(got).astype(np.float64) - mean).max()) if len(got) else 0.0
    check(err <= atol, f"{what}: centroids {err} from the oracle's, allowed {atol}")
    return len(starts), int(counts.max()), err, atol


def sort_phase(c):
    """Phase 12: kernel 6 against its plain version, then on the fast
    chain's own sort operands, fed to kernel 1 and the centroids."""
    import numpy as np
    import torch

    from cwipc_util_tpu_torch.ops import voxelize
    from cwipc_util_tpu_torch.ops.segment_reduce import segment_reduce_sorted
    from cwipc_util_tpu_torch.ops.sort_kernel import (
        PASSES,
        RADIX,
        _sort_cuda,
        digit_histogram,
        passes_run,
        sort_by_key,
        sort_by_key_plain,
        sort_plan,
    )

    rng = np.random.default_rng(6)

    def plan_case(what, key):
        """The device's upfront histogram against its plain version, and the
        passes its tile counters show it ran against passes_run."""
        plan = sort_plan(key.shape[0])
        (_, scratch) = _sort_cuda(key, ())
        torch.cuda.synchronize()
        hist = scratch[:PASSES * RADIX].view(PASSES, RADIX).long()
        counters = [int(v) for v in scratch[PASSES * RADIX:PASSES * RADIX + PASSES]]
        check(torch.equal(hist, digit_histogram(key)), f"kernel 6 ({what}): the upfront histogram differs")
        want = passes_run(hist.cpu(), key.shape[0])
        check(counters == [plan.tiles if p in want else 0 for p in range(PASSES)],
              f"kernel 6 ({what}): tile counters {counters}, the plan runs passes {want} of {plan.tiles} tiles")
        return want

    def rand_i32(n, lo=-(2**31), hi=2**31):
        return c.t(rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32))

    def case(what, key, *pays):
        got = sort_by_key(key, *pays)
        want = sort_by_key_plain(key, *pays)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"kernel 6 ({what}): keys differ from the plain version")
        check(all(torch.equal(a, b) for a, b in zip(canonical(*got), canonical(*want))),
              f"kernel 6 ({what}): a key's payload tuples differ from the plain version's")
        return got, want

    ncases, plans = 0, {}
    for n in SORT_NS:
        dup = rng.integers(-(n // 16), n // 16, n).astype(np.int32)
        dup[rng.random(n) < 0.1] = SENTINEL
        keys = {
            "all keys equal": torch.full((n,), 5, dtype=torch.int32, device=c.dev),
            "already sorted": torch.arange(n, dtype=torch.int32, device=c.dev),
            "reversed": torch.arange(n, dtype=torch.int32, device=c.dev).flip(0),
            "negative keys": rand_i32(n, -(2**31), 0),
            "duplicates, negative keys, 10 % sentinels": c.t(dup),
            "full int32 range": rand_i32(n),
        }
        for what, key in keys.items():
            for npay in range(4):
                case(f"n={n}, {what}, {npay} payloads", key, *(rand_i32(n) for _ in range(npay)))
                ncases += 1
            plans[f"n={n}, {what}"] = plan_case(f"n={n}, {what}", key)
    # more payloads than one launch carries: a launch per group of them
    case("n=8192, 6 payloads", rand_i32(8192), *(rand_i32(8192) for _ in range(6)))
    plans["n=1<<20, 30-bit keys"] = plan_case("30-bit keys", rand_i32(1 << 20, 0, 1 << 30))
    # the fast chain's own operands, through kernel 1 and the centroids
    mkey, fracs, vmin_safe = voxelize._front(c.buf, CELL)
    torch.cuda.synchronize()
    sort_by_key.launches = segment_reduce_sorted.launches = 0
    smk, sfr, srgba = sort_by_key(mkey, fracs, c.buf.rgba)
    rows, key, nseg = segment_reduce_sorted(smk, sfr, srgba, OCAP)
    down6 = voxelize._reduce_runs_cm(rows, key, nseg, vmin_safe, CELL, OCAP)
    torch.cuda.synchronize()
    launches = sort_by_key.launches
    check(launches >= 1 and segment_reduce_sorted.launches >= 1, "kernels 6 and 1 were not launched")
    (gk, *_), (wk, *_) = case("the fast chain's operands", mkey, fracs, c.buf.rgba)
    passes = plan_case("the fast chain's operands", mkey)
    err = float((gk.double() - wk.double()).abs().max())
    check(all(same_bits(a, b) for a, b in zip(down6, c.down)) and int(down6[4]) == WANT_VOXELS,
          "kernel 6 -> kernel 1 does not give the fast downsample's voxels")
    plan = sort_plan(mkey.shape[0])
    print(f"{c.card} phase 12: kernel 6's passes, from its upfront histogram, as the host-side plan has them:"
          f" {plans}; the fast chain's operands {passes}; {plan}")
    print(f"{c.card} phase 12 ok {c.lap()}: kernel 6 equal to its plain version in {ncases} cases"
          f" (n {SORT_NS}, 0-3 payloads), with 6 payloads, and on the fast chain's {mkey.shape[0]} keys;"
          f" fed to kernel 1, {int(down6[4])} voxels bit-equal to the fast downsample; {plan.launches} launches"
          f" a sort; wrapper launches {launches}")
    return dict(mkey=mkey, fracs=fracs, launches=launches, err=err, plan=plan, passes=passes)


def scan_phase(c):
    """Phase 13: kernel 7 against its plain version, all five forms."""
    import torch

    from cwipc_util_tpu_torch.ops.scan_probe import FORMS, make_inputs, scan_program, scan_program_plain

    xs = {f: x.to(c.dev) for f, x in make_inputs(SCAN_S, SCAN_TILES).items()}
    torch.cuda.synchronize()
    scan_program.launches = 0
    outs = {f: scan_program(xs[f], f, SCAN_T) for f in FORMS}
    torch.cuda.synchronize()
    launches = scan_program.launches
    check(launches == len(FORMS), f"kernel 7 launched {launches} times for {len(FORMS)} forms")
    means, err = {}, 0.0
    for f in FORMS:
        want = scan_program_plain(xs[f], f, SCAN_T)
        torch.cuda.synchronize()
        check(same_bits(outs[f], want), f"kernel 7 ({f}) differs from its plain version")
        check(bool((outs[f] == outs[f][0]).all()), f"kernel 7 ({f}): the 8 rows differ")
        err = max(err, float((outs[f].double() - want.double()).abs().max()))
        means[f] = float(outs[f][0].double().mean())
    check(torch.equal(outs["mxu"], outs["i32"]), "kernel 7: the mxu count differs from the i32 count")
    print(f"{c.card} phase 13 ok {c.lap()}: kernel 7 bit-equal to its plain version in all five forms at"
          f" S {SCAN_S}, T {SCAN_T}, {SCAN_TILES} tiles; mean accumulator per form {means}")
    return dict(xs=xs, launches=launches, err=err)


def kdtree_cloud():
    """The smallest cloud found (on the CPU, with the host functions alone)
    that no column grid fits: a dense cluster (sigma 2 mm) holding the
    median spacing near 0.5 mm, and a sparse spread over a 2 m cube that
    survives the percentile clip, so every axis needs > 8M slots."""
    import numpy as np

    rng = np.random.default_rng(42)
    xyz = np.concatenate([rng.normal(0.0, 0.002, (KD_CLUSTER, 3)),
                          rng.uniform(-KD_SIDE / 2, KD_SIDE / 2, (KD_SPREAD, 3))]).astype(np.float32)
    from cwipc_util_tpu_torch import POINT_DTYPE

    arr = np.zeros(len(xyz), POINT_DTYPE)
    arr["x"], arr["y"], arr["z"] = xyz.T
    arr["r"], arr["g"], arr["b"] = rng.integers(0, 256, (3, len(xyz))).astype(np.uint8)
    arr["tile"] = 1
    return arr


def grid_exact_mask(xyz, cell, cap):
    """Points whose 27 grid cells (as _mean_knn_dist_grid bins them) all
    hold at most cap points: there the method sees every point of its ring."""
    import numpy as np

    v = np.floor(xyz / np.float32(cell)).astype(np.int64)
    v -= v.min(0)
    key = (v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2]
    uk, cnt = np.unique(key, return_counts=True)
    ok = np.ones(len(xyz), bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nk = ((v[:, 0] + dx) << 42) | ((v[:, 1] + dy) << 21) | (v[:, 2] + dz)
                pos = np.clip(np.searchsorted(uk, nk), 0, len(uk) - 1)
                ok &= ~((uk[pos] == nk) & (cnt[pos] > cap))
    return ok, int(cnt.max())


def ops_phase(c):
    """Phase 14: the exact-key downsamples, the grid method, the KD-tree
    route and one 1M-point frame through the filter factory, each held
    against a numpy or float64 cKDTree oracle."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    import cwipc_util_tpu_torch as port
    import cwipc_util_tpu_torch.ops as port_ops
    from cwipc_util_tpu_torch import filters
    from cwipc_util_tpu_torch.ops import cols_knn, compaction, outliers, voxelize
    from cwipc_util_tpu_torch.ops.cols_select import cols_select
    from cwipc_util_tpu_torch.ops.compact_kernel import compact_kernel_cm
    from cwipc_util_tpu_torch.ops.segment_reduce import segment_reduce_sorted
    from cwipc_util_tpu_torch.ops.window_knn import window_knn_mean_distance_cm

    out = {}
    # the exact-key downsamples through cwipc_downsample; which path ran is recorded
    rng = np.random.default_rng(14)
    wide = np.zeros(WIDE_N, port.POINT_DTYPE)
    wide["x"], wide["y"], wide["z"] = rng.uniform(-WIDE_HALF, WIDE_HALF, (3, WIDE_N)).astype(np.float32)
    for ch in ("r", "g", "b"):
        wide[ch] = rng.integers(0, 256, WIDE_N)
    wide["tile"] = np.left_shift(1, rng.integers(0, 8, WIDE_N)).astype(np.uint8)
    forms, real_down = [], voxelize.downsample

    def recording_down(buf_, cell_, **kw):
        forms.append(kw)
        return real_down(buf_, cell_, **kw)

    for name, arr, cell in (("bench cloud at 1 mm", c.pts, DOWN_FINE), ("200 m scene at 5 mm", wide, WIDE_CELL)):
        pc = port.cwipc_from_numpy_array(arr, 3, device=c.dev)
        voxelize.downsample = recording_down
        try:
            down = port.cwipc_downsample(pc, cell)
            torch.cuda.synchronize()
        finally:
            voxelize.downsample = real_down
        n, maxc, err, atol = hold_downsample(down.get_numpy_array(), arr, cell, False, name)
        kw = forms[-1]
        check(kw["exact_keys"], f"{name}: cwipc_downsample did not take the exact-key path")
        print(f"{c.card} phase 14: cwipc_downsample, {name}: {n} voxels (at most {maxc} points each),"
              f" exact-key path; voxels, colours and tile OR equal to the numpy oracle, centroids within"
              f" {err} (allowed {atol})")
        out[name] = (pc._access_buffer(), cell)
    # the grid method on the fast downsample's 217,570 points
    x, y, z, rgba, cnt = c.down
    n = int(cnt)
    xyz = torch.stack([x, y, z], -1)
    md = outliers._mean_knn_dist_grid(xyz, cnt, GRID_CELL, GRID_K, cell_cap=GRID_CAP)
    torch.cuda.synchronize()
    xyz_np = xyz[:n].cpu().numpy()
    dist, _ = cKDTree(xyz_np.astype(np.float64)).query(xyz_np.astype(np.float64), k=GRID_K + 1, workers=-1)
    md64 = dist[:, 1:].mean(1)
    fits, maxocc = grid_exact_mask(xyz_np, GRID_CELL, GRID_CAP)
    exact = fits & (dist[:, GRID_K] < GRID_CELL * (1 - 1e-6))
    got = md[:n].double().cpu().numpy()
    gerr = float(np.abs(got[exact] - md64[exact]).max())
    check(np.allclose(got[exact], md64[exact], rtol=1e-5, atol=1e-9),
          f"grid method: md differs from the oracle where the ring holds the k nearest: max abs {gerr}")
    check(bool(torch.isfinite(md).all()) and not md[n:].any(), "grid method: md not finite or tail not zero")
    compact_kernel_cm.launches = 0
    gclean = outliers.remove_outliers(port.PointBuffer(xyz=xyz, rgba=rgba, count=cnt), GRID_K, MULT,
                                      method="grid", cell=GRID_CELL, cell_cap=GRID_CAP)
    torch.cuda.synchronize()
    check(compact_kernel_cm.launches >= 1, "grid method: kernel 3 was not launched")
    print(f"{c.card} phase 14: grid method at cell {GRID_CELL}, cap {GRID_CAP}, k {GRID_K} on {n} points:"
          f" md allclose to the float64 cKDTree oracle on the {int(exact.sum())} points whose k-th neighbour"
          f" lies within one cell (max abs {gerr}); {n - int(exact.sum())} outside that (fullest cell"
          f" {maxocc} points); kept {int(gclean.count)}")
    out["grid"] = (xyz, cnt)
    # the KD-tree route: a cloud no column grid fits, unpatched
    kd = kdtree_cloud()
    pc = port.cwipc_from_numpy_array(kd, 4, device=c.dev)
    kd64 = points_xyz(kd).astype(np.float64)
    k_cell = max(1.0, float(np.sqrt(K / np.pi)) / 3.0) * port_ops._estimate_spacing(pc)
    check(port_ops._cols_grid_params(kd64, k_cell) is None, "the KD-tree cloud fits a column grid")
    compact_kernel_cm.launches = cols_select.launches = 0
    clean = port.cwipc_remove_outliers(pc, K, MULT, False)
    torch.cuda.synchronize()
    check(compact_kernel_cm.launches >= 1 and cols_select.launches == 0,
          "the KD-tree route must compact on kernel 3 and not launch kernel 4")
    md_kd, thr_kd = oracle(kd64)
    got = clean.get_numpy_array()
    mask = kept_mask(got, kd, "KD-tree route")
    check(np.array_equal(got, kd[mask]), "KD-tree route: kept points out of order")
    flips = near_flips(mask, md_kd <= thr_kd, md_kd, thr_kd, "KD-tree route")
    print(f"{c.card} phase 14: KD-tree route on {len(kd)} points ({KD_CLUSTER} in a 2 mm cluster, {KD_SPREAD}"
          f" over a {KD_SIDE} m cube; no column grid fits at cell {k_cell}): kept {len(got)}, oracle"
          f" {int((md_kd <= thr_kd).sum())}, {flips} flips near the threshold")
    out["kd"] = pc
    # one 1M-point frame through the filter factory
    P = perturbation(REG_SEED, REG_TRANSLATION, REG_ROTATION)
    descs = [f"voxelize({CELL!r})", f"remove_outliers({K}, {MULT!r}, False)", f"crop{CROP!r}",
             f"transform44({P.tolist()!r})", "colorize(0.5, 'contributions')", "analyze"]
    kernels = (segment_reduce_sorted, compact_kernel_cm, cols_select, window_knn_mean_distance_cm)

    def run_frame():
        """The frame through the six filters: (clouds, filters, host seconds
        of each stage ending in a synchronize, the host copy-in first)."""
        stage_s = []
        t_0 = time.perf_counter()
        pcs = [port.cwipc_from_numpy_array(c.pts, 42, device=c.dev)]
        pcs[0]._access_buffer()
        flts = [filters.factory(d) for d in descs]
        for f in [None, *flts]:
            if f is not None:
                pcs.append(f.filter(pcs[-1]))
            torch.cuda.synchronize()
            now = time.perf_counter()
            stage_s.append(now - t_0)
            t_0 = now
        return pcs, flts, stage_s

    grids = []

    def recording(xyz_, count_, cell_, k_, **kw):
        grids.append((xyz_, count_, cell_, k_, kw))
        return cols_knn.cols_knn_mean_distance(xyz_, count_, cell_, k_, **kw)

    torch.cuda.synchronize()
    for f in kernels:
        f.launches = 0
    port_ops.cols_knn_mean_distance = recording
    try:
        pcs, flts, _ = run_frame()
        torch.cuda.synchronize()
    finally:
        port_ops.cols_knn_mean_distance = cols_knn.cols_knn_mean_distance
    launches = {f.__name__: f.launches for f in kernels}
    check(len(grids) == launches["cols_select"], f"filter remove_outliers: {len(grids)} column grids,"
          f" {launches['cols_select']} launches of kernel 4")
    for xyz_, count_, cell_, k_, kw in grids:
        g_planes = cols_knn._cols_build(xyz_, count_, cell_, gy=kw["gy"], gz=kw["gz"], cap=kw["cap"], chunk=CHUNK,
                                        vmin_override=kw["vmin_override"], want_orig=False)[:3]
        hold_select(g_planes, cell_, f"filter remove_outliers, grid {kw['gy']} x {kw['gz']} x {kw['cap']}", k_,
                    kw["gy"], kw["gz"], kw["cap"], chunk=64)
    check(all(launches[f.__name__] >= 1 for f in kernels[:3]),
          f"kernels 1, 3 and 4 must run on the filter path: {launches}")
    arrs = [p.get_numpy_array() for p in pcs]
    sizes = [len(a) for a in arrs]
    nvox, _, verr, _ = hold_downsample(arrs[1], arrs[0], CELL, True, "filter voxelize")
    check(nvox == WANT_VOXELS, f"filter voxelize: {nvox} voxels, expected {WANT_VOXELS}")
    md_f, thr_f = oracle(points_xyz(arrs[1]).astype(np.float64))
    mask = kept_mask(arrs[2], arrs[1], "filter remove_outliers")
    check(np.array_equal(arrs[2], arrs[1][mask]), "filter remove_outliers: kept points out of order")
    f_flips = near_flips(mask, md_f <= thr_f, md_f, thr_f, "filter remove_outliers")
    box = np.float32(CROP)
    p3 = points_xyz(arrs[2])
    inside = np.all((p3 >= box[0::2]) & (p3 < box[1::2]), axis=1)
    check(0 < inside.sum() < len(p3) and np.array_equal(arrs[3], arrs[2][inside]),
          "filter crop: not the points inside the box, or the box does not cut the body")
    moved64 = points_xyz(arrs[3]).astype(np.float64) @ P[:3, :3].T + P[:3, 3]
    want4 = arrs[3].copy()
    want4["x"], want4["y"], want4["z"] = moved64.astype(np.float32).T
    check(np.array_equal(arrs[4], want4), "filter transform44 differs from the numpy oracle")
    tbuf = port.buffer_from_numpy(arrs[3], device=c.dev)
    t44 = compaction.transform44(tbuf, P)
    terr = float(np.abs(t44.xyz[:len(arrs[3])].double().cpu().numpy() - moved64).max())
    check(terr < 2e-6, f"ops transform44 on the card: {terr} from the float64 oracle (TF32 would be ~1e-3)")
    bitcount = [(0.2, 0.2, 0.2), (1, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0.5, 0.5, 0),
                (0, 0.5, 0.5), (0.5, 0, 0.5), (0, 0, 0)]
    lut = np.array([bitcount[bin(i).count("1")] for i in range(256)]) * 255.0
    want5 = arrs[4].copy()
    for i, ch in enumerate(("r", "g", "b")):
        want5[ch] = np.floor(lut[arrs[4]["tile"], i] * 0.5 + arrs[4][ch] * 0.5).astype(np.uint8)
    check(np.array_equal(arrs[5], want5), "filter colorize differs from the numpy oracle")
    an = flts[5]
    p5 = points_xyz(arrs[5]).astype(np.float64)
    check(pcs[6] is pcs[5] and np.allclose(an.mins, p5.min(0)) and np.allclose(an.maxs, p5.max(0))
          and np.allclose(an.sum_avg, p5.mean(0), atol=1e-6), "filter analyze: statistics differ")
    print(f"{c.card} phase 14: filter frame {descs[:3]}, transform44(seed-42 perturbation), {descs[4:]}:"
          f" points per stage {sizes}; voxelize {nvox} voxels (centroids within {verr}); remove_outliers"
          f" equal to the float64 oracle ({f_flips} flips near the threshold; kernel 4 held to its plain version on"
          f" grids {[(kw['gy'], kw['gz'], kw['cap']) for *_, kw in grids]}); crop, transform44 and colorize"
          f" equal to numpy; ops.transform44 on the card within {terr} of float64; launches {launches}")
    an.statistics()
    print(f"{c.card} phase 14 ok {c.lap()}")
    out.update(run_frame=run_frame, descs=descs, launches=launches)
    return out


def device_and_host(c, what, fn, unit):
    """Print fn's device time a call by kernel (torch.profiler over 10
    calls) and its host time a call (50 calls enqueued, then one
    synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    per = [(e.key, e.count // 10, e.device_time_total / 10) for e in prof.key_averages() if e.device_time_total > 0]
    torch.cuda.synchronize()
    t_0 = time.perf_counter()
    for _ in range(50):
        fn()
    host_us = (time.perf_counter() - t_0) / 50 * 1e6
    torch.cuda.synchronize()
    device = f"{sum(us for _, _, us in per)} us device time a {unit}" if per else "device time not measured"
    print(f"{c.card} {what}: {device} (by kernel: launches, us {[(k[:48], n_, us) for k, n_, us in per]});"
          f" host {host_us} us a call")


def host_us(fn, n=200):
    """Host microseconds a call of fn, n calls back to back between two
    synchronizes."""
    import torch

    fn()
    torch.cuda.synchronize()
    t_0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t_0
    torch.cuda.synchronize()
    return dt / n * 1e6


def compact_host_phase(c):
    """Kernel 3's call split: the host microseconds of each part of the
    wrapper (its checks, its one allocation, the device guard, the
    pointers and stream, the ctypes call that makes the memset and the
    launch) next to what the earlier wrapper spent on the same parts (four
    allocations, a device context, ctypes.c_void_p arguments), and the
    device time by kernel of the wrapper and of ``packed[keep]``."""
    import ctypes

    import torch

    from cwipc_util_tpu_torch import _kernels
    from cwipc_util_tpu_torch.ops.compact_kernel import TILE, compact_kernel_cm, compact_plan

    x, y, z, rgba, cnt = c.down
    keep = c.keep
    n, dev = x.shape[0], x.device
    lib = _kernels.load()
    packed = torch.stack([x.view(torch.int32), y.view(torch.int32), z.view(torch.int32), rgba], dim=-1)
    work = torch.empty(compact_plan(n).words, dtype=torch.int32, device=dev)
    ins = (x, y, z, rgba, keep, cnt)

    def checks():
        for name, t in (("x", x), ("y", y), ("z", z)):
            _kernels.expect("compact", name, t, torch.float32, (n,))
        _kernels.expect("compact", "rgba", rgba, torch.int32, (n,))
        _kernels.expect("compact", "keep", keep, torch.bool, (n,))
        _kernels.expect("compact", "count", cnt, torch.int32, ())
        _kernels.route("compact", *ins)

    def guard():
        with _kernels.device_guard(x):
            pass

    def context_before():
        with torch.cuda.device(dev):
            pass

    def pointers():
        return [t.data_ptr() for t in ins] + [work.data_ptr(), _kernels.stream(x)]

    def pointers_before():
        return ([ctypes.c_void_p(t.data_ptr()) for t in (*ins, work, work, work, work, work, work, work)]
                + [ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)])

    args = [t.data_ptr() for t in ins[:6]] + [n, work.data_ptr(), _kernels.stream(x)]
    ntiles = -(-n // TILE)
    parts = {
        "checks": checks,
        "allocation (one buffer)": lambda: torch.empty(compact_plan(n).words, dtype=torch.int32, device=dev),
        "allocations before (four)": lambda: (
            torch.empty(ntiles, dtype=torch.int32, device=dev), torch.empty(ntiles, dtype=torch.int32, device=dev),
            torch.empty((4, n), dtype=torch.int32, device=dev), torch.empty((), dtype=torch.int32, device=dev)),
        "device guard": guard,
        "device context before": context_before,
        "pointers and stream": pointers,
        "pointers and stream before (ctypes.c_void_p)": pointers_before,
        "ctypes call (memset and launch)": lambda: lib.cwipc_compact(*args),
        "the whole wrapper": lambda: compact_kernel_cm(x, y, z, rgba, keep, cnt),
        "packed[keep]": lambda: packed[keep],
    }
    split = {name: host_us(fn) for name, fn in parts.items()}
    print(f"{c.card} kernel 3 at n={n}, host us a call by part: {split}")
    for name, fn in (("kernel 3", parts["the whole wrapper"]), ("packed[keep]", parts["packed[keep]"])):
        device_and_host(c, f"{name} at n={n}", fn, "call")


def reduce_host_phase(c):
    """Kernels 1 and 2 split: each wrapper's host microseconds a call by
    part (its checks, its allocation, the device guard, the pointers and
    stream, the ctypes call with its memset and launch, kernel 1's output
    views) with kernel 1's earlier six allocations beside its one and
    kernel 2's earlier checks beside its own; and the
    device time by kernel and host time a call of kernel 1 at the fast
    chain's sorted stream and of kernel 2 at the chain's window and at the
    window method's default."""
    import torch

    from cwipc_util_tpu_torch import _kernels
    from cwipc_util_tpu_torch.ops.segment_reduce import NROWS, TILE, segment_plan, segment_reduce_sorted
    from cwipc_util_tpu_torch.ops.window_knn import MAX_WINDOW, window_knn_mean_distance_cm

    smk, sfr, srgba = c.sorted
    x, y, z, _rgba, cnt = c.down
    n, dev = smk.shape[0], smk.device
    m = x.shape[0]
    lib = _kernels.load()
    ntiles = -(-n // TILE)
    plan = segment_plan(n, OCAP)
    work = torch.empty(plan.words, dtype=torch.int32, device=dev)
    md = torch.empty(m, dtype=torch.float32, device=dev)

    def checks():
        return _kernels.expect_rows("reduce", ("smk", "sfr", "srgba"), (smk, sfr, srgba), torch.int32, n)

    def checks2():
        kind = _kernels.expect_rows("knn", ("x", "y", "z"), (x, y, z), torch.float32, m)
        if cnt.dtype is not torch.int32 or cnt.dim() != 0 or cnt.device != x.device:
            raise RuntimeError("count")
        if not 1 <= WINDOW <= MAX_WINDOW or K < 1:
            raise RuntimeError("window")
        return kind

    def checks2_before():  # expect() on each argument, then route()
        for name, t_ in (("x", x), ("y", y), ("z", z)):
            _kernels.expect("knn", name, t_, torch.float32, (m,))
        _kernels.expect("knn", "count", cnt, torch.int32, ())
        if not 1 <= WINDOW <= MAX_WINDOW or K < 1:
            raise RuntimeError("window")
        _kernels.route("knn", x, y, z, cnt)

    def guard():
        with _kernels.device_guard(smk):
            pass

    def views():
        rows = work[:plan.key_at].view(torch.float32).view(NROWS, OCAP)
        return rows, work[plan.key_at:plan.nseg_at], work[plan.nseg_at]

    args = [smk.data_ptr(), sfr.data_ptr(), srgba.data_ptr(), n, OCAP, work.data_ptr(), _kernels.stream(smk)]
    args2 = [x.data_ptr(), y.data_ptr(), z.data_ptr(), cnt.data_ptr(), m, WINDOW, min(K, 2 * WINDOW),
             md.data_ptr(), _kernels.stream(x)]
    parts = {
        "checks": checks,
        "allocation (one buffer)": lambda: torch.empty(segment_plan(n, OCAP).words, dtype=torch.int32, device=dev),
        "allocations before (six)": lambda: (
            torch.empty((NROWS, OCAP), dtype=torch.int32, device=dev),
            torch.empty(ntiles, dtype=torch.int32, device=dev), torch.empty(ntiles, dtype=torch.int32, device=dev),
            torch.empty((NROWS, OCAP), dtype=torch.float32, device=dev),
            torch.empty(OCAP, dtype=torch.int32, device=dev), torch.empty((), dtype=torch.int32, device=dev)),
        "device guard": guard,
        "pointers and stream": lambda: [t_.data_ptr() for t_ in (smk, sfr, srgba, work)] + [_kernels.stream(smk)],
        "ctypes call (memset and launch)": lambda: lib.cwipc_segment_reduce(*args),
        "output views": views,
        "the whole wrapper": lambda: segment_reduce_sorted(smk, sfr, srgba, OCAP),
    }
    split = {name: host_us(fn) for name, fn in parts.items()}
    print(f"{c.card} kernel 1 at n={n}, ocap {OCAP}, host us a call by part: {split}")
    parts2 = {
        "checks": checks2,
        "checks before (expect and route)": checks2_before,
        "allocation": lambda: torch.empty(m, dtype=torch.float32, device=dev),
        "device guard": guard,
        "pointers and stream": lambda: [t_.data_ptr() for t_ in (x, y, z, cnt, md)] + [_kernels.stream(x)],
        "ctypes call (launch)": lambda: lib.cwipc_window_knn(*args2),
        "the whole wrapper": lambda: window_knn_mean_distance_cm(x, y, z, cnt, K, WINDOW),
    }
    split2 = {name: host_us(fn) for name, fn in parts2.items()}
    print(f"{c.card} kernel 2 at n={m}, k {K}, window {WINDOW}, host us a call by part: {split2}")
    device_and_host(c, f"kernel 1 at n={n}, ocap {OCAP}", parts["the whole wrapper"], "call")
    for k, w in ((K, WINDOW), (K, 32)):
        device_and_host(c, f"kernel 2 at n={m}, k {k}, window {w}",
                        lambda: window_knn_mean_distance_cm(x, y, z, cnt, k, w), "call")


def times_phase(c, s12, s13, s14, k4):
    """Phase 15: times with CUDA events; returns kernels 6 and 7's records."""
    import torch

    from cwipc_util_tpu_torch.ops import outliers, voxelize
    from cwipc_util_tpu_torch.ops.scan_probe import FORMS, scan_program, scan_program_plain
    from cwipc_util_tpu_torch.ops.sort_kernel import sort_by_key, sort_by_key_plain

    records = []
    mkey, fracs, rgba = s12["mkey"], s12["fracs"], c.buf.rgba

    def library_sort():  # what _sort_front pays now: torch.sort, then the gathers
        skey, order = torch.sort(mkey)
        return skey, torch.gather(fracs, 0, order), torch.gather(rgba, 0, order)

    def k6():
        return sort_by_key(mkey, fracs, rgba)

    def k6_plain():
        return sort_by_key_plain(mkey, fracs, rgba)

    kms, pms, lms, runs = in_turns(k6, k6_plain, library_sort)
    nbytes = 2 * tensor_bytes(mkey, fracs, rgba)  # keys and two payloads, read and written once
    bms, bby = bound(nbytes, 0)
    print(f"{c.card} kernel sort_by_key at {mkey.shape[0]} x 3: {kms} ms ({s12['plan'].launches} launches a"
          f" sort, passes run {s12['passes']}); plain PyTorch {pms} ms; torch.sort + 2 gathers {lms} ms"
          f" ({'kernel 6 faster' if kms < lms else 'kernel 6 slower'}); in turns (plain, torch.sort + gathers,"
          f" kernel, kernel, torch.sort + gathers, plain) {runs}; bound {bms} ms ({bby}: {nbytes} bytes)")
    # where the two spend it: device time per sort by kernel and host time per call
    for name, fn in (("kernel 6", k6), ("torch.sort + 2 gathers", library_sort)):
        device_and_host(c, f"{name} at {mkey.shape[0]} x 3", fn, "sort")
    records.append({
        "name": "sort_by_key", "route": "cuda", "source": "cwipc_util_tpu_torch/csrc/sort.cu",
        "replaces": "cwipc_util_tpu/ops/pallas_sort.py:169", "launches": s12["launches"],
        "max_abs_err": s12["err"], "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": bby,
        "library_ms": lms,
    })
    compact_host_phase(c)
    reduce_host_phase(c)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = INT32_LANES * sms * float(clock) * 1e6
    steps = SCAN_S * SCAN_TILES * 128 * SCAN_T
    rates = {}
    for f in FORMS:
        x = s13["xs"][f]
        kf = time_ms(lambda: scan_program(x, f, SCAN_T))
        pf = time_ms(lambda: scan_program_plain(x, f, SCAN_T), reps=3, warm=1)
        rates[f] = steps / (kf / 1e3)
        # the ones product on the tensor cores for mxu (JAX's ones [8, S]), else one int32 issue a step
        ops_ms = (2 * 8 * steps / F16_TENSOR_FLOPS if f == "mxu" else steps / int32_rate) * 1e3
        fbms, fbby = bound(tensor_bytes(x) + 8 * x.shape[1] * 4, 0)
        if ops_ms > fbms:
            fbms, fbby = ops_ms, "operations"
        print(f"{c.card} kernel scan_program ({f}): {kf} ms, {rates[f]} element-steps/s; plain PyTorch {pf} ms;"
              f" bound {fbms} ms ({fbby})")
        if f == "i32":
            records.append({
                "name": "scan_program", "route": "cuda", "source": "cwipc_util_tpu_torch/csrc/scan_probe.cu",
                "replaces": "benchmarks/sel_roofline.py:114", "launches": s13["launches"], "max_abs_err": s13["err"],
                "ms": kf, "plain_ms": pf, "bound_ms": fbms, "bound_by": fbby, "library_ms": None,
            })
    print(f"{c.card} the int32 issue rate: {INT32_LANES} lanes x {sms} SMs x {clock} MHz = {int32_rate} /s;"
          f" {steps} element-steps a run")
    k4_steps = k4["pairs"] * K4_MAX_STEPS
    k4_run = k4["pairs"] * k4["scans"]
    print(f"{c.card} kernel 4's scan yardstick: {k4['pairs']} ring pairs x at most {K4_MAX_STEPS} halving"
          f" steps = {k4_steps} element-steps, {k4_steps / rates['i32'] * 1e3} ms at kernel 7's i32 rate; x the"
          f" {k4['scans']} scans a query kernel 4 ran = {k4_run} element-steps, {k4_run / rates['i32'] * 1e3} ms"
          f" (kernel 4 {k4['ms']} ms)")
    for name, (buf_, cell) in ((k, v) for k, v in s14.items() if k.endswith("mm")):
        ms = time_ms(lambda: voxelize.downsample(buf_, cell, exact_keys=True), reps=5, warm=1)
        print(f"{c.card} exact-key downsample, {name}: median {ms} ms")
    gxyz, gcnt = s14["grid"]
    gms = time_ms(lambda: outliers._mean_knn_dist_grid(gxyz, gcnt, GRID_CELL, GRID_K, cell_cap=GRID_CAP),
                  reps=5, warm=1)
    print(f"{c.card} grid method md at {int(gcnt)} points: median {gms} ms")
    # the KD-tree route is host work on a CUDA cloud: copy out, cKDTree, md back
    import cwipc_util_tpu_torch as port

    kd_pc, kd_s = s14["kd"], []
    for _ in range(3):
        torch.cuda.synchronize()
        t_0 = time.perf_counter()
        port.cwipc_remove_outliers(kd_pc, K, MULT, False)
        torch.cuda.synchronize()
        kd_s.append(time.perf_counter() - t_0)
    print(f"{c.card} KD-tree route (host cKDTree) on {kd_pc.count()} points: median {statistics.median(kd_s)} s"
          f" (host clock; runs {kd_s})")
    frames = [s14["run_frame"]()[2] for _ in range(3)]
    stage_s = [statistics.median(st) for st in zip(*frames)]
    names = ["copy in (1M points)"] + [d.split("(")[0] for d in s14["descs"]]
    print(f"{c.card} filter frame (1M points in, six filters, host copies included): median"
          f" {statistics.median(sum(st) for st in frames)} s; stages (median s) {dict(zip(names, stage_s))}")
    print(f"{c.card} phase 15 ok {c.lap()}")
    return records


# phase 16, the codec: the synthetic source's default frame and the bench
# body with its tiles on the x > 0 half raised by 0x80; four encoder
# configurations (label, octree_bits of the members, tile mask); warm
# frames timed and frames sent through the sinks
CODEC_N = 160000
CODEC_CONFIGS = (("solo 9, tile 0", (9,), 0), ("solo 9, tile 1", (9,), 1),
                 ("group 9/8/7, tile 0", (9, 8, 7), 0), ("solo 10, tile 0", (10,), 0))
CODEC_REPS, CODEC_WARM = 20, 3
ROUNDTRIP_FRAMES = 10


class MemoryLink:
    """A raw sink whose packets a raw source reads, in process: what the
    encoder sink feeds (start, stop, set_fourcc, add_stream, feed) and
    what the decoder source reads (get, available, eof)."""

    def __init__(self):
        import queue

        self.packets = queue.Queue()
        self.fourcc = None
        self.closed = False

    def start(self):
        pass

    def stop(self):
        self.closed = True
        self.packets.put(None)

    def set_fourcc(self, fourcc):
        self.fourcc = fourcc

    def add_stream(self, tilenum=None, tiledesc=None, qualitydesc=None):
        return 0

    def feed(self, buffer, stream_index=None):
        self.packets.put(bytes(buffer))
        return True

    def get(self):
        return self.packets.get(timeout=30)

    def available(self, wait=False):
        return not self.packets.empty()

    def eof(self):
        return self.closed and self.packets.empty()


def drain(src, n, timeout=60.0):
    """Up to n clouds from an active source, stopping at its end or the deadline."""
    got, deadline = [], time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        if src.available(False):
            pc = src.get()
            if pc is None:
                break
            got.append(pc)
        elif src.eof():
            break
        else:
            time.sleep(0.002)
    return got


def seam_cells(arr, step, tile):
    """The cells (absolute, at the stream's step) of the points where the
    host twin's floor(x / step) and the device program's floor(x * (1 /
    step)) disagree: the two routes' one documented seam."""
    import numpy as np

    if tile:
        arr = arr[(arr["tile"] & tile) != 0]
    s = np.float32(step)
    xyz = np.stack([arr[f] for f in "xyz"], -1)
    a, b = np.floor(xyz / s).astype(np.int64), np.floor(xyz * (np.float32(1) / s)).astype(np.int64)
    bad = (a != b).any(1)
    return np.unique(np.concatenate([a[bad], b[bad]]), axis=0)


def voxel_rows(arr, step, drop_cells):
    """A decoded cloud as (cell x, y, z, r, g, b, tile) rows, absolute cells
    at the stream's step (each position is a cell centre), without the rows
    in ``drop_cells``."""
    import numpy as np

    cells = np.floor(np.stack([arr[f] for f in "xyz"], -1).astype(np.float64) / step).astype(np.int64)
    rows = np.concatenate([cells] + [arr[f].astype(np.int64)[:, None] for f in ("r", "g", "b", "tile")], 1)

    def key(c):
        c = c + (1 << 20)
        return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]

    return rows[~np.isin(key(cells), key(drop_cells))]


def codec_phase(c):
    """Phase 16: the compressed streaming path, in process, on the card.

    Each frame goes through each encoder configuration once with the
    launch counts at 0 (kernel 1 once at 9 bits and below, kernel 3 once
    at a tile mask, neither at 10), counting the host reads of each encode
    (CUDA's sync debug mode).  Then: the device program on the CUDA cloud
    bit-equal to the same function on a CPU copy (the plain versions), the
    streams byte-equal, every kernel call of the run equal to its plain
    version, the group's deepest member byte-equal to a solo encode,
    the decoded stream against the host twin's (equal outside the cells
    of the seam points, and everywhere when there are none); 10 frames
    through cwipc_sink_encoder -> MemoryLink -> cwipc_source_decoder; then
    the times.  Returns the codec run's launches by kernel."""
    import struct
    import warnings
    import zlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cwipc_util_tpu_torch as port
    from cwipc_util_tpu_torch import codec
    from cwipc_util_tpu_torch.core.pointcloud import cwipc_pointcloud_wrapper
    from cwipc_util_tpu_torch.net.sink_encoder import cwipc_sink_encoder
    from cwipc_util_tpu_torch.net.source_decoder import cwipc_source_decoder
    from cwipc_util_tpu_torch.ops import compaction, voxelize
    from cwipc_util_tpu_torch.ops.compact_kernel import compact_kernel_cm, compact_plain_cm
    from cwipc_util_tpu_torch.ops.segment_reduce import segment_reduce_sorted, segment_reduce_sorted_plain

    src = port.cwipc_synthetic(0, CODEC_N, device=c.dev)
    src.start()
    f160 = src.get()
    body = c.pts.copy()
    body["tile"] = np.where(body["x"] > 0, body["tile"] | 0x80, body["tile"])
    f1m = port.cwipc_from_numpy_array(body, 1, device=c.dev)
    frames = {f"{f160.count()}-point synthetic frame": f160, f"{f1m.count()}-point body": f1m}
    for pc in frames.values():
        pc._access_buffer()
    print(f"{c.card} phase 16: color route {'JPEG plane (cv2)' if codec.jpeg_available() else 'zlib (no cv2)'};"
          f" native shim {'loaded' if codec.native_loaded() else 'not loaded: the numpy twins run'};"
          f" frames {list(frames)}; the body's tiles {sorted(set(body['tile'].tolist()))}")

    def encoder(bits, tile, quality=85):
        """(what to feed, the members whose bytes come out)."""
        if len(bits) == 1:
            enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=bits[0], tilenumber=tile,
                                                                            jpeg_quality=quality))
            return enc, [enc]
        group = codec.cwipc_new_encodergroup()
        return group, [group.addencoder(params=codec.cwipc_encoder_params(octree_bits=b, tilenumber=tile,
                                                                          jpeg_quality=quality)) for b in bits]

    def encode(pc, bits, tile, quality=85):
        top, members = encoder(bits, tile, quality)
        top.feed(pc)
        return [e.get_bytes() for e in members]

    # the codec path once, counts at 0 just before; the kernel calls recorded
    calls = []
    real_k1, real_k3 = voxelize.segment_reduce_sorted, compaction.compact_kernel_cm

    def rec_k1(*args):
        out = real_k1(*args)
        calls.append(("segment_reduce", args, out))
        return out

    def rec_k3(*args):
        out = real_k3(*args)
        calls.append(("compact", args, out))
        return out

    kernels = (segment_reduce_sorted, compact_kernel_cm)
    streams, reads, per_config = {}, {}, {}
    voxelize.segment_reduce_sorted, compaction.compact_kernel_cm = rec_k1, rec_k3
    torch.cuda.synchronize()
    for f in kernels:
        f.launches = 0
    try:
        for fname, pc in frames.items():
            for cname, bits, tile in CODEC_CONFIGS:
                before = {f.__name__: f.launches for f in kernels}
                torch.cuda.set_sync_debug_mode("warn")
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    streams[fname, cname] = encode(pc, bits, tile)
                torch.cuda.set_sync_debug_mode("default")
                reads[fname, cname] = sum("synchroniz" in str(w.message) for w in caught)
                per_config[fname, cname] = {f.__name__: f.launches - before[f.__name__] for f in kernels}
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        voxelize.segment_reduce_sorted, compaction.compact_kernel_cm = real_k1, real_k3
    launches = {f.__name__: f.launches for f in kernels}
    for (fname, cname), got in per_config.items():
        bits, tile = next((b, t) for n, b, t in CODEC_CONFIGS if n == cname)
        want = {"segment_reduce_sorted": int(max(bits) <= 9), "compact_kernel_cm": int(tile != 0)}
        check(got == want, f"codec, {fname}, {cname}: launches {got}, expected {want}")
        check(reads[fname, cname] == 1, f"codec, {fname}, {cname}: {reads[fname, cname]} host reads, expected 1")
    check(launches["segment_reduce_sorted"] >= 1 and launches["compact_kernel_cm"] >= 1,
          f"a kernel of the codec path was not launched: {launches}")
    print(f"{c.card} phase 16: the codec path (each frame through each configuration) launched {launches};"
          f" host reads an encode {sorted(set(reads.values()))}; by configuration {per_config}")

    # every kernel call of that run against its plain version on its inputs
    k_err = {"segment_reduce": 0.0, "compact": 0.0}
    for name, args, out in calls:
        want = (segment_reduce_sorted_plain if name == "segment_reduce" else compact_plain_cm)(*args)
        check(all(same_bits(a, b) for a, b in zip(out, want)), f"codec: kernel {name} differs from its plain version"
              f" at n={args[0].shape[0]}")
        k_err[name] = max(k_err[name], max(maxabs(a.float(), b.float()) for a, b in zip(out, want)))
    print(f"{c.card} phase 16: all {len(calls)} kernel calls of the codec run bit-equal to their plain versions"
          f" ({sorted({(n, int(a[0].shape[0])) for n, a, _ in calls})})")

    # the plain route: the device program on a CPU copy, its stream, the host twin
    for fname, pc in frames.items():
        buf = pc._access_buffer()
        cpu_pc = cwipc_pointcloud_wrapper(port.PointBuffer(xyz=buf.xyz.cpu(), rgba=buf.rgba.cpu(),
                                                           count=buf.count.cpu()), pc.timestamp(), pc.cellsize())
        arr = pc.get_numpy_array()
        for cname, bits, tile in CODEC_CONFIGS:
            if len(bits) > 1:  # its shared pass is the solo encode's at its deepest member
                check(streams[fname, cname][0] == streams[fname, f"solo {bits[0]}, tile {tile}"][0],
                      f"codec, {fname}: the group's deepest member differs from a solo encode")
                continue
            kw = dict(octree_bits=bits[0], exp_factor=1.0, voxelsize=0.0, tilemask=tile)
            got = codec._encode_device_impl(buf.xyz, buf.rgba, buf.count, **kw)
            want = codec._encode_device_impl(cpu_pc._buffer.xyz, cpu_pc._buffer.rgba, cpu_pc._buffer.count, **kw)
            check(all(same_bits(a.cpu(), b) for a, b in zip(got, want)),
                  f"codec, {fname}, {cname}: the device program differs from its CPU run")
            m = int(got[0])
            check(bool((got[2][:m] < 0).any()) == (fname.endswith("body")),
                  f"codec, {fname}, {cname}: tiles of 0x80 and above expected only in the body")
            solo = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=bits[0], tilenumber=tile))
            solo._feed_device(cpu_pc)
            cpu_stream = solo.get_bytes()
            check(streams[fname, cname][0] == cpu_stream,
                  f"codec, {fname}, {cname}: the stream differs from the CPU copy's device program")
            # decoded against the host twin (jpeg_quality 100: lossless colors on both)
            dev_blob = encode(pc, bits, tile, quality=100)[0]
            solo = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=bits[0], tilenumber=tile,
                                                                             jpeg_quality=100))
            solo._feed_host(cpu_pc)
            host_blob = solo.get_bytes()
            step = struct.unpack("<f", dev_blob[20:24])[0]
            check(step == struct.unpack("<f", host_blob[20:24])[0], f"codec, {fname}, {cname}: steps differ")
            dec = codec.cwipc_new_decoder(device="cpu")
            dec.feed(dev_blob)
            a = dec.get().get_numpy_array()
            dec.feed(host_blob)
            b = dec.get().get_numpy_array()
            seam = seam_cells(arr, step, tile)
            if len(seam) == 0:
                check(a.shape == b.shape and all(np.array_equal(a[f], b[f]) for f in ("r", "g", "b", "tile"))
                      and all(float(np.abs(a[f] - b[f]).max(initial=0.0)) <= step * 1.0001 for f in "xyz"),
                      f"codec, {fname}, {cname}: decoded device and host-twin streams break the contract")
            ra, rb = voxel_rows(a, step, seam), voxel_rows(b, step, seam)
            check(ra.shape == rb.shape and np.array_equal(ra, rb),
                  f"codec, {fname}, {cname}: decoded device and host-twin voxels differ outside the seam cells")
            print(f"{c.card} phase 16: {fname}, {cname}: {m} voxels; device program bit-equal to its CPU run,"
                  f" stream byte-equal ({len(cpu_stream)} bytes); decoded against the host twin: {len(a)} and"
                  f" {len(b)} voxels, {len(ra)} equal outside {len(seam)} seam cells")

    # 10 frames through the sinks, in process, against the solo decoder's counts
    link = MemoryLink()
    sink = cwipc_sink_encoder(link, nodrop=True)
    dsrc = cwipc_source_decoder(link, device=c.dev)
    sent = [src.get() for _ in range(ROUNDTRIP_FRAMES)]
    want = []
    for pc in sent:
        dec = codec.cwipc_new_decoder(device=c.dev)
        dec.feed(encode(pc, (9,), 0)[0])
        want.append((pc.timestamp(), dec.get().count()))
    dsrc.start()
    sink.start()
    for pc in sent:
        sink.feed(pc.clone())
    sink.stop()
    got = drain(dsrc, ROUNDTRIP_FRAMES)
    dsrc.stop()
    src.stop()
    check([(pc.timestamp(), pc.count()) for pc in got] == want,
          f"round trip: {[(pc.timestamp(), pc.count()) for pc in got]}, expected {want}")
    check(all(pc._device.type == "cuda" for pc in got), "round trip: decoded clouds not for the card")
    print(f"{c.card} phase 16: round trip cwipc_sink_encoder -> MemoryLink -> cwipc_source_decoder: all"
          f" {len(got)} frames, counts {[n for _, n in want]} as the solo decoder's")

    # times: encode and its parts, decode, the kernels' device time in an encode
    def host_ms(fn, reps=CODEC_REPS, warm=CODEC_WARM):
        for _ in range(warm):
            fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t_0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t_0) * 1e3)
        return statistics.median(out)

    for fname, pc in frames.items():
        enc_ms = {}
        for cname, bits, tile in CODEC_CONFIGS:
            enc_ms[cname] = host_ms(lambda: encode(pc, bits, tile))
            blobs = streams[fname, cname]
            dec = codec.cwipc_new_decoder(device=c.dev)

            def decode():
                for blob in blobs:
                    dec.feed(blob)
                    dec.get()

            def decode_upload():
                for blob in blobs:
                    dec.feed(blob)
                    dec.get()._access_buffer()

            print(f"{c.card} codec {fname}, {cname}: encode median {enc_ms[cname]} ms a frame; decode {host_ms(decode)} ms;"
                  f" decode and upload to the card {host_ms(decode_upload)} ms ({[len(b) for b in blobs]} bytes;"
                  f" host clock with synchronize, median of {CODEC_REPS} warm frames)")
        # the parts of the solo 9-bit encode, as _pack runs them
        geo = dict(octree_bits=9, exp_factor=1.0, tilemask=0)
        m, deltas, drgba, step, origin = codec._geometry_device(pc, **geo)
        keys = np.cumsum(deltas, dtype=np.uint32).astype(np.int64)
        increasing = bool(np.all(np.diff(keys) > 0))
        occ = codec._octree_pack(keys, 9)
        rgb = np.stack([(drgba >> 16) & 0xFF, (drgba >> 8) & 0xFF, drgba & 0xFF], 1).astype(np.uint8)

        def color():
            blob = codec._jpeg_pack(rgb, 85)
            return blob if blob is not None and len(blob) < 3 * m // 2 else zlib.compress(rgb.tobytes(), 1)

        parts = {
            "device program + readback": lambda: codec._geometry_device(pc, **geo),
            "keys (uint32 cumsum)": lambda: np.cumsum(deltas, dtype=np.uint32).astype(np.int64),
            "sorted-unique cleanup": lambda: np.all(np.diff(keys) > 0) or np.unique(keys, return_index=True),
            "octree pack": lambda: codec._octree_pack(keys, 9),
            "color": color,
            "zlib (geometry + tiles)": lambda: (zlib.compress(occ.tobytes(), 1),
                                                zlib.compress(((drgba >> 24) & 0xFF).astype(np.uint8).tobytes(), 1)),
        }
        part_ms = {name: host_ms(fn) for name, fn in parts.items()}
        print(f"{c.card} codec {fname}, solo 9, tile 0, the encode's parts (median ms): {part_ms}; sum"
              f" {sum(part_ms.values())} ms; keys {'increasing' if increasing else 'not increasing: np.unique ran'}")
        # device time by kernel inside one encode at 9 bits with the tile mask (kernels 1 and 3)
        encode(pc, (9,), 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                encode(pc, (9,), 1)
            torch.cuda.synchronize()
        per = [(e.key, e.count // 5, e.device_time_total / 5) for e in prof.key_averages() if e.device_time_total > 0]
        k13 = {name: sum(us for k, _, us in per if name in k) for name in ("segment_reduce", "compact")}
        total = sum(us for _, _, us in per)
        print(f"{c.card} codec {fname}, solo 9, tile 1: device time an encode {total} us (busy"
              f" {total / 10 / enc_ms['solo 9, tile 1']} % of the encode's host time), of it kernel 1"
              f" {k13['segment_reduce']} us, kernel 3 {k13['compact']} us (torch.profiler over 5 encodes); the"
              f" five longest {sorted(((us, k[:40]) for k, _, us in per), reverse=True)[:5]}")
    print(f"{c.card} phase 16 ok {c.lap()}")
    return {"launches": launches, "err": k_err}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to check", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cwipc_util_tpu_torch")):
        print("chip_smoke: the cwipc_util_tpu_torch package is not beside this script;"
              " run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import cwipc_util_tpu_torch as port
    import cwipc_util_tpu_torch.ops as port_ops
    from cwipc_util_tpu_torch import _kernels
    from cwipc_util_tpu_torch.models.synthetic import _generate_host
    from cwipc_util_tpu_torch.ops import chain, cols_knn, compaction, outliers, voxelize
    from cwipc_util_tpu_torch.ops.cols_select import UNION_COLS, cols_select, cols_select_plain, select_plan
    from cwipc_util_tpu_torch.ops.compact_kernel import compact_kernel_cm, compact_plain_cm
    from cwipc_util_tpu_torch.ops.segment_reduce import (
        segment_reduce_sorted,
        segment_reduce_sorted_plain,
    )
    from cwipc_util_tpu_torch.ops.window_knn import (
        window_knn_mean_distance_cm,
        window_knn_mean_distance_plain,
    )

    dev = torch.device("cuda")
    gen = np.random.default_rng(0)

    # ---- phase 1: start ---------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.load()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    card = f"[{smi}]"
    t_phase = [t0]

    def lap():
        """Wall seconds since the previous phase ended."""
        now = time.perf_counter()
        dt, t_phase[0] = now - t_phase[0], now
        return f"({dt:.1f} s)"

    print(f"{card} phase 1 ok {lap()}: kernels built in {build_s} s into {lib_path.name};"
          f" torch {torch.__version__}, CUDA {torch.version.cuda}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- phase 2: each kernel against its plain version -------------------
    pts = _generate_host(HSTEPS, HSTEPS, 0.5)
    buf = port.buffer_from_numpy(pts, capacity=CAPACITY, device=dev)
    smk, sfr, srgba, vmin_safe = voxelize._sort_front(buf, CELL)

    def reduce_case(smk_, sfr_, srgba_, ocap):
        got = segment_reduce_sorted(smk_, sfr_, srgba_, ocap)
        want = segment_reduce_sorted_plain(smk_, sfr_, srgba_, ocap)
        torch.cuda.synchronize()
        check(same_bits(got[0], want[0]) and torch.equal(got[1], want[1]) and int(got[2]) == int(want[2]),
              f"kernel 1 differs from its plain version (n={smk_.shape[0]}, ocap={ocap})")
        return got, want

    def runs(count, nruns, cap, tiles=None):
        if count:
            lens = gen.multinomial(count, np.ones(nruns) / nruns)
            keys = np.repeat(np.sort(gen.choice(1 << 29, nruns, replace=False)).astype(np.int32), lens)
        else:
            keys = np.zeros(0, np.int32)
        k = np.full(cap, SENTINEL, np.int32)
        k[: len(keys)] = keys
        fr = gen.integers(0, 1 << 30, cap).astype(np.int32)
        rgba = gen.integers(-(2**31), 2**31, cap).astype(np.int32)
        if tiles is not None:
            rgba = ((rgba.view(np.uint32) & 0x00FFFFFF) | (np.uint32(tiles) << 24)).view(np.int32)
        return t(k), t(fr), t(rgba)

    def runs_of(lengths, cap):
        """Sorted keys with runs of the given lengths, then sentinels to cap."""
        keys = np.sort(gen.choice(1 << 29, len(lengths), replace=False)).astype(np.int32)
        k = np.full(cap, SENTINEL, np.int32)
        k[: sum(lengths)] = np.repeat(keys, lengths)
        return (t(k), t(gen.integers(0, 1 << 30, cap).astype(np.int32)),
                t(gen.integers(-(2**31), 2**31, cap).astype(np.int32)))

    (rows, key, nseg), (prows, _, _) = reduce_case(smk, sfr, srgba, OCAP)
    k1_err = float((rows - prows).abs().max())
    reduce_case(*runs(3000, 5, 4096), 2048)                 # runs longer than a 1024-point tile
    reduce_case(*runs(4096, 1, 4096, tiles=1), 256)         # one run of 4096 points, tile bit 0
    reduce_case(*runs(7000, 3, 8192, tiles=0x81), 256)      # runs over 2048 points, tile bits 0 and 7
    reduce_case(*runs(0, 1, 4096), 256)                     # count 0: no runs
    reduce_case(*runs(100, 7, 3000), 2048)                  # capacity not a multiple of the tile
    (_, _, n_over), _ = reduce_case(*runs(4000, 700, 4096), 256)  # runs past out_capacity dropped
    check(int(n_over) > 256, "kernel 1: nseg must count the runs past out_capacity")
    reduce_case(smk, sfr, srgba, EX_OCAP)                   # the exact chain's capacity
    reduce_case(*runs_of([1024, 1024, 2048, 512, 512, 3072], 8192), 4096)  # runs ending at tile edges
    reduce_case(*runs_of([1023, 5, 2043, 1, 3000], 8192), 4096)  # runs starting at a tile's last point
    # walks past a tile's end of exactly 32 points (one warp) and of 32 + a tile
    reduce_case(*runs_of([1024 + 32, 2048 - 32 - 1, 1 + 32 + 1024, 3], 6144), 4096)
    all_n = runs_of([CAPACITY], CAPACITY)                   # one run over all 1,048,576 slots
    (all_rows, _, all_nseg), _ = reduce_case(*all_n, 256)
    check(int(all_nseg) == 1 and int(all_rows[6, 0]) == CAPACITY, "kernel 1: one run over all n")
    all_ms = time_ms(lambda: segment_reduce_sorted(*all_n, 256), reps=5, warm=1)
    print(f"{card} phase 2: kernel 1 bit-equal to its plain version at n={smk.shape[0]}"
          f" (capacities {OCAP} and {EX_OCAP}) and 10 edge cases; one run over all {CAPACITY} slots"
          f" (walked by one block): {all_ms} ms")

    x, y, z, rgba, cnt = voxelize._reduce_runs_cm(rows, key, nseg, vmin_safe, CELL, OCAP)

    def knn_case(x_, y_, z_, cnt_, k, window):
        got = window_knn_mean_distance_cm(x_, y_, z_, cnt_, k, window)
        want = window_knn_mean_distance_plain(x_, y_, z_, cnt_, k, window)
        torch.cuda.synchronize()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-7),
              f"kernel 2 differs from its plain version (n={x_.shape[0]}, k={k}, window={window}):"
              f" max abs {float((got - want).abs().max())}")
        check(not got[int(cnt_):].any(), "kernel 2: md past count must be 0")
        return got, want

    md, pmd = knn_case(x, y, z, cnt, K, WINDOW)
    k2_err = float((md - pmd).abs().max())
    md32, pmd32 = knn_case(x, y, z, cnt, K, 32)  # the window method's default on the chain's voxels
    k2_err32 = float((md32 - pmd32).abs().max())
    cloud = np.sort(gen.random((4096, 3), dtype=np.float32), axis=0)
    cx, cy, cz = (t(cloud[:, a]) for a in range(3))

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    knn_case(cx, cy, cz, i32(4000), 30, 32)
    knn_case(cx, cy, cz, i32(100), 30, 16)
    knn_case(cx, cy, cz, i32(0), 30, 16)
    knn_case(cx[:3001], cy[:3001], cz[:3001], i32(2999), 5, 8)  # k far below 2W; ragged n
    knn_case(cx, cy, cz, i32(4096), 30, 1)                      # kk = 2
    dup = cloud.copy()
    dup[1::7] = dup[0::7][: len(dup[1::7])]  # duplicate points: ties at d2 = 0
    dup[2::7] = dup[0::7][: len(dup[2::7])]
    dx_, dy_, dz_ = (t(dup[:, a]) for a in range(3))
    pairs_kw = ((30, 16), (30, 32), (5, 8), (1, 1), (64, 32), (31, 16))  # both selection regimes
    k2_pair_err = max(maxabs(*knn_case(dx_, dy_, dz_, i32(cnt_), k_, w_))
                      for k_, w_ in pairs_kw for cnt_ in (4096, 100))
    print(f"{card} phase 2: kernel 2 allclose to its plain version at n={OCAP} (k {K}: window {WINDOW}, max abs"
          f" err {k2_err}; window 32, max abs err {k2_err32}), 5 edge cases and (k, window) {pairs_kw} on a"
          f" cloud with duplicate points (max abs err {k2_pair_err})")

    keep = chain.keep_mask(md, rgba, cnt, MULT, TILE)

    def compact_case(x_, y_, z_, rgba_, keep_, cnt_):
        got = compact_kernel_cm(x_, y_, z_, rgba_, keep_, cnt_)
        want = compact_plain_cm(x_, y_, z_, rgba_, keep_, cnt_)
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(got, want)),
              f"kernel 3 differs from its plain version (n={x_.shape[0]})")
        return got, want

    (kx, _, _, _, _), (px, _, _, _, _) = compact_case(x, y, z, rgba, keep, cnt)
    k3_err = float((kx - px).abs().max())
    odd = np.zeros((1024, 3), np.float32)
    odd[0] = [np.inf, -np.inf, np.nan]
    odd[1] = [-0.0, 1e-42, 3.4e38]
    odd[2] = [-np.nan, 0.0, -1e-45]
    ox, oy, oz = (t(odd[:, a]) for a in range(3))
    orgba = t(np.arange(1024, dtype=np.uint32).view(np.int32) | np.int32(-(2**24)))
    first4 = torch.arange(1024, device=dev) < 4
    (gx, gy, gz, _, gn), _ = compact_case(ox, oy, oz, orgba, first4, i32(1024))
    check(int(gn) == 4 and same_bits(torch.stack([gx, gy, gz], -1)[:3], t(odd[:3])),
          "kernel 3: inf/nan/-0/subnormal payload must pass bit for bit")
    rnd = t(gen.random(3001) < 0.4)
    rx, ry, rz = (t(gen.standard_normal(3001).astype(np.float32)) for _ in range(3))
    rr = t(gen.integers(-(2**31), 2**31, 3001).astype(np.int32))
    compact_case(rx, ry, rz, rr, rnd, i32(2500))                 # keep set past count; ragged n
    compact_case(rx, ry, rz, rr, torch.ones_like(rnd), i32(3001))  # all kept
    compact_case(rx, ry, rz, rr, rnd, i32(0))                    # count 0
    # kernel 4 on the planes of the exact chain's downsample (1<<18 rows)
    ex_x, ex_y, ex_z, ex_rgba, ex_cnt = voxelize.downsample_cm(buf, CELL, EX_OCAP)
    ex_xyz = torch.stack([ex_x, ex_y, ex_z], dim=-1)

    def planes_of(points, n, cell, gy, gz, cap):
        pts = np.zeros((max(1024, 1 << int(np.ceil(np.log2(max(n, 2))))), 3), np.float32)
        pts[:n] = points
        xs, ys, zs, _orig, _valid, _drop, _slot = cols_knn._cols_build(
            t(pts), i32(n), cell, gy=gy, gz=gz, cap=cap, chunk=CHUNK, want_orig=False)
        return xs, ys, zs

    ex_xs, ex_ys, ex_zs, _, ex_valid, drop_ring, point_slot = cols_knn._cols_build(
        ex_xyz, ex_cnt, CELL, gy=GY, gz=GZ, cap=GCAP, chunk=CHUNK, want_orig=False)
    ex_planes = (ex_xs, ex_ys, ex_zs)
    (sel, sel_kth), (psel, psel_kth), occ, cov = hold_select(ex_planes, CELL, "bench planes", K, GY, GZ, GCAP, True)
    k4_err = max(maxabs(sel[cov], psel[cov]), maxabs(sel_kth[cov], psel_kth[cov]))
    n_occ, n_cov = int(occ.sum()), int(cov.sum())
    check(n_occ == int(ex_cnt) == WANT_VOXELS, f"kernel 4: {n_occ} occupied slots, expected {WANT_VOXELS}")
    # edge cases
    cell = 0.02
    e_planes = planes_of(np.zeros((0, 3), np.float32), 0, cell, 24, 24, 12)
    hold_select(e_planes, cell, "count 0", 8, 24, 24, 12)
    vu = []  # voxel-unique columns of 1-8 points, one column at the full cap of 28
    for iy in range(3, 28):
        for iz in range(3, 20):
            nx = 28 if (iy, iz) == (12, 12) else int(gen.integers(1, 9))
            for ix in range(nx):
                vu.append((np.array([ix, iy, iz]) + gen.random(3) * 0.9) * cell)
    f_planes = planes_of(np.asarray(vu, np.float32), len(vu), cell, 32, 24, 28)
    check(int((f_planes[0] < F32_MAX / 2).sum(1).max()) == 28, "kernel 4: the full-cap column is missing")
    hold_select(f_planes, cell, "a column at full cap", 30, 32, 24, 28, True)
    few = np.array([[3, 3, 3], [3, 4, 3], [4, 3, 3], [3, 3, 4], [5, 5, 5], [4, 4, 4]], np.float32) * cell
    (_, few_kth), _, few_occ, _ = hold_select(planes_of(few, 6, cell, 16, 16, 8), cell, "fewer than k", 8, 16, 16, 8)
    check(int(few_occ.sum()) == 6 and bool((few_kth[few_occ] == F32_MAX).all()),
          "kernel 4: a query with fewer than k candidates must read kth F32_MAX (uncovered)")
    h = 1.0 / 64  # an exact lattice: ties of 6, 12 and 8 equal distances
    lat = np.stack(np.meshgrid(*(np.arange(a) for a in (8, 16, 16)), indexing="ij"), -1).reshape(-1, 3) * h
    _, _, _, tie_cov = hold_select(planes_of(lat.astype(np.float32), len(lat), 2 * h, 8, 8, 32),
                                   2 * h, "duplicate distances", 10, 8, 8, 32)
    check(int(tie_cov.sum()) > 1000, "kernel 4: the lattice case has too few covered queries")
    # dense columns of 60 points: strip unions of up to 144 * 60 candidates, staged in passes
    lat = np.stack(np.meshgrid(np.arange(60) * 0.5, np.arange(20), np.arange(20), indexing="ij"), -1).reshape(-1, 3)
    lat = ((lat + gen.random(lat.shape) * 0.2) * cell).astype(np.float32)
    d_planes = planes_of(lat, len(lat), cell, 32, 32, 64)
    d_occ = (d_planes[0] < F32_MAX / 2).sum(1)
    check(int(d_occ.max()) == 60 and UNION_COLS * 60 > select_plan(64).stage,
          "kernel 4: the dense case must fill columns of 60 and take passes")
    hold_select(d_planes, cell, "dense columns, staged in passes", K, 32, 32, 64)
    split = GY * GZ // 2 + 1  # not a multiple of anything the kernel uses
    a = cols_select(*ex_planes, k=K, gy=GY, gz=GZ, cap=GCAP, row0=0, nrows=split)
    b = cols_select(*ex_planes, k=K, gy=GY, gz=GZ, cap=GCAP, row0=split)
    torch.cuda.synchronize()
    check(same_bits(torch.cat([a[0], b[0]]), sel) and same_bits(torch.cat([a[1], b[1]]), sel_kth),
          "kernel 4: two row ranges concatenated differ from the full run")
    print(f"{card} phase 2: kernel 4 holds its contract against its plain version on the bench planes"
          f" ({n_occ} occupied slots, {n_cov} covered, max abs err {k4_err}) and 6 edge cases")

    # kernel 3 on the exact chain's rows (1<<18) and its exact keep masks
    md_c, unc = cols_knn._cols_finish(sel, sel_kth, point_slot, ex_valid, drop_ring, CELL,
                                      k=K, gy=GY, gz=GZ, cap=GCAP)
    check(int(unc.sum()) == WANT_RESID, f"{int(unc.sum())} uncovered points, expected {WANT_RESID}")
    md_fix = cols_knn.bruteforce_md_subset(ex_xyz, ex_cnt, unc, K)
    md_all = torch.where(unc, md_fix, md_c)
    for tile in (0, 1):
        compact_case(ex_x, ex_y, ex_z, ex_rgba, chain.keep_mask(md_all, ex_rgba, ex_cnt, MULT, tile), ex_cnt)
    print(f"{card} phase 2: kernel 3 bit-equal to its plain version at n={OCAP}, at n={EX_OCAP} with"
          f" the exact keep masks of tiles 0 and 1, and 4 edge cases")
    print(f"{card} phase 2 ok {lap()}")

    # ---- phase 3: the main path, once, through the public chain -----------
    kernels = (segment_reduce_sorted, window_knn_mean_distance_cm, compact_kernel_cm)
    torch.cuda.synchronize()
    for f in kernels:
        f.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = port.downsample_outliers_tilefilter(
            buf, CELL, k=K, mult=MULT, tile=TILE, window=WINDOW, out_capacity=OCAP
        )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in kernels}
    check(all(n >= 1 for n in launches.values()), f"a kernel of the main path was not launched: {launches}")

    n_vox = int(cnt)
    n_kept = int(out.count)
    check(n_vox == WANT_VOXELS, f"{n_vox} voxels, expected exactly {WANT_VOXELS}")
    check(abs(n_kept - WANT_KEPT) <= KEPT_BAND, f"{n_kept} kept points, expected {WANT_KEPT} +/- {KEPT_BAND}")
    check(out.xyz.shape == (OCAP, 3) and out.rgba.shape == (OCAP,), "output shape")
    check(bool(torch.isfinite(out.xyz).all()), "output coordinates must be finite")
    check(not out.xyz[n_kept:].any() and not out.rgba[n_kept:].any(), "output tail must be zero")
    check(bool((((out.rgba[:n_kept] >> 24) & 0xFF) == TILE).all()), "every kept point must be in the tile")

    # the same chain through the plain versions, on the card
    p_rows, p_key, p_nseg = segment_reduce_sorted_plain(smk, sfr, srgba, OCAP)
    pdown = voxelize._reduce_runs_cm(p_rows, p_key, p_nseg, vmin_safe, CELL, OCAP)
    check(all(same_bits(a, b) for a, b in zip(pdown, (x, y, z, rgba, cnt))),
          "the voxel sets of the kernel and plain chains differ")
    p_md = window_knn_mean_distance_plain(*pdown[:3], pdown[4], K, WINDOW)
    valid = torch.arange(OCAP, device=dev) < cnt
    n_f = valid.sum(dtype=torch.float32)
    thr = float(outliers._threshold(MULT, n_f, p_md.sum(), (p_md * p_md).sum()))
    p_keep = chain.keep_mask(p_md, rgba, cnt, MULT, TILE)
    flips = p_keep != keep
    n_flips = int(flips.sum())
    near = (p_md[flips].double() - thr).abs() <= 1e-5 * thr
    check(bool(near.all()), f"{n_flips} keep flips, not all within 1e-5 * thr of the threshold")
    p_out = compaction.compact_cm(*pdown[:4], p_keep, cnt)
    if n_flips == 0:
        check(int(p_out.count) == n_kept and same_bits(p_out.xyz, out.xyz) and torch.equal(p_out.rgba, out.rgba),
              "the kernel chain's output differs from the plain chain's")
    else:
        check(abs(int(p_out.count) - n_kept) <= n_flips, "kept counts differ by more than the flips")
    print(f"{card} phase 3 ok {lap()}: {n_vox} voxels, {n_kept} kept (plain chain {int(p_out.count)},"
          f" {n_flips} keep flips near the threshold), launches {launches}, no host sync")

    # ---- phase 4: times ----------------------------------------------------
    def run_chain():
        return port.downsample_outliers_tilefilter(
            buf, CELL, k=K, mult=MULT, tile=TILE, window=WINDOW, out_capacity=OCAP
        )

    chain_ms = time_ms(run_chain)
    pts_per_s = HSTEPS * HSTEPS / (chain_ms / 1e3)
    print(f"{card} chain: median {chain_ms} ms over {REPS} warm runs, {pts_per_s} points/s")

    stages = {
        "front+sort": lambda: voxelize._sort_front(buf, CELL),
        "kernel 1 (segment_reduce)": lambda: segment_reduce_sorted(smk, sfr, srgba, OCAP),
        "centroids": lambda: voxelize._reduce_runs_cm(rows, key, nseg, vmin_safe, CELL, OCAP),
        "kernel 2 (window_knn)": lambda: window_knn_mean_distance_cm(x, y, z, cnt, K, WINDOW),
        "keep": lambda: chain.keep_mask(md, rgba, cnt, MULT, TILE),
        "kernel 3 (compact) + stack": lambda: compaction.compact_cm(x, y, z, rgba, keep, cnt),
    }
    stage_ms = {name: time_ms(fn) for name, fn in stages.items()}
    for name, ms in stage_ms.items():
        print(f"{card} stage {name}: median {ms} ms")

    # bounds from this run's inputs, counting only the bytes the function
    # needs: kernel 1 reads every key of the sorted stream (a sentinel marks
    # its end) but the fracs and colours of the valid points only, and
    # writes [8, ocap] rows, keys and the run count (~8 integer adds a
    # point); kernel 2 reads the valid points' coordinates, writes md in
    # full, and computes 2W d2 (8 flops each), k square roots and k adds a
    # valid point; kernel 3 reads the keep flags below the count and the
    # four words of each kept point, and writes four words a slot and the
    # kept count
    n_valid = int(cnt)
    n_sorted = int((smk != SENTINEL).sum())
    n_kept3 = int(keep[:n_valid].sum())
    packed = torch.stack([x.view(torch.int32), y.view(torch.int32), z.view(torch.int32), rgba], dim=-1)
    bounds = [
        bound(tensor_bytes(smk, rows, key, nseg) + 8 * n_sorted, 8 * n_sorted),
        bound(12 * n_valid + tensor_bytes(cnt, md), n_valid * (2 * WINDOW * 8 + 2 * K)),
        bound(n_valid + tensor_bytes(cnt) + 16 * n_kept3 + 4 * tensor_bytes(x) + 4, 0),
    ]
    print(f"{card} bound inputs: kernel 1 {smk.shape[0]} keys, {n_sorted} valid; kernel 2 {n_valid} valid"
          f" of {x.shape[0]} slots; kernel 3 {n_kept3} kept of {n_valid} below the count")
    libs = [None, None, lambda: packed[keep]]  # kernel 3: boolean-mask indexing of the [n, 4] rows
    pairs = [
        ("segment_reduce", "segment_reduce.cu", "pallas_segment_reduce.py:278", k1_err,
         lambda: segment_reduce_sorted(smk, sfr, srgba, OCAP),
         lambda: segment_reduce_sorted_plain(smk, sfr, srgba, OCAP)),
        ("window_knn", "window_knn.cu", "pallas_window_knn.py:203", k2_err,
         lambda: window_knn_mean_distance_cm(x, y, z, cnt, K, WINDOW),
         lambda: window_knn_mean_distance_plain(x, y, z, cnt, K, WINDOW)),
        ("compact", "compact.cu", "pallas_compact.py:192", k3_err,
         lambda: compact_kernel_cm(x, y, z, rgba, keep, cnt),
         lambda: compact_plain_cm(x, y, z, rgba, keep, cnt)),
    ]
    record = []
    for (name, src, tpu, err, kfn, pfn), f, (bms, bby), lib in zip(pairs, kernels, bounds, libs):
        kms, pms, lms, runs = in_turns(kfn, pfn, lib)
        order = "plain, call, kernel, kernel, call, plain" if lib else "plain, kernel, kernel, plain"
        print(f"{card} kernel {name}: {kms} ms; plain PyTorch {pms} ms; bound {bms} ms ({bby}); one PyTorch"
              f" call {lms} ms; in turns ({order}) {runs}")
        record.append({
            "name": name, "route": "cuda", "source": f"cwipc_util_tpu_torch/csrc/{src}",
            "replaces": f"cwipc_util_tpu/ops/{tpu}", "launches": launches[f.__name__],
            "max_abs_err": err, "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": bby,
            "library_ms": lms,
        })
    # kernel 2 at the window method's default (k 30, window 32): off the
    # chain, so not in the kernels line
    kms, pms, _, runs32 = in_turns(lambda: window_knn_mean_distance_cm(x, y, z, cnt, K, 32),
                                   lambda: window_knn_mean_distance_plain(x, y, z, cnt, K, 32))
    bms32, bby32 = bound(12 * n_valid + tensor_bytes(cnt, md), n_valid * (2 * 32 * 8 + 2 * K))
    print(f"{card} kernel window_knn at k {K}, window 32: {kms} ms; plain PyTorch {pms} ms; bound {bms32} ms"
          f" ({bby32}); in turns (plain, kernel, kernel, plain) {runs32}")
    print(f"{card} phase 4 ok {lap()}")

    # ---- phase 5: the exact chain, once, through the public function ------
    from scipy.spatial import cKDTree

    def exact(tile):
        return port.downsample_outliers_tilefilter_exact(
            buf, CELL, K, MULT, tile, EX_OCAP, GY, GZ, GCAP, chunk=CHUNK, cell_normal=True
        )

    all_kernels = kernels + (cols_select,)
    torch.cuda.synchronize()
    for f in all_kernels:
        f.launches = 0
    ex_out, ex_resid = exact(0)
    torch.cuda.synchronize()
    ex_launches = {f.__name__: f.launches for f in all_kernels}
    on_path = ("segment_reduce_sorted", "cols_select", "compact_kernel_cm")
    check(all(ex_launches[name] >= 1 for name in on_path),
          f"a kernel of the exact path was not launched: {ex_launches}")
    n_vox = int(ex_cnt)
    check(n_vox == WANT_VOXELS, f"exact chain: {n_vox} voxels, expected exactly {WANT_VOXELS}")
    ex_rows = ex_xyz[:n_vox].cpu().numpy()
    md64, thr64 = oracle(ex_rows.astype(np.float64))
    tiles = ((ex_rgba[:n_vox].cpu().numpy().view(np.uint32) >> 24) & 0xFF)
    ex_kept, ex_flips, resids = {}, {}, {}
    for tile in (0, 1):
        out_t, resid_t = (ex_out, ex_resid) if tile == 0 else exact(tile)
        want = (md64 <= thr64) & ((tiles == tile) | (tile == 0))
        n_want = int(want.sum())
        check(abs(n_want - WANT_EX_KEPT[tile]) <= 1,
              f"the oracle keeps {n_want} at tile {tile}, expected {WANT_EX_KEPT[tile]} +/- 1")
        m = int(out_t.count)
        check(abs(m - WANT_EX_KEPT[tile]) <= 1, f"exact chain keeps {m} at tile {tile},"
              f" expected {WANT_EX_KEPT[tile]} +/- 1 (the oracle: {n_want})")
        check(out_t.xyz.shape == (EX_OCAP, 3) and bool(torch.isfinite(out_t.xyz).all())
              and not out_t.xyz[m:].any() and not out_t.rgba[m:].any(), "exact chain: output shape or tail")
        what = f"exact chain, tile {tile}"
        got_rows = out_t.xyz[:m].cpu().numpy()
        mask = kept_mask(got_rows, ex_rows, what)
        check(np.array_equal(got_rows.view(np.int32), ex_rows[mask].view(np.int32)),
              f"{what}: kept rows are not in the input's order")
        ex_flips[tile] = near_flips(mask, want, md64, thr64, what)
        resids[tile] = int(resid_t)
        check(resids[tile] == WANT_RESID, f"exact chain: {resids[tile]} uncovered points, expected {WANT_RESID}")
        ex_kept[tile] = (m, n_want, out_t)
    fast_set = {r.tobytes() for r in out.xyz[:int(out.count)].cpu().numpy()}
    exact_set = {r.tobytes() for r in ex_kept[1][2].xyz[:ex_kept[1][0]].cpu().numpy()}
    agree = 100.0 * (n_vox - len(fast_set ^ exact_set)) / n_vox
    check(abs(agree - WANT_AGREE) <= 0.01,
          f"voxel-set agreement of the fast and exact chains {agree} %, expected {WANT_AGREE} +/- 0.01")
    print(f"{card} phase 5 ok {lap()}: exact chain {n_vox} voxels; kept {ex_kept[0][0]} at tile 0 (oracle"
          f" {ex_kept[0][1]}, {ex_flips[0]} flips near the threshold), {ex_kept[1][0]} at tile 1 (oracle"
          f" {ex_kept[1][1]}, {ex_flips[1]} flips); {resids[0]} uncovered fixed up; agreement with the"
          f" fast chain {agree} %; launches {ex_launches}")

    # ---- phase 6: the public cwipc_remove_outliers --------------------------
    src = port.cwipc_synthetic(0, 40000, device=dev)
    src.start()
    pc = src.get()
    src.stop()
    down = port.cwipc_downsample(pc, 0.008)
    arr = down.get_numpy_array()
    check(len(arr) > 4096, f"the public op's cloud has {len(arr)} points: not the column route")
    def recording(xyz_, count_, cell_, k_, **kw):
        grids.append((xyz_, count_, cell_, k_, kw))
        return cols_knn.cols_knn_mean_distance(xyz_, count_, cell_, k_, **kw)

    for per_tile in (False, True):
        grids = []
        port_ops.cols_knn_mean_distance = recording
        cols_select.launches = 0
        try:
            clean = port.cwipc_remove_outliers(down, K, MULT, per_tile)
            torch.cuda.synchronize()
        finally:
            port_ops.cols_knn_mean_distance = cols_knn.cols_knn_mean_distance
        op_launches = cols_select.launches
        check(op_launches >= 1, f"cwipc_remove_outliers (perTile={per_tile}) did not launch kernel 4")
        got = clean.get_numpy_array()
        if per_tile:
            t_all = arr["tile"]
            _, first = np.unique(t_all, return_index=True)
            parts = [arr if t == 0 else arr[t_all == t] for t in t_all[np.sort(first)]]
        else:
            parts = [arr]
        what = f"cwipc_remove_outliers(perTile={per_tile})"
        got_keys = {r.tobytes() for r in got}
        check(len(got_keys) == len(got), f"{what}: duplicate points")
        n_flips, n_want, survivors = 0, 0, []
        for part in parts:
            md_p, thr_p = oracle(np.stack([part["x"], part["y"], part["z"]], -1).astype(np.float64))
            want = md_p <= thr_p
            mask = np.array([r.tobytes() in got_keys for r in part], bool)
            n_flips += near_flips(mask, want, md_p, thr_p, what)
            n_want += int(want.sum())
            survivors.append(part[mask])
        # each part's survivors in order, the parts in order of first appearance
        check(np.array_equal(got, np.concatenate(survivors)), f"{what}: points out of order")
        check(clean.timestamp() == down.timestamp() and clean.cellsize() == down.cellsize(),
              "cwipc_remove_outliers: timestamp or cellsize changed")
        # kernel 4 against its plain version on the grids the op built
        check(len(grids) == op_launches, f"{what}: {len(grids)} column grids, {op_launches} launches")
        for xyz_, count_, cell_, k_, kw in grids:
            g_xs, g_ys, g_zs, _orig, _valid, _drop, _slot = cols_knn._cols_build(
                xyz_, count_, cell_, gy=kw["gy"], gz=kw["gz"], cap=kw["cap"], chunk=CHUNK,
                vmin_override=kw["vmin_override"], want_orig=False)
            g_planes = (g_xs, g_ys, g_zs)
            hold_select(g_planes, cell_, f"{what}, grid {kw['gy']} x {kw['gz']} x {kw['cap']}", k_,
                        kw["gy"], kw["gz"], kw["cap"])
        print(f"{card} phase 6: cwipc_remove_outliers(perTile={per_tile}) on {len(arr)} points kept"
              f" {len(got)} (oracle {n_want}, {n_flips} flips near the threshold), kernel 4 launched"
              f" {op_launches} times and held to its plain version on grids"
              f" {[(kw['gy'], kw['gz'], kw['cap']) for *_, kw in grids]}")
        clean.free()
    for p_ in (pc, down):
        p_.free()
    # a merged capture's stacked points: a wall with 200 copies of one of its
    # points, whose grid takes a cap over 160; sampled as a camera's pixels
    # (the grid covers most queries) and uniformly (the brute-force fixup
    # takes most of them)
    for sampling in ("camera", "uniform"):
        wall = wall_with_copies(sampling)
        grids = []
        port_ops.cols_knn_mean_distance = recording
        cols_select.launches = 0
        try:
            wpc = port.cwipc_from_numpy_matrix(wall, 0, device=dev)
            clean = port.cwipc_remove_outliers(wpc, K, MULT, False)
            torch.cuda.synchronize()
        finally:
            port_ops.cols_knn_mean_distance = cols_knn.cols_knn_mean_distance
        what = f"cwipc_remove_outliers on the {sampling}-sampled wall with copies"
        check(len(grids) == 1 == cols_select.launches, f"{what}: {len(grids)} column grids,"
              f" {cols_select.launches} launches of kernel 4")
        xyz_, count_, cell_, k_, kw = grids[0]
        check(kw["cap"] > 160, f"{what}: the grid's cap is {kw['cap']}, not over 160")
        rows = wpc.get_numpy_array()
        got = clean.get_numpy_array()
        mask = subsequence_mask(got, rows, what)
        md_w, thr_w = oracle(wall[:, :3].astype(np.float64))
        w_flips = near_flips(mask, md_w <= thr_w, md_w, thr_w, what)
        g_planes = cols_knn._cols_build(xyz_, count_, cell_, gy=kw["gy"], gz=kw["gz"], cap=kw["cap"],
                                        chunk=CHUNK, vmin_override=kw["vmin_override"], want_orig=False)[:3]
        _, _, w_occ, w_cov = hold_select(g_planes, cell_, f"{what}, grid {kw['gy']} x {kw['gz']} x {kw['cap']}",
                                         k_, kw["gy"], kw["gz"], kw["cap"], chunk=8)
        print(f"{card} phase 6: {what}: {len(rows)} points, grid {kw['gy']} x {kw['gz']} columns of cap"
              f" {kw['cap']} (cell {cell_}), {int(w_cov.sum())} of {int(w_occ.sum())} queries covered; kept"
              f" {len(got)} (oracle {int((md_w <= thr_w).sum())}, {w_flips} flips near the threshold); kernel 4"
              f" held to its plain version on the grid")
        for p_ in (wpc, clean):
            p_.free()
    print(f"{card} phase 6 ok {lap()}")

    # ---- phase 7: times of the exact chain and of kernel 4 ----------------
    ex_ms = time_ms(lambda: exact(0), reps=10, warm=2)
    print(f"{card} exact chain: median {ex_ms} ms over 10 warm runs,"
          f" {HSTEPS * HSTEPS / (ex_ms / 1e3)} points/s")
    ex_stages = {
        "downsample": lambda: voxelize.downsample_cm(buf, CELL, EX_OCAP),
        "build": lambda: cols_knn._cols_build(ex_xyz, ex_cnt, CELL, gy=GY, gz=GZ, cap=GCAP, chunk=CHUNK,
                                              want_orig=False),
        "select (kernel 4)": lambda: cols_select(*ex_planes, k=K, gy=GY, gz=GZ, cap=GCAP),
        "finish": lambda: cols_knn._cols_finish(sel, sel_kth, point_slot, ex_valid, drop_ring, CELL,
                                                k=K, gy=GY, gz=GZ, cap=GCAP),
        "fixup (brute force, 112 points)": lambda: cols_knn.bruteforce_md_subset(ex_xyz, ex_cnt, unc, K),
        "keep + compact": lambda: compaction.compact_cm(
            ex_x, ex_y, ex_z, ex_rgba, chain.keep_mask(md_all, ex_rgba, ex_cnt, MULT, 0), ex_cnt),
    }
    for name, fn in ex_stages.items():
        print(f"{card} exact stage {name}: median {time_ms(fn, reps=10, warm=2)} ms")

    def k4_kernel():
        return cols_select(*ex_planes, k=K, gy=GY, gz=GZ, cap=GCAP)

    def k4_plain():
        return cols_select_plain(*ex_planes, k=K, gy=GY, gz=GZ, cap=GCAP, chunk=CHUNK, voxel_unique=True)

    kms, pms, _, k4_runs = in_turns(k4_kernel, k4_plain, plain_reps=3, plain_warm=1)
    from cwipc_util_tpu_torch.ops.nn_select import (
        INT32_MAX,
        nn_select,
        nn_select_plain,
        ring_offsets,
    )

    def ring_pairs(q_x, r_x, gz, gyz):
        """(query slot, candidate slot) pairs the 77-column ring holds in
        this run's planes: the work a ring kernel must do."""
        off = 4 * gz + 4
        occ_q = (q_x[off:off + gyz] < F32_MAX / 2).sum(1).double()
        occ_r = (r_x < F32_MAX / 2).sum(1).double()
        ring = sum(occ_r[off + o:off + o + gyz] for o in ring_offsets(gz))
        return float((occ_q * ring).sum())

    def ring_bytes(planes_r, planes_q, gz, gyz, outs):
        """Bytes a ring kernel must move in this run: the reference x plane
        over the rows the rings reach (x alone marks a slot occupied: an
        empty slot holds F32_MAX), y and z of its occupied slots only; the
        query x plane over the grid's rows and y and z of its occupied
        slots (planes_q None: the reference is its own query); the outputs
        once."""
        off = 4 * gz + 4
        r_x = planes_r[0][:gyz + 2 * off]
        nbytes = tensor_bytes(r_x, *outs) + 8 * int((r_x < F32_MAX / 2).sum())
        if planes_q is not None:
            q_x = planes_q[0][off:off + gyz]
            nbytes += tensor_bytes(q_x) + 8 * int((q_x < F32_MAX / 2).sum())
        return nbytes

    # kernel 4: 8 flops of d2 per (query, candidate) pair of the ring
    k4_pairs = ring_pairs(ex_planes[0], ex_planes[0], GZ, GY * GZ)
    k4_bytes = ring_bytes(ex_planes, None, GZ, GY * GZ, (sel, sel_kth))
    k4_bms, k4_bby = bound(k4_bytes, 8 * k4_pairs)
    print(f"{card} kernel cols_select: {kms} ms; plain PyTorch {pms} ms; in turns (plain, kernel, kernel, plain)"
          f" {k4_runs}; bound {k4_bms} ms ({k4_bby}: {k4_bytes} bytes, {k4_pairs} ring pairs); no one PyTorch call"
          f" computes it")
    # kernel 4's phase profile (clock64 spans of each block, summed over the
    # blocks) beside the column-per-block design it replaced, on the same planes
    from cwipc_util_tpu_torch.ops import cols_select_probe
    from cwipc_util_tpu_torch.ops.cols_select import PROF_FIELDS, PROF_WORDS

    prof = torch.zeros(PROF_WORDS, dtype=torch.int64, device=dev)
    cols_select(*ex_planes, k=K, gy=GY, gz=GZ, cap=GCAP, prof=prof)
    col_prof = torch.zeros(len(cols_select_probe.PROF_FIELDS), dtype=torch.int64, device=dev)

    def k4_column(prof_=col_prof):
        return cols_select_probe.column_probe(*ex_planes, k=K, gy=GY, gz=GZ, cap=GCAP, prof=prof_)

    col = k4_column()
    torch.cuda.synchronize()
    cut = r_cut(CELL)
    check(torch.equal((col[1] < cut)[occ], (psel_kth < cut)[occ]) and same_bits(col[1][cov], psel_kth[cov])
          and torch.allclose(col[0][cov], psel[cov], rtol=1e-5, atol=1e-5),
          "the column-per-block probe does not hold kernel 4's contract on the bench planes")
    for name, p_, fields in (("kernel 4 (strip)", prof, PROF_FIELDS),
                             ("the column-per-block probe", col_prof, cols_select_probe.PROF_FIELDS)):
        cyc = dict(zip(fields, p_.tolist()))
        spans = [f for f in fields if f.endswith("cycles")]
        total = sum(cyc[f] for f in spans)
        print(f"{card} {name} phase profile on the bench planes: {cyc}; shares of the block cycles"
              f" {({f: cyc[f] / total for f in spans})}; {total / cyc['blocks']} cycles a block")
    k4_scans = prof[5].item() / prof[6].item()
    print(f"{card} kernel 4 (strip): {k4_scans} scans a query over {prof[6].item()}"
          f" queries; {prof[7].item()} of {prof[4].item()} blocks staged in passes")
    scratch_prof = torch.zeros_like(col_prof)
    s_ms, c_ms, _, sc_runs = in_turns(k4_kernel, lambda: k4_column(scratch_prof), plain_reps=REPS)
    print(f"{card} kernel 4 (strip) {s_ms} ms against the column-per-block probe {c_ms} ms on the bench planes;"
          f" in turns (probe, strip, strip, probe) {sc_runs}")
    record.append({
        "name": "cols_select", "route": "cuda", "source": "cwipc_util_tpu_torch/csrc/cols_select.cu",
        "replaces": "cwipc_util_tpu/ops/pallas_cols_select.py:502", "launches": ex_launches["cols_select"],
        "max_abs_err": k4_err, "ms": kms, "plain_ms": pms, "bound_ms": k4_bms, "bound_by": k4_bby,
        "library_ms": None,
    })
    print(f"{card} phase 7 ok {lap()}")

    # ---- phase 8: kernel 5 against its plain version at edge cases --------
    from cwipc_util_tpu_torch.filters.noise import NoiseFilter
    from cwipc_util_tpu_torch.filters.simulatecams import SimulatecamsFilter
    from cwipc_util_tpu_torch.ops import knn
    from cwipc_util_tpu_torch.registration import analyze, fine, multicamera
    from cwipc_util_tpu_torch.registration.util import cwipc_transform, transformation_compare

    k5_err = [0.0]

    def nn_case(planes_r, planes_q, gy, gz, cap_r, cap_q, what):
        """Kernel 5 and its plain version on the same planes: d2 bit-equal,
        ids equal, empty query slots at (F32_MAX, INT32_MAX)."""
        got = nn_select(*planes_r, *planes_q, gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q)
        want = nn_select_plain(*planes_r, *planes_q, gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q)
        torch.cuda.synchronize()
        check(same_bits(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"kernel 5 ({what}): differs from its plain version: {int((got[1] != want[1]).sum())} ids,"
              f" max abs d2 {maxabs(got[0], want[0])}")
        off = 4 * gz + 4
        empty = planes_q[0][off:off + gy * gz] >= F32_MAX / 2
        check(bool((got[0][empty] == F32_MAX).all()) and bool((got[1][empty] == INT32_MAX).all()),
              f"kernel 5 ({what}): empty query slots must read (F32_MAX, INT32_MAX)")
        k5_err[0] = max(k5_err[0], maxabs(got[0], want[0]))
        return got, empty

    def grid_planes(points, cell, gy, gz, cap):
        n = len(points)
        pts = np.zeros((max(1024, 1 << int(np.ceil(np.log2(max(n, 2))))), 3), np.float32)
        pts[:n] = points
        xs, ys, zs, _orig, _valid, _drop, _slot = cols_knn._cols_build(
            t(pts), i32(n), cell, gy=gy, gz=gz, cap=cap, chunk=CHUNK, vmin_override=[0, 0, 0],
            want_orig=False)
        return xs, ys, zs

    def box(n, lo, hi):
        return (np.float32(lo) + gen.random((n, 3), dtype=np.float32) * np.float32(np.subtract(hi, lo))).astype(
            np.float32)

    cell = 0.02
    cases = {
        "count 0": (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32), 24, 24, 16, 8),
        "fewer reference points than a ring holds": (box(5, 0.1, 0.2), box(300, 0.0, 0.4), 24, 24, 8, 16),
        "columns at cap 128, rings past one stage": (box(8000, 0.05, [0.35, 0.17, 0.17]),
                                                     box(3000, 0.05, [0.35, 0.17, 0.17]), 16, 16, 128, 128),
        "cap_r 13, cap_q 5": (box(900, 0.05, 0.4), box(700, 0.05, 0.4), 32, 32, 13, 5),
        "queries with empty rings": (box(400, 0.0, [0.5, 0.1, 0.1]), box(400, [0.0, 0.3, 0.3], 0.5), 32, 32, 16, 16),
        "a dropped column": (np.concatenate([box(300, 0.05, 0.3), np.float32([0.1, 0.101, 0.101])
                                             + box(200, 0.0, [0.3, 0.005, 0.005])]),
                             box(500, 0.05, 0.3), 24, 24, 24, 24),
    }
    h = cell / 2  # an exact lattice and queries at cell centres: ties of 8
    lat = np.stack(np.meshgrid(*(np.arange(1, 13),) * 3, indexing="ij"), -1).reshape(-1, 3) * h
    cases["an exact lattice with tied distances"] = (lat.astype(np.float32), (lat[:800] + h / 2).astype(np.float32),
                                                     16, 16, 24, 24)
    for what, (r_pts, q_pts, gy_, gz_, cap_r, cap_q) in cases.items():
        (_, cid_), empty = nn_case(grid_planes(r_pts, cell, gy_, gz_, cap_r), grid_planes(q_pts, cell, gy_, gz_, cap_q),
                                   gy_, gz_, cap_r, cap_q, what)
        n_hit = int((cid_ != INT32_MAX).sum())
        if what == "queries with empty rings":
            check(n_hit == 0 and int((~empty).sum()) > 0, "kernel 5: rings out of reach must find nothing")
        if what == "an exact lattice with tied distances":
            check(n_hit == 800, "kernel 5: every lattice query must find a neighbour")
        print(f"{card} phase 8: kernel 5 equal to its plain version, {what}: {int((~empty).sum())} queries,"
              f" {n_hit} with a candidate")
    print(f"{card} phase 8 ok {lap()}")

    # ---- phase 9: multi-camera registration, the 3-camera 30k flow ----------
    def tiled_scene():
        body = port.cwipc_synthetic(0, REG_N, device=dev)
        body.start()
        pc = body.get()
        body.stop()
        pc = SimulatecamsFilter(3, hard=False, seed=REG_SEED).filter(pc)
        pc = NoiseFilter(REG_NOISE, seed=REG_SEED + 1).filter(pc)
        parts = [cwipc_transform(port.cwipc_tilefilter(pc, 1 << cam),
                                 perturbation(REG_SEED + cam, REG_TRANSLATION, REG_ROTATION)) for cam in range(3)]
        return port.cwipc_join_multi(parts)

    def modes(pc):
        """The register script's check_alignment: each camera's tile against
        all the other tiles, mode correspondence."""
        out = []
        for cam in range(3):
            an = analyze.RegistrationAnalyzerSymmetric()
            an.set_source_pointcloud(pc, 1 << cam)
            an.set_reference_pointcloud(pc, 255 - (1 << cam))
            an.set_correspondence_measure("mode")
            an.run()
            out.append(an.get_results().minCorrespondence)
        return out

    # record, without changing them: every reference/query grid pair kernel 5
    # sees, every compaction kernel 3 does, the aligners' ICP runs and their
    # grid choices
    nn_grids, compactions = [], []
    real_select, real_icp, real_params = knn.nn_select, fine._icp_fused, fine.nn_grid_params
    real_compact = compaction.compact_kernel_cm

    def recording_select(*planes, **kw):
        nn_grids.append((planes, kw))
        return real_select(*planes, **kw)

    def recording_compact(*args):
        compactions.append(args)
        return real_compact(*args)

    icp_runs, grid_choices = [], []

    def recording_icp(*args, **kw):
        torch.cuda.synchronize()
        n0, t_0 = nn_select.launches, time.perf_counter()
        T = real_icp(*args, **kw)
        torch.cuda.synchronize()
        icp_runs.append({"args": args, "kw": kw, "s": time.perf_counter() - t_0,
                         "launches": nn_select.launches - n0})
        return T

    def recording_params(src_np, ref_np, maxd, **kw):
        g = real_params(src_np, ref_np, maxd, **kw)
        grid_choices.append((len(src_np), len(ref_np), maxd, g))
        return g

    def recording(on):
        knn.nn_select = recording_select if on else real_select
        fine._icp_fused = recording_icp if on else real_icp
        fine.nn_grid_params = recording_params if on else real_params
        compaction.compact_kernel_cm = recording_compact if on else real_compact

    scene = tiled_scene()
    n_scene = scene.count()
    torch.cuda.synchronize()
    t_0 = time.perf_counter()
    before = modes(scene)
    check_s = {"alignment analysis before": time.perf_counter() - t_0}
    algo = multicamera.MultiCameraIterative()
    algo.set_tiled_pointcloud(scene)
    flow_stages = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t_0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            flow_stages[name] = flow_stages.get(name, 0.0) + time.perf_counter() - t_0
            return out
        return run

    algo._pre_analyse = timed("pre-analysis", algo._pre_analyse)
    algo._post_analyse = timed("post-analysis", algo._post_analyse)
    reg_kernels = all_kernels + (nn_select,)
    recording(True)
    torch.cuda.synchronize()
    for f in reg_kernels:
        f.launches = 0
    t_flow = time.perf_counter()
    try:
        ok = algo.run()
        torch.cuda.synchronize()
    finally:
        recording(False)
    flow_s = time.perf_counter() - t_flow
    reg_launches = {f.__name__: f.launches for f in reg_kernels}
    flow_stages["iterative fine alignment"] = flow_s - sum(flow_stages.values())
    check(ok, "MultiCameraIterative.run() failed")
    check(reg_launches["nn_select"] >= 1 and reg_launches["compact_kernel_cm"] >= 1,
          f"a kernel of the registration path was not launched: {reg_launches}")
    check(icp_runs and all(r["launches"] >= 1 for r in icp_runs),
          f"kernel 5 must run in every aligner run: {[r['launches'] for r in icp_runs]}")
    two_scale = [g[:3] for g in grid_choices if g[3] is None]
    if two_scale:
        print(f"{card} phase 9: aligner runs on the two-scale search (no grid fits): {two_scale}")
    t_0 = time.perf_counter()
    after_pc = algo.get_result_pointcloud_full()
    after = modes(after_pc)
    torch.cuda.synchronize()
    check_s["alignment analysis after"] = time.perf_counter() - t_0
    check(after_pc.count() == n_scene, "the registered cloud lost points")
    check(max(after) < 0.006 and max(after) < max(before) / 3,
          f"registration did not reach the noise floor: worst mode correspondence {max(before)} -> {max(after)}")
    flow_grids = list(nn_grids)
    flow_compactions = list(compactions)
    check(len(flow_compactions) == reg_launches["compact_kernel_cm"],
          f"{len(flow_compactions)} compactions recorded, {reg_launches['compact_kernel_cm']} launches")
    flow_icp = list(icp_runs)
    print(f"{card} phase 9: MultiCameraIterative on {n_scene} points in {flow_s} s"
          f" (stages {flow_stages}); mode correspondence per camera {before} -> {after}; report:"
          f" {algo.report_change()!r}; launches {reg_launches}; aligner runs"
          f" {[(r['kw']['grid'], r['launches'], r['s']) for r in icp_runs]}; two-scale aligner runs {len(two_scale)}")

    def oracle_nn(src_xyz, sn, ref_xyz, rn, maxd, what):
        """The grid NN (nn_search_host_auto on CUDA) against a float64
        cKDTree: no correspondence exactly where the oracle's nearest lies
        beyond maxd (but within 1e-6 * maxd of it), distances within 1e-6
        relative, an index at that distance.  Then the two-scale search on
        the same pair: every match it reports is genuine and no nearer
        than the oracle's; how many it misses is printed."""
        n0 = nn_select.launches
        d, i = knn.nn_search_host_auto(src_xyz, sn, ref_xyz, rn, maxd)
        torch.cuda.synchronize()
        check(nn_select.launches > n0, f"{what}: the grid NN did not launch kernel 5")
        s64 = src_xyz[:sn].double().cpu().numpy()
        r64 = ref_xyz[:rn].double().cpu().numpy()
        d64, _ = cKDTree(r64).query(s64, workers=-1)
        maxd32 = float(np.float32(maxd))
        near = np.abs(d64 - maxd32) <= 1e-6 * maxd32
        for name, (dd, ii) in (("grid", (d, i)), ("two-scale", knn.nn_search(src_xyz, sn, ref_xyz, rn, maxd))):
            dd, ii = dd[:sn].cpu().numpy().astype(np.float64), ii[:sn].cpu().numpy()
            hit = np.isfinite(dd)
            named = np.sqrt(((r64[np.maximum(ii, 0)] - s64) ** 2).sum(1))
            check(np.all(~hit | (np.abs(named - dd) <= 1e-6 * np.maximum(named, 1e-30))),
                  f"{what}, {name}: a match is not at the distance it reports")
            exact = hit & (np.abs(dd - d64) <= 1e-6 * np.maximum(d64, 1e-30))
            if name == "grid":
                check(np.all((hit == (d64 <= maxd32)) | near), f"{what}: the grid NN's hit set differs from the oracle's")
                check(np.all(exact | ~hit), f"{what}: grid distances differ from the oracle's by more than 1e-6")
            else:
                check(np.all(~hit | (dd >= d64 * (1 - 1e-6))), f"{what}: two-scale is nearer than the oracle")
            print(f"{card} NN oracle, {what}, {name}: {sn} queries, {int(hit.sum())} matches"
                  f" (oracle {int((d64 <= maxd32).sum())}), {int(exact.sum())} exact")

    for r in icp_runs:
        src0, s_count, ref_xyz, r_count, corr = r["args"][:5]
        oracle_nn(src0, int(s_count), ref_xyz, int(r_count), corr, f"aligner pair {int(s_count)} -> {int(r_count)}")
    for planes, kw in flow_grids:
        nn_case(planes[:3], planes[3:], kw["gy"], kw["gz"], kw["cap_r"], kw["cap_q"], f"flow grid {kw}")
    for args in flow_compactions:
        compact_case(*args)
    print(f"{card} phase 9 ok {lap()}: kernel 5 equal to its plain version on all {len(flow_grids)}"
          f" reference/query grid pairs of the flow; kernel 3 bit-equal to its plain version on all"
          f" {len(flow_compactions)} compactions of the flow, at capacities"
          f" {sorted({int(a[0].shape[0]) for a in flow_compactions})}")

    # ---- phase 10: the 160k pair: NN, one GICP run, one analyzer query ------
    whole = port.cwipc_synthetic(0, PAIR_N, device=dev)
    whole.start()
    body_pc = whole.get()
    whole.stop()
    P = perturbation(REG_SEED, REG_TRANSLATION, REG_ROTATION)
    ref_pc = NoiseFilter(REG_NOISE, seed=REG_SEED + 1).filter(body_pc)
    mov_pc = NoiseFilter(REG_NOISE, seed=REG_SEED + 2).filter(cwipc_transform(body_pc, P))
    rb, sb = ref_pc._access_buffer(), mov_pc._access_buffer()
    n_ref, n_mov = ref_pc.count(), mov_pc.count()
    nn_grids.clear()
    recording(True)
    try:
        oracle_nn(sb.xyz, n_mov, rb.xyz, n_ref, PAIR_MAXD, f"{n_mov}-point pair")
        al = fine.RegistrationComputer_ICP_Generalized()
        al.set_source_pointcloud(mov_pc)
        al.set_reference_pointcloud(ref_pc)
        al.set_correspondence(PAIR_MAXD)
        icp_runs.clear()
        check(al.run(), "GICP on the 160k pair failed")
        T_kernel = al.get_result_transformation()
        gicp = icp_runs[-1]
        check(gicp["launches"] >= 1 and gicp["kw"]["grid"] is not None, "the 160k GICP did not run on kernel 5")
        # the same run through the plain version on the card: on CPU tensors
        # the plain version takes minutes an iteration at this size
        knn.nn_select = nn_select_plain
        torch.cuda.synchronize()
        t_0 = time.perf_counter()
        T_plain = real_icp(*gicp["args"], **gicp["kw"]).cpu().numpy().astype(np.float64)
        gicp_plain_s = time.perf_counter() - t_0
        knn.nn_select = recording_select
        an = analyze.RegistrationAnalyzerSymmetric()
        an.set_source_pointcloud(mov_pc)
        an.set_reference_pointcloud(ref_pc)
        an.set_max_correspondence_distance(PAIR_MAXD)
        n0 = nn_select.launches
        torch.cuda.synchronize()
        t_0 = time.perf_counter()
        an.run()
        an_s = time.perf_counter() - t_0
        check(nn_select.launches > n0, "the 160k analyzer query did not launch kernel 5")
    finally:
        recording(False)
    pair_grids = list(nn_grids)
    res = {}
    for name, T in (("kernel", T_kernel), ("plain", T_plain)):
        res[name] = transformation_compare(T @ P, np.identity(4))
        check(res[name][0] < 0.004 and res[name][1] < 0.02,
              f"the 160k GICP on the {name} version missed the perturbation by {res[name]}")
    drift = transformation_compare(T_kernel, T_plain)
    check(drift[0] < 1e-3 and drift[1] < 5e-3, f"the 160k GICP: kernel and plain poses differ by {drift}")
    for planes, kw in pair_grids:
        nn_case(planes[:3], planes[3:], kw["gy"], kw["gz"], kw["cap_r"], kw["cap_q"], f"160k grid {kw}")
    print(f"{card} phase 10: kernel 5 equal to its plain version on all {len(pair_grids)} grid pairs of the"
          f" 160k pair; GICP on {n_mov} -> {n_ref} points, grid {gicp['kw']['grid']}: residual against the"
          f" perturbation (m, rad) kernel {res['kernel']}, plain {res['plain']}; kernel vs plain {drift};"
          f" {gicp['s']} s on kernel 5, {gicp_plain_s} s on its plain version; analyzer query"
          f" {an.get_results().minCorrespondence} in {an_s} s")
    print(f"{card} phase 10 ok {lap()}")

    # ---- phase 11: times of the registration path ----------------------------
    first_icp = flow_icp[0]
    icp30_s = host_s(lambda: real_icp(*first_icp["args"], **first_icp["kw"]))
    icp160_s = host_s(lambda: real_icp(*gicp["args"], **gicp["kw"]), reps=1)
    print(f"{card} flow: MultiCameraIterative {flow_s} s; stages {flow_stages};"
          f" the register script's analyses {check_s}")
    print(f"{card} ICP (_icp_fused, GICP, kernel 5): {icp30_s} s at {int(first_icp['args'][1])} points,"
          f" {icp160_s} s at {n_mov} points")

    # the grid query's parts on the 160k pair, at the pair's initial pose
    perm, gy_, gz_, cap_r, cap_q = gicp["kw"]["grid"]
    vmin = gicp["args"][9]
    pidx = list(perm)
    cell_g = knn.grid_cell(PAIR_MAXD)
    src_p, ref_p = sb.xyz[:, pidx], rb.xyz[:, pidx]
    prep = knn.nn_grid_prepare(ref_p, rb.count, cell_g, gy=gy_, gz=gz_, cap=cap_r, vmin=vmin)
    geo = dict(gy=gy_, gz=gz_, cap_r=cap_r, cap_q=cap_q)

    def q_build():
        return cols_knn._cols_build(src_p, sb.count, cell_g, gy=gy_, gz=gz_, cap=cap_q, chunk=256,
                                    vmin_override=vmin)

    q_xs, q_ys, q_zs, q_orig, *_ = q_build()

    def k5_pair():
        return nn_select(*prep[:3], q_xs, q_ys, q_zs, **geo)

    d2m, cidm = k5_pair()

    def decode():
        return knn._nn_grid_decode(d2m, cidm, prep[3], prep[4], q_orig, sb.xyz.shape[0], sb.count, PAIR_MAXD, **geo)

    fix = decode()[2]

    def fixup():
        return knn.bruteforce_nn_subset(sb.xyz, sb.count, fix, rb.xyz, rb.count, PAIR_MAXD)

    def grid_query():
        d, i, f = knn.nn_grid_query(src_p, sb.count, prep, cell_g, PAIR_MAXD, vmin=vmin, **geo)
        return knn.bruteforce_nn_subset(sb.xyz, sb.count, f, rb.xyz, rb.count, PAIR_MAXD)

    n_fix = int(fix.sum())
    q_parts = {"query grid build": q_build, "kernel 5": k5_pair, "decode": decode,
               f"fixup ({n_fix} queries)": fixup, "whole query with fixup": grid_query}
    for name, fn in q_parts.items():
        print(f"{card} grid query at {n_mov} points, grid {(perm, gy_, gz_, cap_r, cap_q)}, {name}:"
              f" median {time_ms(fn, reps=10, warm=2)} ms")
    print(f"{card} NN search at {n_mov} points: grid (nn_search_host_auto) {host_s(lambda: knn.nn_search_host_auto(sb.xyz, sb.count, rb.xyz, rb.count, PAIR_MAXD))} s,"
          f" two-scale (nn_search) {host_s(lambda: knn.nn_search(sb.xyz, sb.count, rb.xyz, rb.count, PAIR_MAXD))} s")

    # kernel 5 against its plain version on the flow's largest grid, in turns
    planes, kw = max(flow_grids, key=lambda rec: rec[1]["gy"] * rec[1]["gz"] * rec[1]["cap_r"] * rec[1]["cap_q"])

    def k5_kernel():
        return nn_select(*planes, **kw)

    def k5_plain():
        return nn_select_plain(*planes, **kw)

    kms, pms, _, k5_runs = in_turns(k5_kernel, k5_plain, plain_reps=3, plain_warm=1)
    # 8 flops of d2 per (query, candidate) pair of the ring
    k5_pairs = ring_pairs(planes[3], planes[0], kw["gz"], kw["gy"] * kw["gz"])
    k5_bytes = ring_bytes(planes[:3], planes[3:], kw["gz"], kw["gy"] * kw["gz"], k5_kernel())
    k5_bms, k5_bby = bound(k5_bytes, 8 * k5_pairs)
    print(f"{card} kernel nn_select on the flow's largest grid {kw}: {kms} ms; plain PyTorch {pms} ms; in turns"
          f" (plain, kernel, kernel, plain) {k5_runs}; bound {k5_bms} ms ({k5_bby}: {k5_bytes} bytes, {k5_pairs} ring"
          f" pairs); no one PyTorch call computes it (torch.cdist + min is two calls over all pairs)")
    # every call the 30k flow made, each timed on its own planes
    flow_ms, flow_bms = [], []
    for pl, kw_ in flow_grids:
        flow_ms.append(time_ms(lambda: nn_select(*pl, **kw_), reps=5, warm=1))
        gyz_ = kw_["gy"] * kw_["gz"]
        flow_bms.append(bound(ring_bytes(pl[:3], pl[3:], kw_["gz"], gyz_, nn_select(*pl, **kw_)),
                              8 * ring_pairs(pl[3], pl[0], kw_["gz"], gyz_))[0])
    print(f"{card} kernel nn_select summed over the flow's {len(flow_grids)} calls: {sum(flow_ms)} ms (per call"
          f" {min(flow_ms)} to {max(flow_ms)} ms); bound summed {sum(flow_bms)} ms")
    record.append({
        "name": "nn_select", "route": "cuda", "source": "cwipc_util_tpu_torch/csrc/nn_select.cu",
        "replaces": "cwipc_util_tpu/ops/pallas_nn.py:246", "launches": reg_launches["nn_select"],
        "max_abs_err": k5_err[0], "ms": kms, "plain_ms": pms, "bound_ms": k5_bms, "bound_by": k5_bby,
        "library_ms": None,
    })
    print(f"{card} phase 11 ok {lap()}")

    # ---- phases 12-15: kernels 6 and 7, the ops and filter path, times -------
    from types import SimpleNamespace

    ctx = SimpleNamespace(dev=dev, card=card, lap=lap, t=t, buf=buf, pts=pts, sorted=(smk, sfr, srgba),
                          down=(x, y, z, rgba, cnt), keep=keep)
    s12 = sort_phase(ctx)
    s13 = scan_phase(ctx)
    s14 = ops_phase(ctx)
    k4 = {"pairs": k4_pairs, "scans": k4_scans, "ms": next(r["ms"] for r in record if r["name"] == "cols_select")}
    record += times_phase(ctx, s12, s13, s14, k4)
    s16 = codec_phase(ctx)
    for r in record:
        r["codec_launches"] = s16["launches"].get({"segment_reduce": "segment_reduce_sorted",
                                                   "compact": "compact_kernel_cm"}.get(r["name"]), 0)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
