#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cwipc_util_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card.
It builds the CUDA kernels from ``cwipc_util_tpu_torch/csrc`` and then, in
phases that each stop the run at the first failure:

1. start: CUDA present, kernels built, the card's name and power limit;
2. each kernel against its plain PyTorch version on the card, at the fused
   chain's shapes and at edge cases (kernels 1 and 3 bit-equal, kernel 2
   allclose with rtol 1e-5, atol 1e-7: only the order of its final sum
   differs);
3. the fused chain ``downsample_outliers_tilefilter`` on the 1M-point
   synthetic bench cloud (bench.py's settings), with no host sync allowed:
   217,570 voxels exactly, 103,015 +/- 10 kept points, the same result as
   the chain run through the plain versions, and every kernel launched;
4. times with CUDA events: the chain, its stages, each kernel next to its
   plain version.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result.  The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the kernels' JSON record.
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

SENTINEL = 2**31 - 1


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to check", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cwipc_util_tpu_torch as port
    from cwipc_util_tpu_torch import _kernels
    from cwipc_util_tpu_torch.models.synthetic import _generate_host
    from cwipc_util_tpu_torch.ops import chain, compaction, outliers, voxelize
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
    print(f"{card} phase 1 ok: kernels built in {build_s} s into {lib_path.name};"
          f" torch {torch.__version__}, CUDA {torch.version.cuda}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def bits(x):
        return x.view(torch.int32)

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(bits(a.contiguous()), bits(b.contiguous()))

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

    (rows, key, nseg), (prows, _, _) = reduce_case(smk, sfr, srgba, OCAP)
    k1_err = float((rows - prows).abs().max())
    reduce_case(*runs(3000, 5, 4096), 2048)                 # runs longer than a 1024-point tile
    reduce_case(*runs(4096, 1, 4096, tiles=1), 256)         # one run of 4096 points, tile bit 0
    reduce_case(*runs(7000, 3, 8192, tiles=0x81), 256)      # runs over 2048 points, tile bits 0 and 7
    reduce_case(*runs(0, 1, 4096), 256)                     # count 0: no runs
    reduce_case(*runs(100, 7, 3000), 2048)                  # capacity not a multiple of the tile
    (_, _, n_over), _ = reduce_case(*runs(4000, 700, 4096), 256)  # runs past out_capacity dropped
    check(int(n_over) > 256, "kernel 1: nseg must count the runs past out_capacity")
    print(f"{card} phase 2: kernel 1 bit-equal to its plain version at n={smk.shape[0]} and 6 edge cases")

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
    cloud = np.sort(gen.random((4096, 3), dtype=np.float32), axis=0)
    cx, cy, cz = (t(cloud[:, a]) for a in range(3))

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    knn_case(cx, cy, cz, i32(4000), 30, 32)
    knn_case(cx, cy, cz, i32(100), 30, 16)
    knn_case(cx, cy, cz, i32(0), 30, 16)
    knn_case(cx[:3001], cy[:3001], cz[:3001], i32(2999), 5, 8)  # k far below 2W; ragged n
    knn_case(cx, cy, cz, i32(4096), 30, 1)                      # kk = 2
    print(f"{card} phase 2: kernel 2 allclose to its plain version at n={OCAP} and 5 edge cases")

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
    print(f"{card} phase 2: kernel 3 bit-equal to its plain version at n={OCAP} and 4 edge cases")

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
    print(f"{card} phase 3 ok: {n_vox} voxels, {n_kept} kept (plain chain {int(p_out.count)},"
          f" {n_flips} keep flips near the threshold), launches {launches}, no host sync")

    # ---- phase 4: times ----------------------------------------------------
    def time_ms(fn, reps=REPS, warm=3):
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
    for (name, src, tpu, err, kfn, pfn), f in zip(pairs, kernels):
        # plain, kernel, kernel, plain: one card, one call, in turns
        p1, k1, k2, p2 = time_ms(pfn), time_ms(kfn), time_ms(kfn), time_ms(pfn)
        kms, pms = statistics.median([k1, k2]), statistics.median([p1, p2])
        print(f"{card} kernel {name}: {kms} ms (runs {k1}, {k2}); plain PyTorch {pms} ms (runs {p1}, {p2})")
        record.append({
            "name": name, "route": "cuda", "source": f"cwipc_util_tpu_torch/csrc/{src}",
            "replaces": f"cwipc_util_tpu/ops/{tpu}", "launches": launches[f.__name__],
            "max_abs_err": err, "ms": kms, "plain_ms": pms,
        })
    print(f"{card} phase 4 ok")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
