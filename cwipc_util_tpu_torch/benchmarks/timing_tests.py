"""Per-accessor microbenchmarks — the reference's timing harness.

The port of cwipc_util_tpu/benchmarks/timing_tests.py.  The cloud and
every op run on ``--device`` (default CUDA); an op whose result stays on
the card is timed up to a ``torch.cuda.synchronize()``, so the time is the
work's and not its enqueue.  Run as a module:

    python -m cwipc_util_tpu_torch.benchmarks.timing_tests [npoints] [--device cpu]

Re-implementation of python/timing_tests.py (reference: 355 LoC): each
accessor (get_bytes / get_packet / get_points / get_numpy_array /
get_numpy_matrix) and its round-trip constructor is timed on a 1M-point
synthetic cloud, limited to 5 s or 100 iterations per step, printing
seconds per operation.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Tuple

import torch

MAX_SECONDS = 5.0
MAX_ITERATIONS = 100
DEFAULT_NPOINTS = 1_000_000


def _timeit(name: str, setup: Callable, op: Callable, sync: Callable) -> None:
    # warm up on a throwaway context (kernel builds), then time each
    # iteration on a fresh context with setup excluded from the clock:
    # reusing one context would populate its lazy caches and the cached
    # accessors (get_bytes/get_points) would measure a dict lookup instead
    # of the materialization work this harness claims to measure
    op(setup())
    sync()
    n = 0
    spent = 0.0
    while n < MAX_ITERATIONS and spent < MAX_SECONDS:
        ctx = setup()
        sync()
        t0 = time.perf_counter()
        op(ctx)
        sync()
        spent += time.perf_counter() - t0
        n += 1
    dt = spent / max(n, 1)
    print(f"{name}: {dt:.6f} seconds per operation ({n} iterations)")


def main() -> int:
    import cwipc_util_tpu_torch as cwipc

    parser = argparse.ArgumentParser(prog="timing_tests", description="Per-accessor microbenchmarks")
    parser.add_argument("npoints", nargs="?", type=int, default=DEFAULT_NPOINTS)
    parser.add_argument("--device", default="cuda", help="Torch device (default cuda; cpu runs on the host)")
    args = parser.parse_args()
    device = cwipc.resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = cwipc.cwipc_synthetic(0, args.npoints, device=device)
    gen.start()
    pc = gen.get()
    gen.stop()
    assert pc is not None
    print(f"timing_tests: cloud of {pc.count()} points on {device}")

    def fresh():
        # a clone with cold caches so lazy accessors do real work
        return pc.clone()

    steps: List[Tuple[str, Callable, Callable]] = [
        ("get_bytes", fresh, lambda c: c.get_bytes()),
        ("get_packet", fresh, lambda c: c.get_packet()),
        ("get_points", fresh, lambda c: c.get_points()),
        ("get_numpy_array", fresh, lambda c: c.get_numpy_array()),
        ("get_numpy_matrix", fresh, lambda c: c.get_numpy_matrix()),
        (
            "get_bytes+from_points",
            fresh,
            lambda c: cwipc.cwipc_from_points(cwipc.cwipc_point_array(values=c.get_bytes()), 0, device),
        ),
        (
            "get_packet+from_packet",
            fresh,
            lambda c: cwipc.cwipc_from_packet(c.get_packet(), device),
        ),
        (
            "get_numpy_array+from_numpy_array",
            fresh,
            lambda c: cwipc.cwipc_from_numpy_array(c.get_numpy_array(), 0, device),
        ),
        (
            "get_numpy_matrix+from_numpy_matrix",
            fresh,
            lambda c: cwipc.cwipc_from_numpy_matrix(c.get_numpy_matrix(), 0, device),
        ),
        ("downsample(2x cellsize)", fresh, lambda c: cwipc.cwipc_downsample(c, c.cellsize() * 2)),
        ("tilefilter(1)", fresh, lambda c: cwipc.cwipc_tilefilter(c, 1)),
    ]
    for name, setup, op in steps:
        _timeit(name, setup, op, sync)
    return 0


if __name__ == "__main__":
    sys.exit(main())
