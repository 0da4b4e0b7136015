"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout; its configuration, traffic and metrics resolve to files
under ``portbench/`` by name (harness/spec.py).  The program under test,
``cwipc_util_tpu_torch``, is imported from the same checkout.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks`` (each number the check compared, beside its limit); the
last lines of standard error repeat the checks.

Without a CUDA card, with fewer cards than the cell asks for, without the
program beside this folder, or where JAX or the JAX package got loaded,
it exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not (ROOT / "cwipc_util_tpu_torch" / "__init__.py").is_file():
        print(f"run.py: the program cwipc_util_tpu_torch is not in {ROOT}", file=sys.stderr)
        return 4
    sys.path[:0] = [str(HERE), str(ROOT)]
    early = {"python_start": time.time() - T_START}
    t = time.time()
    import torch

    early["import_torch"] = time.time() - t
    from harness import cell, spec

    bench = spec.load_bench(ROOT)
    w = spec.workload(bench, a.workload)
    chips = w["chips"]

    t = time.time()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: needs {chips} CUDA card(s); torch sees"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    early["cuda_probe"] = time.time() - t
    t = time.time()
    import cwipc_util_tpu_torch

    if Path(cwipc_util_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"run.py: cwipc_util_tpu_torch came from {cwipc_util_tpu_torch.__file__}, not {ROOT}",
              file=sys.stderr)
        return 4
    early["import_program"] = time.time() - t
    line, notes = cell.run_cell(cfg=spec.config(bench, w["config"], ROOT), traffic=spec.traffic(w["traffic"]),
                                metrics=spec.metrics_for(bench, a.workload, bool(a.trace)), seed=a.seed,
                                seconds=a.seconds, traced=bool(a.trace), t_start=T_START, parts=early)
    for note in notes:
        print(note, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
