"""Kernel 7 (the scan probe) on the card: its SASS, its checks and its times.

    python cwipc_util_tpu_torch/benchmarks/scan_probe_bench.py [--sass] [--check]
        [--parent CHECKOUT] [--reps N] [--out FILE]

* ``--sass`` disassembles the built library (``cuobjdump -sass``) and, for
  each instantiation of kernel 7, counts the instructions of its innermost
  loops by opcode, with the instructions per element-step of the loop that
  scans (its compares, or its shuffles for ``add``, give the steps an
  iteration covers).  The full listing goes to ``--out`` when given.
* ``--check`` holds every form bit-equal to its plain version at
  sel_roofline.py's shape (S 1536, T 64, 64 tiles), at S 1000, at one tile,
  at S 1536 / T 16384 (S * T > 2^24) and on a 4,096-row input whose
  per-step counts are odd and whose sum passes 2^24 (T 4200), and counts
  the kernel launches of one call with torch.profiler.
* Without ``--parent`` it times each form at sel_roofline's shape: CUDA
  events around the wrapper call and device time by torch.profiler.  With
  ``--parent`` it also builds CHECKOUT's ``csrc/scan_probe.cu`` alone (the
  earlier three-launch design, whose entry point takes a [T, C] int32
  scratch) and times the two in turns, parent, this, this, parent, form by
  form, in both measures; the parent's call allocates its scratch and
  output as its wrapper did.

Each result is one JSON line on stdout, with the card's name, its power
limit and the SM clocks (lowest, median, highest) that ``nvidia-smi``
read while each version ran back to back for 1.5 s.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from chip_smoke import device_ops, sm_clock_during, time_ms  # noqa: E402


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- SASS

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function : (\S+)")


def _opcode(text: str) -> str:
    tok = text.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0].split(".")[0] if tok else ""


def sass_loops(listing: str) -> dict:
    """{function: [innermost loops as (n instructions, Counter of opcodes)]}."""
    funcs, name, insns, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        loops = []
        for i, (addr, text) in enumerate(insns):
            if _opcode(text) != "BRA":
                continue
            m = re.search(r"\(?(\.L_x_\d+)\)?", text)
            target = labels.get(m.group(1)) if m else None
            if target is None:
                m = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
                target = int(m.group(1), 16) if m else None
            if target is not None and target <= addr:
                loops.append((target, addr))
        inner = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        funcs[name] = [(sum(1 for a, _ in insns if lo <= a <= hi),
                        collections.Counter(_opcode(t) for a, t in insns if lo <= a <= hi)) for lo, hi in inner]

    pending = []
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            close()
            name, insns, labels, pending = m.group(1), [], {}, []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2)))
    close()
    return funcs


def sass_report(listing: str, rows: int) -> list[dict]:
    out = []
    for func, loops in sorted(sass_loops(listing).items()):
        if "scan_total" not in func and "scan_steps" not in func:
            continue
        form = int(re.search(r"ILi(\d)E", func).group(1)) if re.search(r"ILi(\d)E", func) else None
        best = None
        for n, ops in loops:
            setp = ops["ISETP"] + ops["FSETP"]
            # the scanning loop: the one with the most compares (add: shuffles)
            key = ops["SHFL"] if form == 4 else setp
            if best is None or key > best[0]:
                best = (key, n, ops)
        if best is None:
            out.append({"function": func, "loops": 0})
            continue
        key, n, ops = best
        steps = max(1, round(key / (2 if form == 4 else rows)))
        out.append({"function": func, "form": form, "loop_instructions": n, "steps_an_iteration": steps,
                    "instructions_per_element_step": n / (rows * steps), "opcodes": dict(ops.most_common()),
                    "innermost_loops": [m for m, _ in loops]})
    return out


def cuobjdump() -> str:
    from cwipc_util_tpu_torch import _kernels

    return os.path.join(os.path.dirname(_kernels.find_nvcc()), "cuobjdump")


# ---------------------------------------------------------------- the earlier design

def build_parent(checkout: str) -> ctypes.CDLL:
    from cwipc_util_tpu_torch import _kernels

    src = os.path.join(os.path.abspath(checkout), "cwipc_util_tpu_torch", "csrc", "scan_probe.cu")
    out = os.path.join(_kernels.BUILD_DIR, "parent_scan_probe.so")
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cwipc_scan_probe.argtypes = (P, I, I, I, I, P, P, P)
    lib.cwipc_scan_probe.restype = I
    return lib


def parent_call(lib, x, form: str, t: int):
    """The earlier wrapper's call: a [T, C] scratch, the output, the launch."""
    import torch

    from cwipc_util_tpu_torch import _kernels
    from cwipc_util_tpu_torch.ops.scan_probe import FORMS

    s, c = x.shape
    cnt = torch.empty((max(t, 1), c), dtype=torch.int32, device=x.device)
    out = torch.empty((8, c), dtype=torch.float32, device=x.device)
    err = lib.cwipc_scan_probe(x.data_ptr(), FORMS.index(form), s, c, t, cnt.data_ptr(), out.data_ptr(),
                               _kernels.stream(x))
    if err:
        raise RuntimeError(f"the parent's kernel 7 failed: CUDA error {err}")
    return out


# ---------------------------------------------------------------- checks

def check(dev, emit) -> None:
    import torch

    from cwipc_util_tpu_torch.ops.scan_probe import (FORMS, make_inputs, rounding_input, scan_plan, scan_program,
                                                     scan_program_plain)

    cases = [("sel_roofline", 1536, 64, 64), ("ragged S", 1000, 64, 64), ("one tile", 1536, 64, 1),
             ("S*T > 2^24", 1536, 16384, 1)]
    for label, s, t, tiles in cases:
        xs = {f: x.to(dev) for f, x in make_inputs(s, tiles).items()}
        for f in FORMS:
            got = scan_program(xs[f], f, t)
            want = scan_program_plain(xs[f], f, t)
            same = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
            emit({"check": label, "form": f, "s": s, "t": t, "tiles": tiles,
                  "per_step": scan_plan(s, t, tiles * 128, f).per_step, "bit_equal": same,
                  "max_abs_err": float((got.double() - want.double()).abs().max())})
    x = rounding_input().to(dev)
    for f in ("i32", "mxu"):
        got, want = scan_program(x, f, 4200), scan_program_plain(x, f, 4200)
        emit({"check": "odd counts past 2^24", "form": f, "s": 4096, "t": 4200,
              "bit_equal": bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))})
    xs = {f: x.to(dev) for f, x in make_inputs(1536, 64).items()}
    for f in FORMS:
        emit({"check": "device operations a call", "form": f,
              "ops": device_ops(lambda: scan_program(xs[f], f, 64), calls=1)})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--parent", help="a checkout whose kernel 7 is timed in turns with this one")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--out", help="file for the full SASS listing")
    args = parser.parse_args()

    import torch

    from cwipc_util_tpu_torch import _kernels
    from cwipc_util_tpu_torch.ops.scan_probe import FORMS, NTILES, ROWS, S, T, make_inputs, scan_program

    if not torch.cuda.is_available():
        print("scan_probe_bench: no CUDA device", file=sys.stderr)
        return 2
    card = {"card": smi("name,power.limit"), "clocks_max_sm": smi("clocks.max.sm")}

    def emit(rec):
        print(json.dumps({**rec, **card}), flush=True)

    dev = torch.device("cuda")
    _kernels.load()
    if args.sass:
        listing = subprocess.run([cuobjdump(), "-sass", str(_kernels.build())], capture_output=True, text=True,
                                 check=True).stdout
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(listing)
        for rec in sass_report(listing, ROWS):
            emit(rec)
    if args.check:
        check(dev, emit)
    parent = build_parent(args.parent) if args.parent else None
    xs = {f: x.to(dev) for f, x in make_inputs(S, NTILES).items()}
    steps = S * NTILES * 128 * T
    for f in FORMS:
        x = xs[f]
        this = lambda: scan_program(x, f, T)  # noqa: E731
        if parent is not None:
            old = lambda: parent_call(parent, x, f, T)  # noqa: E731
            if not torch.equal(old(), this()):
                raise SystemExit(f"scan_probe_bench: {f}: the parent's result differs")
            ms = {"parent": [time_ms(old, args.reps)],
                  "this": [time_ms(this, args.reps), time_ms(this, args.reps)]}
            ms["parent"].append(time_ms(old, args.reps))
            dev = {"parent": [device_ops(old)], "this": [device_ops(this), device_ops(this)]}
            dev["parent"].append(device_ops(old))
            rec = {"parent_ms": ms["parent"], "parent_device_us": [sum(o[2] for o in d) for d in dev["parent"]],
                   "parent_device_ops": dev["parent"][0], "parent_sm_mhz": sm_clock_during(old)}
        else:
            ms, dev, rec = {"this": [time_ms(this, args.reps)]}, {"this": [device_ops(this)]}, {}
        emit({"form": f, "element_steps": steps, "this_ms": ms["this"],
              "this_device_us": [sum(o[2] for o in d) for d in dev["this"]], "this_device_ops": dev["this"][0],
              "this_sm_mhz": sm_clock_during(this), **rec})
    return 0


if __name__ == "__main__":
    sys.exit(main())
