"""The `cwipc` command dispatcher of the port.

    python -m cwipc_util_tpu_torch <command> [arguments]

The port of cwipc_util_tpu/__main__.py, a re-implementation of the
reference's __main__ (reference: python/cwipc/__main__.py:9,18-60,138-158):
`cwipc <subcommand>` delegates to
cwipc_util_tpu_torch.scripts.cwipc_<subcommand>.main(), with subcommands
DISCOVERED from the port's scripts package (any cwipc_*.py module is a
command; only the ported ones exist, and only they are listed); specials:

* help     — list main/additional/special commands with their docstrings
* version  — print version (also -v/--version)
* check    — run install self-checks (``--device cpu`` on the host)
* python   — run the interpreter with cwipc importable
* parallel — run 2-3 cwipc commands as subprocesses with a stagger
  (the multi-process test harness, __main__.py:91-136)
"""

from __future__ import annotations

import importlib
import os
import pkgutil
import subprocess
import sys
import time
from typing import List, Tuple

MAIN_COMMANDS = ["view", "grab", "play", "copy", "register"]

PARALLEL_STAGGER_SECONDS = float(os.environ.get("CWIPC_PARALLEL_STAGGER", "2"))


def find_scripts() -> Tuple[List[str], List[str]]:
    """(main, additional) command lists, discovered from the scripts
    package like the reference (__main__.py:18-27)."""
    from . import scripts

    found = [name[6:] for _, name, _ in pkgutil.iter_modules(scripts.__path__) if name.startswith("cwipc_")]
    main = [c for c in MAIN_COMMANDS if c in found]
    return main, sorted(c for c in found if c not in MAIN_COMMANDS)


def get_docstring(name: str) -> str:
    """First docstring line of the command's script module."""
    mod = importlib.import_module(f".scripts.cwipc_{name}", package="cwipc_util_tpu_torch")
    if mod.__doc__ is None:
        return ""
    return mod.__doc__.strip().split("\n")[0]


def help() -> None:
    main_scripts, auxiliary_scripts = find_scripts()
    print(f"{sys.argv[0]} - CWI Point Cloud command line utility", file=sys.stderr)
    print("\nMain commands:", file=sys.stderr)
    for s in main_scripts:
        doc = get_docstring(s)
        print(f"  {s:20} - {doc}" if doc else f"  {s:20}", file=sys.stderr)
    print("\nAdditional commands:", file=sys.stderr)
    for s in auxiliary_scripts:
        doc = get_docstring(s)
        print(f"  {s:20} - {doc}" if doc else f"  {s:20}", file=sys.stderr)
    print("\nSpecial commands:", file=sys.stderr)
    print("  help                 - show this help message", file=sys.stderr)
    print("  version              - show cwipc version", file=sys.stderr)
    print("  check                - check if cwipc is correctly installed", file=sys.stderr)
    print("  python               - run python that has the cwipc package installed", file=sys.stderr)
    print("  parallel             - run multiple commands in parallel (for testing)", file=sys.stderr)
    print("\nUse 'cwipc <command> -h' for help on a specific command.", file=sys.stderr)


def run_version() -> int:
    import cwipc_util_tpu_torch

    print(cwipc_util_tpu_torch.cwipc_get_version())
    return 0


def run_python() -> int:
    os.execv(sys.executable, [sys.executable] + sys.argv[2:])
    raise AssertionError("execv failed")


def run_parallel(argv: List[str]) -> int:
    """Run `--`-separated cwipc commands as staggered subprocesses."""
    commands: List[List[str]] = [[]]
    for arg in argv:
        if arg == "--":
            commands.append([])
        else:
            commands[-1].append(arg)
    commands = [c for c in commands if c]
    if not 2 <= len(commands) <= 3:
        print("cwipc parallel: expected 2 or 3 commands separated by --", file=sys.stderr)
        return 2
    procs = []
    for i, cmd in enumerate(commands):
        full = [sys.executable, "-m", "cwipc_util_tpu_torch"] + cmd
        procs.append(subprocess.Popen(full))
        if i < len(commands) - 1:
            time.sleep(PARALLEL_STAGGER_SECONDS)
    status = 0
    for p in procs:
        p.wait()
        status = status or p.returncode
    return status


def run_check(argv: List[str]) -> int:
    """Install self-check: core round trips + module probes, on the device
    of ``--device`` (default CUDA)."""
    import argparse

    import cwipc_util_tpu_torch as cwipc
    from cwipc_util_tpu_torch import codec

    parser = argparse.ArgumentParser(prog="cwipc check")
    parser.add_argument("--device", default="cuda", help="Torch device (default cuda)")
    device = cwipc.resolve_device(parser.parse_args(argv).device)
    print(f"cwipc_util_tpu_torch version {cwipc.cwipc_get_version()} on {device}")
    pc = cwipc.cwipc_from_points([(1, 2, 3, 4, 5, 6, 7)], 42, device=device)
    assert pc.count() == 1
    packet = pc.get_packet()
    pc2 = cwipc.cwipc_from_packet(packet, device)
    assert list(pc.get_points()) == list(pc2.get_points())
    print("cwipc_util_tpu_torch: core: ok")
    gen = cwipc.cwipc_synthetic(0, 1000, device=device)
    gen.start()
    spc = gen.get()
    gen.stop()
    assert spc is not None and spc.count() > 0
    print("cwipc_util_tpu_torch: synthetic: ok")
    enc = codec.cwipc_new_encoder()
    enc.feed(spc)
    dec = codec.cwipc_new_decoder(device)
    dec.feed(enc.get_bytes())
    dpc = dec.get()
    assert dpc is not None and dpc.count() > 0
    print("cwipc_util_tpu_torch: codec: ok")
    for mod in ("kinect", "realsense2", "orbbec"):
        ok = cwipc.cwipc_check_module(mod)
        print(f"cwipc_util_tpu_torch: capturer {mod}: {'ok' if ok else 'not installed'}")
    print("cwipc_util_tpu_torch: check: all ok")
    return 0


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "help"):
        help()
        return 1
    subcommand = sys.argv[1]
    argv = sys.argv[2:]
    if subcommand in ("-v", "--version", "version"):
        return run_version()
    if subcommand == "check":
        return run_check(argv)
    if subcommand == "python":
        return run_python()
    if subcommand == "parallel":
        return run_parallel(argv)
    try:
        module = importlib.import_module(
            f".scripts.cwipc_{subcommand}", package="cwipc_util_tpu_torch"
        )
    except ModuleNotFoundError:
        print(f"Unknown command '{subcommand}'. Use -h for help.", file=sys.stderr)
        return 1
    sys.argv = [f"cwipc {subcommand}"] + argv
    return module.main()


if __name__ == "__main__":
    sys.exit(main())
