"""The readings each limit of the exact check was set from.

    python3 portbench/readings.py --config body-8ivfb-1m --seeds 11 12 13 [--control] [--faults]

For each seed: the sequence made as a run makes it, the program's entry
called on every frame held at the timed sizes (as the window calls it),
and each output judged against the float64 reference (reference/judge.py):
the program's readings.  With ``--control``, the reference computed in
bfloat16 put in the program's place.  With ``--faults``, three faults
planted in the program's outputs or inputs:

* ``altered``: one output point moved by one cell (an answer altered
  where it is produced);
* ``half``: the chain given half of the frame's points (half of the batch
  left out);
* ``unchanged``: the frame's input handed back as the output (a step that
  returns its state unchanged);
* ``fixup_thin``: the brute-force fixup of the points kernel 4's ring
  does not cover scanning too few candidates (every other voxel, bar its
  own rows, moved out of reach).

Also, as a witness for the ``keep_margin`` limit, the largest relative gap
between the program's md (read through a wrapper of the chain's
``keep_mask`` for this script alone) and the reference's.  One JSON line a
seed and kind, the worst over its frames.  Needs the card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import torch  # noqa: E402

from harness import bodies, spec  # noqa: E402
from reference import exact_chain, judge  # noqa: E402


def reference_output(ref: dict) -> tuple[torch.Tensor, torch.Tensor, int]:
    """A reference's kept voxels as the program's output: f32 centroids,
    rgba words, count."""
    kept = ref["kept"]
    xyz = ref["centroid"][kept].to(torch.float32)
    rgb, tile = ref["rgb"][kept], ref["tile"][kept]
    rgba = ((tile << 24) | (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]).to(torch.int32)
    return xyz, rgba, int(kept.shape[0])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="exact-closed")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        sys.exit("readings.py: no CUDA card")
    from cwipc_util_tpu_torch.core.buffers import PointBuffer
    from cwipc_util_tpu_torch.ops import chain as chain_mod

    cfg = spec.config_file(a.config)
    traffic = spec.traffic(a.traffic)
    ch = cfg["chain"]
    args = {key: ch[key] for key in traffic["args"]}
    entry = getattr(chain_mod, traffic["entry"])
    slab = traffic["slab_cells"] * ch["cellsize"]
    captured = {}
    keep_mask = chain_mod.keep_mask
    fixup = chain_mod.bruteforce_md_subset

    def fixup_thin(xyz, count, sel, k, *rest, **kw):
        odd = (torch.arange(xyz.shape[0], device=xyz.device) % 2 == 1) & ~sel
        return fixup(torch.where(odd[:, None], xyz + 1e3, xyz), count, sel, k, *rest, **kw)

    def spy(md, rgba, cnt, mult, tile):
        captured["md"] = md
        return keep_mask(md, rgba, cnt, mult, tile)

    for seed in a.seeds:
        held, _ = bodies.make_sequence(cfg, seed, a.device, capacity=cfg["capacity"])
        kinds: dict[str, list] = {"program": []}
        md_gap, uncs = 0.0, []
        for xyz, rgba, count in held:
            n = int(count)
            ref = exact_chain.run(xyz, rgba, n, cellsize=ch["cellsize"], k=ch["k"], mult=ch["mult"],
                                  tile=ch["tile"], slab=slab)
            chain_mod.keep_mask = spy
            try:
                out, unc = entry(PointBuffer(xyz=xyz, rgba=rgba, count=count), **args)
            finally:
                chain_mod.keep_mask = keep_mask
            uncs.append(int(unc))
            m = ref["key"].shape[0]
            md_prog = captured.pop("md")[:m].to(torch.float64)
            # the program's md is in its Morton order, which is the reference's key order
            md_gap = max(md_gap, float(((md_prog - ref["md"]).abs() / ref["md"]).max()))
            kinds["program"].append(judge.judge_frame(ref, out.xyz, out.rgba, int(out.count), ch["cellsize"]))
            if a.control:
                low = exact_chain.run(xyz, rgba, n, cellsize=ch["cellsize"], k=ch["k"], mult=ch["mult"],
                                      tile=ch["tile"], slab=slab, dtype=torch.bfloat16)
                kinds.setdefault("control_bf16", []).append(judge.judge_frame(ref, *reference_output(low), ch["cellsize"]))
            if a.faults:
                moved = out.xyz.clone()
                moved[0, 0] += ch["cellsize"]
                kinds.setdefault("altered", []).append(judge.judge_frame(ref, moved, out.rgba, int(out.count), ch["cellsize"]))
                half, _ = entry(PointBuffer(xyz=xyz, rgba=rgba, count=count // 2), **args)
                kinds.setdefault("half", []).append(judge.judge_frame(ref, half.xyz, half.rgba, int(half.count), ch["cellsize"]))
                kinds.setdefault("unchanged", []).append(judge.judge_frame(ref, xyz, rgba, n, ch["cellsize"]))
                chain_mod.bruteforce_md_subset = fixup_thin
                try:
                    thin, _ = entry(PointBuffer(xyz=xyz, rgba=rgba, count=count), **args)
                finally:
                    chain_mod.bruteforce_md_subset = fixup
                kinds.setdefault("fixup_thin", []).append(judge.judge_frame(ref, thin.xyz, thin.rgba, int(thin.count), ch["cellsize"]))
            del ref
        for kind, rs in kinds.items():
            line = {"config": a.config, "seed": seed, "kind": kind, "frames": len(rs), **judge.worst(rs)}
            if kind == "program":
                line["md_rel_gap"] = md_gap
                line["uncovered_last"] = int(unc)
                line["uncovered_max"] = max(uncs)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
