"""A whole run (harness/cell.py, the card's look left out) on the tiny
configuration on the CPU, with the timed path broken underneath: each
fault the exact cells can have makes ``correct`` false; the sound chain
makes it true.  ``fixup_thin`` breaks the brute-force fixup of the points
kernel 4's ring does not cover (the tiny body has a few a frame): the
check sees it through the keep decisions, as it has no md of the program
to compare (PERF.md, section 4)."""

from __future__ import annotations

import time

import pytest
import torch

from harness import cell, spec

FAULTS = ("altered", "half", "unchanged", "fixup_thin")


def _run(cfg):
    line, notes = cell.run_cell(cfg=cfg, traffic=spec.traffic("exact-closed"), metrics=[], seed=2**31 + 17,
                                seconds=1.0, traced=False, t_start=time.time(), device="cpu")
    assert line["attempted"] >= 1 and len(notes) == 4
    return line


@pytest.fixture
def broken(monkeypatch):
    from cwipc_util_tpu_torch.core.buffers import PointBuffer
    from cwipc_util_tpu_torch.ops import chain

    sound = chain.downsample_outliers_tilefilter_exact
    sound_fixup = chain.bruteforce_md_subset

    def fixup_thin(xyz, count, sel, k, *args, **kwargs):
        """The fixup scanning too few candidates: every other voxel, bar
        its own rows, moved out of reach."""
        odd = (torch.arange(xyz.shape[0], device=xyz.device) % 2 == 1) & ~sel
        return sound_fixup(torch.where(odd[:, None], xyz + 1e3, xyz), count, sel, k, *args, **kwargs)

    def install(fault):
        if fault == "fixup_thin":
            monkeypatch.setattr(chain, "bruteforce_md_subset", fixup_thin)
            return
        def chain_with_fault(buf, cellsize, *args, **kwargs):
            if fault == "half":  # half of the frame's points left out
                buf = PointBuffer(xyz=buf.xyz, rgba=buf.rgba, count=buf.count // 2)
            if fault == "unchanged":  # the step hands its input back
                return buf, torch.zeros((), dtype=torch.int32)
            out, unc = sound(buf, cellsize, *args, **kwargs)
            if fault == "altered":  # one answer altered where it is produced
                xyz = out.xyz.clone()
                xyz[0, 0] += cellsize
                out = PointBuffer(xyz=xyz, rgba=out.rgba, count=out.count)
            return out, unc

        monkeypatch.setattr(chain, "downsample_outliers_tilefilter_exact", chain_with_fault)

    return install


def test_sound_chain_is_correct(tiny_config):
    assert _run(tiny_config)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_makes_the_run_incorrect(tiny_config, broken, fault):
    broken(fault)
    line = _run(tiny_config)
    assert line["correct"] is False and line["failed"] >= 1
