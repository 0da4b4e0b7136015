"""Kernel 1 parity: the port's segmented reduce (its plain version, which
CPU tensors run) against the JAX package's Pallas kernel in interpret
mode.  Rows 0-7 (sums, count, tile OR), the run keys and the run count
must be bit-equal: every value is an exact integer or multiple of 1/2048
in f32 for runs under 8192 points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu.ops.pallas_segment_reduce import segment_reduce_sorted as jax_reduce
from cwipc_util_tpu_torch.ops.segment_reduce import (
    SENTINEL,
    segment_reduce_sorted,
    segment_reduce_sorted_plain,
)


def _runs(count, nruns, cap, seed):
    rng = np.random.default_rng(seed)
    if count:
        lens = rng.multinomial(count, np.ones(nruns) / nruns)
        keys = np.repeat(
            np.sort(rng.choice(1 << 29, size=nruns, replace=False)).astype(np.int32), lens
        )[:count]
    else:
        keys = np.zeros(0, np.int32)
    smk = np.full(cap, SENTINEL, np.int32)
    smk[: len(keys)] = keys
    sfr = rng.integers(0, 1 << 30, size=cap).astype(np.int32)
    srgba = rng.integers(-(2**31), 2**31, size=cap).astype(np.int32)
    return smk, sfr, srgba


def _compare(smk, sfr, srgba, ocap):
    jout, jnseg = jax_reduce(
        jnp.asarray(smk), jnp.asarray(sfr), jnp.asarray(srgba),
        jnp.int32(int((smk != SENTINEL).sum())), out_capacity=ocap,
    )
    jout = np.asarray(jout)
    args = [torch.from_numpy(a) for a in (smk, sfr, srgba)]
    rows, key, nseg = segment_reduce_sorted(*args, ocap)
    assert int(nseg) == int(jnseg)
    # the TPU kernel leaves columns past the last run unwritten: compare
    # the runs, and require the port's tail to be zero
    m = min(int(nseg), ocap)
    np.testing.assert_array_equal(rows[:, :m].numpy().view(np.uint32), jout[0:8, :m].view(np.uint32))
    jkey = jout[8, :m].astype(np.int64) + jout[9, :m].astype(np.int64) * 32768
    np.testing.assert_array_equal(key[:m].numpy(), jkey)
    assert not rows[:, m:].any() and not key[m:].any()
    # the wrapper on CPU tensors is the plain version
    prow, pkey, pn = segment_reduce_sorted_plain(*args, ocap)
    assert torch.equal(prow, rows) and torch.equal(pkey, key) and int(pn) == int(nseg)
    return rows, key, int(nseg)


@pytest.mark.parametrize(
    "count,nruns,cap",
    [(3500, 300, 4096), (3000, 5, 4096), (100, 7, 3000), (0, 1, 4096)],
)  # (3000, 5): runs longer than a 1024-point tile; cap 3000: a ragged last tile
def test_matches_pallas_kernel(count, nruns, cap):
    smk, sfr, srgba = _runs(count, nruns, cap, count + nruns)
    _compare(smk, sfr, srgba, 2048)


def test_out_capacity_drops_runs():
    """Runs past out_capacity are dropped; nseg still counts them all."""
    smk, sfr, srgba = _runs(4000, 700, 4096, 5)
    rows, key, nseg = _compare(smk, sfr, srgba, 256)
    assert nseg == len(np.unique(smk[smk != SENTINEL])) > 256
    assert rows.shape == (8, 256)


def test_tile_or_exact_for_runs_over_2048():
    """One 4096-point run with tile bit 0 set: count and tile OR exact
    (tests/test_pallas.py TestLongRunTileOr)."""
    cap = 1 << 12
    smk = np.zeros(cap, np.int32)
    sfr = np.zeros(cap, np.int32)
    srgba = np.full(cap, (1 << 24) | 0x00AABBCC, np.int32)
    rows, key, nseg = _compare(smk, sfr, srgba, 256)
    assert nseg == 1 and int(rows[6, 0]) == cap and int(rows[7, 0]) == 1


def test_tile_or_exact_mixed_bits_long_runs():
    """Long runs mixing low and high tile bits keep both."""
    cap = 1 << 12
    smk = np.concatenate([np.zeros(cap // 2, np.int32), np.ones(cap // 2, np.int32)])
    sfr = np.zeros(cap, np.int32)
    tiles = np.concatenate([
        np.full(cap // 4, 0x01, np.uint32),
        np.full(cap // 4, 0x10, np.uint32),
        np.full(cap // 2, 0x88, np.uint32),
    ])
    srgba = ((tiles << 24) | 0x00112233).view(np.int32)
    rows, key, nseg = _compare(smk, sfr, srgba, 256)
    assert nseg == 2
    assert int(rows[7, 0]) == 0x11 and int(rows[7, 1]) == 0x88
    assert key[:2].tolist() == [0, 1]
