"""Kernel 3 parity: the port's compaction (its plain version, which CPU
tensors run) against the JAX package's Pallas kernel in interpret mode
and its sort-based compaction.  Bit-equal: payload words, kept count and
the zeroed tail."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu.core import buffers as jbuffers
from cwipc_util_tpu.ops import compaction as jcompaction
from cwipc_util_tpu.ops.pallas_compact import compact_pallas_cm
import cwipc_util_tpu_torch as port
from cwipc_util_tpu_torch.ops import compaction
from cwipc_util_tpu_torch.ops.compact_kernel import compact_kernel_cm, compact_plain_cm


def _run_both(xyz, rgba, keep, count):
    """keep is restricted to [0, count) for the TPU kernel, which (unlike the
    port's) relies on its caller for that."""
    jkeep = keep & (np.arange(len(keep)) < count)
    jx, jy, jz, jrgba, jn = compact_pallas_cm(
        *(jnp.asarray(xyz[:, a]) for a in range(3)), jnp.asarray(rgba), jnp.asarray(jkeep), jnp.int32(count)
    )
    args = (
        *(torch.from_numpy(np.ascontiguousarray(xyz[:, a])) for a in range(3)),
        torch.from_numpy(rgba.view(np.int32)), torch.from_numpy(keep), torch.tensor(count, dtype=torch.int32),
    )
    got = compact_kernel_cm(*args)
    plain = compact_plain_cm(*args)
    for a, b in zip(got, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    cx, cy, cz, crgba, n = got
    assert int(n) == int(jn) == int(jkeep.sum())
    for mine, theirs in ((cx, jx), (cy, jy), (cz, jz)):
        np.testing.assert_array_equal(mine.numpy().view(np.uint32), np.asarray(theirs).view(np.uint32))
    np.testing.assert_array_equal(crgba.numpy().view(np.uint32), np.asarray(jrgba))
    return got


@pytest.mark.parametrize("count,frac", [(5000, 0.8), (2048, 1.0), (300, 0.3), (4096, 0.0)])
def test_matches_pallas_kernel(count, frac):
    cap = 1 << 13
    rng = np.random.default_rng(count)
    xyz = rng.standard_normal((cap, 3)).astype(np.float32)
    rgba = rng.integers(0, 1 << 32, cap, dtype=np.uint32)
    keep = rng.random(cap) < frac  # also set past count: the port masks it
    _, _, _, _, n = _run_both(xyz, rgba, keep, count)
    assert int(n) == int((keep[:count]).sum())


def test_nonfinite_payload_roundtrip():
    """inf, nan, -0.0, subnormal and near-max floats pass bit for bit."""
    cap = 1 << 10
    xyz = np.zeros((cap, 3), np.float32)
    xyz[0] = [np.inf, -np.inf, np.nan]
    xyz[1] = [-0.0, 1e-42, 3.4e38]
    xyz[2] = [np.float32(np.nan) * -1, 0.0, -1e-45]
    rgba = np.arange(cap, dtype=np.uint32) | np.uint32(0xFF000000)
    keep = np.zeros(cap, bool)
    keep[:4] = True
    cx, cy, cz, _, n = _run_both(xyz, rgba, keep, cap)
    assert int(n) == 4
    got = torch.stack([cx, cy, cz], -1)[:3].numpy()
    np.testing.assert_array_equal(got.view(np.uint32), xyz[:3].view(np.uint32))


@pytest.mark.parametrize("tile", [0, 1, 2])
def test_tilefilter_matches_jax(tile):
    """tilefilter through compaction, against the JAX package's tilefilter
    (its sort-based compaction on the CPU)."""
    rng = np.random.default_rng(tile)
    n, cap = 3000, 4096
    pts = np.zeros(n, jbuffers.POINT_DTYPE)
    for f in ("x", "y", "z"):
        pts[f] = rng.standard_normal(n).astype(np.float32)
    for f in ("r", "g", "b"):
        pts[f] = rng.integers(0, 256, n)
    pts["tile"] = rng.integers(1, 3, n)
    jout = jcompaction.tilefilter(jbuffers.buffer_from_numpy(pts, cap), jnp.uint32(tile))
    pout = compaction.tilefilter(port.buffer_from_numpy(pts, cap, device="cpu"), tile)
    assert port.buffer_to_numpy(pout).tobytes() == jbuffers.buffer_to_numpy(jout).tobytes()
    xyz, rgba, count = pout.to_numpy_arrays()
    np.testing.assert_array_equal(xyz.view(np.uint32), np.asarray(jout.xyz).view(np.uint32))
    np.testing.assert_array_equal(rgba, np.asarray(jout.rgba))
