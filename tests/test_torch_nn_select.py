"""Kernel 5 (cross-cloud nearest neighbour over the column grid): the
port's plain version (ops/nn_select.py, what CPU tensors run) against the
JAX package's Pallas kernel in interpret mode, on planes that both
packages' ``_cols_build`` make from one seeded numpy cloud (bit-equal
planes, checked here too).

What is certified, on every occupied query slot whose ring holds a
reference point:

* the port's d2 is bit-equal to the op-by-op float32 evaluation
  ((dx*dx + dy*dy) + dz*dz), dx = c - q, of the candidate it names: the
  spec that kernel 5 on the card is held to bit for bit (chip_smoke.py);
* the JAX package's d2 is within 2 ulp of the port's: XLA on the CPU
  contracts the same sum into fma(dz, dz, fma(dx, dx, dy*dy)), three
  roundings against five, and the two forms differ by up to 2 ulp
  (measured on these scenes: JAX's value equals that FMA form exactly);
* the candidate ids are equal, except where the two candidates' d2 lie
  within 2 ulp of each other (a tie within the rounding difference).

Empty query slots, and queries with no reference point in their ring, read
(F32_MAX, INT32_MAX) in the port (its rule; the TPU kernel leaves other
values there, which its caller ignores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu.ops.cols_knn import _cols_build as jax_build
from cwipc_util_tpu.ops.pallas_nn import nn_select_pallas
from cwipc_util_tpu_torch import CwipcError
from cwipc_util_tpu_torch.ops.cols_knn import _cols_build, halo
from cwipc_util_tpu_torch.ops.nn_select import INT32_MAX, nn_select, ring_offsets

F32_MAX = np.finfo(np.float32).max


def _planes(xyz, n, cell, gy, gz, cap):
    """Both packages' planes of one cloud on the grid anchored at 0."""
    capn = 1 << int(np.ceil(np.log2(max(n, 2))))
    buf = np.zeros((capn, 3), np.float32)
    buf[:n] = xyz[:n]
    j = jax_build(jnp.asarray(buf), jnp.int32(n), jnp.float32(cell), gy=gy, gz=gz, cap=cap,
                  chunk=64, vmin_override=jnp.zeros(3, jnp.int32))
    p = _cols_build(torch.from_numpy(buf), torch.tensor(n, dtype=torch.int32), cell, gy=gy, gz=gz,
                    cap=cap, chunk=64, vmin_override=[0, 0, 0])
    for a, b in zip(j[:3], p[:3]):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32), b.numpy().view(np.uint32))
    return j, p


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _d2_of(cid, pr, pq, cols, slots, gz, cap_r):
    """Op-by-op float32 d2 between query (col, slot) and candidate ``cid``."""
    off = halo(gz)
    capp_r = -(-cap_r // 8) * 8
    offs = np.asarray(ring_offsets(gz))
    j, row = cid // capp_r, cid % capp_r
    c = [a.numpy()[off + cols + offs[j], row] for a in pr[:3]]
    q = [a.numpy()[off + cols, slots] for a in pq[:3]]
    d = [np.float32(ca - qa) for ca, qa in zip(c, q)]
    return np.float32(np.float32(np.float32(d[0] * d[0]) + np.float32(d[1] * d[1])) + np.float32(d[2] * d[2]))


def _compare(ref, nr, qry, nq, cell, gy, gz, cap_r, cap_q):
    jr, pr = _planes(ref, nr, cell, gy, gz, cap_r)
    jq, pq = _planes(qry, nq, cell, gy, gz, cap_q)
    jd2, jcid = nn_select_pallas(*jr[:3], *jq[:3], gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q, interpret=True)
    jd2, jcid = np.asarray(jd2), np.asarray(jcid)
    before = nn_select.launches
    d2, cid = nn_select(*pr[:3], *pq[:3], gy=gy, gz=gz, cap_r=cap_r, cap_q=cap_q)
    assert nn_select.launches == before  # CPU tensors run the plain version
    d2, cid = d2.numpy(), cid.numpy()
    assert d2.shape == cid.shape == (gy * gz, cap_q)
    off = halo(gz)
    occ = pq[0].numpy()[off:off + gy * gz] < F32_MAX / 2
    hit = cid != INT32_MAX
    # the port's rule on empty query slots; an occupied slot reads
    # (F32_MAX, INT32_MAX) exactly when it found nothing
    assert (d2[~occ] == F32_MAX).all() and (cid[~occ] == INT32_MAX).all()
    assert ((d2 == F32_MAX) == ~hit).all()
    sel = occ & hit
    cols, slots = np.nonzero(sel)
    own = _d2_of(cid[sel], pr, pq, cols, slots, gz, cap_r)
    np.testing.assert_array_equal(own.view(np.uint32), d2[sel].view(np.uint32))
    assert _ulps(jd2[sel], d2[sel]).max(initial=0) <= 2
    diff = jcid[sel] != cid[sel]
    if diff.any():
        theirs = _d2_of(jcid[sel][diff], pr, pq, cols[diff], slots[diff], gz, cap_r)
        assert _ulps(theirs, d2[sel][diff]).max() <= 2, "ids differ beyond a rounding tie"
    return sel.sum(), occ.sum(), pr


def test_matches_jax_kernel():
    """TestNNKernel's scene (tests/test_pallas.py:627): cap_r 12, not a
    multiple of 8, and cap_q 8."""
    rng = np.random.default_rng(7)
    ref = (rng.random((800, 3), dtype=np.float32) * 0.3 + 0.05).astype(np.float32)
    qry = (rng.random((500, 3), dtype=np.float32) * 0.3 + 0.05).astype(np.float32)
    n_sel, n_occ, _ = _compare(ref, 800, qry, 500, 0.02, 24, 24, 12, 8)
    assert n_sel == n_occ == 500


@pytest.mark.parametrize("cap_r,cap_q", [(13, 5), (3, 16)])
def test_odd_caps_and_empty_rings(cap_r, cap_q):
    """Caps off the multiple-of-8 grid; a sparse reference, so some queries
    have empty rings and read (F32_MAX, INT32_MAX), and some reference
    columns overflow a cap of 3."""
    rng = np.random.default_rng(cap_r)
    ref = (rng.random((150, 3), dtype=np.float32) * 0.25 + 0.05).astype(np.float32)
    ref[:40, 1:] = ref[0, 1:]  # one column well past any cap
    qry = (rng.random((400, 3), dtype=np.float32) * 0.6).astype(np.float32)
    n_sel, n_occ, _ = _compare(ref, 150, qry, 400, 0.02, 32, 32, cap_r, cap_q)
    assert 0 < n_sel < n_occ


def test_cap_128():
    """The top of nn_grid_params' cap ladder, with full columns on both
    sides (one reference column piles up past 128 points)."""
    rng = np.random.default_rng(128)
    ref = (rng.random((6000, 3), dtype=np.float32) * [0.3, 0.08, 0.08]).astype(np.float32)
    ref[:300, 1:] = np.float32([0.03, 0.03])
    qry = (rng.random((3000, 3), dtype=np.float32) * [0.3, 0.08, 0.08]).astype(np.float32)
    n_sel, n_occ, pr = _compare(ref, 6000, qry, 3000, 0.02, 8, 8, 128, 128)
    assert (pr[0].numpy() < F32_MAX / 2).sum(1).max() == 128
    assert n_sel == n_occ


def test_wrapper_checks_arguments():
    """Wrong dtype, shape, plane height or cap raise; a device with no
    kernel raises rather than running the plain version."""
    gy = gz = 8
    rows = gy * gz + 2 * halo(gz)
    r = torch.full((rows, 8), F32_MAX)
    q = torch.full((rows, 4), F32_MAX)
    d2, cid = nn_select(r, r, r, q, q, q, gy=gy, gz=gz, cap_r=8, cap_q=4)
    assert (d2 == F32_MAX).all() and (cid == INT32_MAX).all()
    with pytest.raises(CwipcError, match="dtype"):
        nn_select(r.double(), r, r, q, q, q, gy=gy, gz=gz, cap_r=8, cap_q=4)
    with pytest.raises(CwipcError, match="shape"):
        nn_select(r, r, r, q, q, q, gy=gy, gz=gz, cap_r=8, cap_q=8)
    with pytest.raises(CwipcError, match="rows"):
        nn_select(r[:-1], r[:-1], r[:-1], q, q, q, gy=gy, gz=gz, cap_r=8, cap_q=4)
    big = torch.full((rows, 1025), F32_MAX)
    with pytest.raises(CwipcError, match="caps"):
        nn_select(r, r, r, big, big, big, gy=gy, gz=gz, cap_r=8, cap_q=1025)
    meta = torch.empty((rows, 8), device="meta")
    mq = torch.empty((rows, 4), device="meta")
    with pytest.raises(CwipcError, match="no kernel"):
        nn_select(meta, meta, meta, mq, mq, mq, gy=gy, gz=gz, cap_r=8, cap_q=4)
