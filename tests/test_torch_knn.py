"""Cross-cloud nearest-neighbour parity: the port's ops/knn.py against the
JAX package's, on seeded numpy clouds handed to both.

* ``_cols_build``'s slot -> point map (``slot_orig``) is bit-equal, also
  on clouds with many points per column and cell (both sorts are stable).
* ``nn_search`` (two-scale): the same hit set; distances allclose (rtol
  1e-6: the d2 sums round in another order); indices equal wherever the
  nearest distance is not tied within that tolerance.
* ``bruteforce_nn_subset``: the same, zero work off the selection.
* ``nn_grid_query`` + fixup and ``_nn_grid_full`` against the JAX grid
  query with its Pallas kernel in interpret mode, on the scene of
  tests/test_pallas.py:687 (out-of-grid queries, an overflowing column):
  ``need_fix`` equal, distances and indices as for ``nn_search``.
* ``nn_grid_params``: the same (perm, gy, gz, cap_r, cap_q, origin) on the
  TestGridParams scenes (tests/test_pallas.py:758) and on each aligner
  pair of a 3-camera scene.
* ``nn_search_host_auto`` on CPU tensors is the two-scale search.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu.ops import knn as jknn
from cwipc_util_tpu.ops.cols_knn import _cols_build as jax_build
from cwipc_util_tpu_torch.ops import knn
from cwipc_util_tpu_torch.ops.cols_knn import _cols_build
from cwipc_util_tpu_torch.ops.nn_select import nn_select


def _i32(n):
    return torch.tensor(n, dtype=torch.int32)


def _assert_nn_equal(pd, pi, jd, ji, ref, qry, rtol=1e-6):
    """Same hits, distances within rtol, indices equal unless tied."""
    pd, pi, jd, ji = (np.asarray(a) for a in (pd, pi, jd, ji))
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(jd))
    hit = np.isfinite(pd)
    np.testing.assert_allclose(pd[hit], jd[hit], rtol=rtol, atol=0)
    np.testing.assert_array_equal(pi[~hit], -1)
    np.testing.assert_array_equal(ji[~hit], -1)
    diff = hit & (pi != ji)
    # a differing index must name a point at the same distance (a tie)
    dp = np.sqrt(((ref[pi[diff]] - qry[diff]) ** 2).sum(1))
    dj = np.sqrt(((ref[ji[diff]] - qry[diff]) ** 2).sum(1))
    np.testing.assert_allclose(dp, dj, rtol=2e-6)
    assert diff.sum() <= max(2, hit.sum() // 100)
    return hit.sum()


def _scene():
    """tests/test_pallas.py:699-713: a dense clump (overflowing columns)
    and queries partly outside the grid."""
    rng = np.random.default_rng(13)
    nr, nq, rcap, scap = 3000, 2000, 4096, 2048
    ref = np.zeros((rcap, 3), np.float32)
    qry = np.zeros((scap, 3), np.float32)
    ref[:nr] = rng.random((nr, 3), dtype=np.float32) * 0.4
    ref[100:200] = ref[100] + rng.random((100, 3), np.float32) * 0.001
    qry[:nq] = rng.random((nq, 3), dtype=np.float32) * 0.5 - 0.02
    maxd = np.float32(0.03)
    cell = np.float32(maxd / 3.5)
    core = ref[:nr]
    vmin = np.floor(core.min(axis=0) / cell).astype(np.int32)
    ext = np.floor(core.max(axis=0) / cell).astype(np.int32) - vmin + 1
    gy, gz = int(ext[1]) + 2, int(ext[2]) + 2
    return ref, nr, qry, nq, maxd, cell, vmin, gy, gz


def test_slot_orig_bit_equal():
    """Many points per column and per x-cell: equal sort keys, so the
    slot order rests on both sorts being stable."""
    rng = np.random.default_rng(4)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[:3000] = rng.random((3000, 3), dtype=np.float32) * 0.2
    xyz[:200] = xyz[0] + rng.random((200, 3), dtype=np.float32) * 0.001
    geo = dict(gy=16, gz=16, cap=40, chunk=64)
    j = jax_build(jnp.asarray(xyz), jnp.int32(3000), jnp.float32(0.02), **geo)
    p = _cols_build(torch.from_numpy(xyz), _i32(3000), 0.02, **geo)
    np.testing.assert_array_equal(np.asarray(j[3]), p[3].numpy())
    assert p[5].any() and (p[3].numpy() >= 0).sum() < 3000  # columns overflowed
    assert _cols_build(torch.from_numpy(xyz), _i32(3000), 0.02, want_orig=False, **geo)[3] is None


def test_nn_search_matches_jax():
    ref, nr, qry, nq, maxd, *_ = _scene()
    jd, ji = jknn.nn_search(jnp.asarray(qry), jnp.int32(nq), jnp.asarray(ref), jnp.int32(nr), jnp.float32(maxd))
    pd, pi = knn.nn_search(torch.from_numpy(qry), _i32(nq), torch.from_numpy(ref), _i32(nr), float(maxd))
    assert pd.shape == (qry.shape[0],) and pi.dtype == torch.int32
    assert _assert_nn_equal(pd, pi, jd, ji, ref, qry) > 1000
    assert not np.isfinite(pd.numpy()[nq:]).any()
    # on CPU tensors the dispatcher takes the two-scale search
    ad, ai = knn.nn_search_host_auto(torch.from_numpy(qry), _i32(nq), torch.from_numpy(ref), _i32(nr), float(maxd))
    assert torch.equal(ad, pd) and torch.equal(ai, pi)


def test_bruteforce_subset_matches_jax():
    ref, nr, qry, nq, maxd, *_ = _scene()
    sel = np.random.default_rng(2).random(qry.shape[0]) < 0.2  # some past the count
    jd, ji = jknn.bruteforce_nn_subset(jnp.asarray(qry), jnp.int32(nq), jnp.asarray(sel),
                                       jnp.asarray(ref), jnp.int32(nr), jnp.float32(maxd))
    pd, pi = knn.bruteforce_nn_subset(torch.from_numpy(qry), _i32(nq), torch.from_numpy(sel),
                                      torch.from_numpy(ref), _i32(nr), float(maxd))
    on = sel & (np.arange(qry.shape[0]) < nq)
    assert _assert_nn_equal(pd, pi, jd, ji, ref, qry) > 200
    assert not np.isfinite(pd.numpy()[~on]).any() and (pi.numpy()[~on] == -1).all()


def test_grid_query_matches_jax():
    ref, nr, qry, nq, maxd, cell, vmin, gy, gz = _scene()
    geo = dict(gy=gy, gz=gz, cap_r=40, cap_q=40)
    jprep = jknn.nn_grid_prepare(jnp.asarray(ref), jnp.int32(nr), jnp.float32(cell), gy=gy, gz=gz,
                                 cap=40, vmin=jnp.asarray(vmin))
    jd, ji, jfix = jknn.nn_grid_query(jnp.asarray(qry), jnp.int32(nq), jprep, jnp.float32(cell),
                                      jnp.float32(maxd), vmin=jnp.asarray(vmin), interpret=True, **geo)
    pprep = knn.nn_grid_prepare(torch.from_numpy(ref), _i32(nr), float(cell), gy=gy, gz=gz, cap=40, vmin=vmin)
    before = nn_select.launches
    pd, pi, pfix = knn.nn_grid_query(torch.from_numpy(qry), _i32(nq), pprep, float(cell), float(maxd),
                                     vmin=vmin, **geo)
    assert nn_select.launches == before
    np.testing.assert_array_equal(pfix.numpy(), np.asarray(jfix))
    fix = pfix.numpy()
    assert 0 < fix.sum() < nq
    assert _assert_nn_equal(pd.numpy()[~fix], pi.numpy()[~fix], np.asarray(jd)[~fix], np.asarray(ji)[~fix],
                            ref, qry[~fix]) > 500
    # with the fixup, against the JAX grid + fixup and the port's one-shot
    fd, fi = knn.bruteforce_nn_subset(torch.from_numpy(qry), _i32(nq), pfix, torch.from_numpy(ref), _i32(nr),
                                      float(maxd))
    jfd, jfi = jknn.bruteforce_nn_subset(jnp.asarray(qry), jnp.int32(nq), jfix, jnp.asarray(ref),
                                         jnp.int32(nr), jnp.float32(maxd))
    pd_all = torch.where(pfix, fd, pd)
    pi_all = torch.where(pfix, fi, pi)
    jd_all = np.where(fix, np.asarray(jfd), np.asarray(jd))
    ji_all = np.where(fix, np.asarray(jfi), np.asarray(ji))
    _assert_nn_equal(pd_all, pi_all, jd_all, ji_all, ref, qry)
    od, oi = knn._nn_grid_full(torch.from_numpy(qry), _i32(nq), torch.from_numpy(ref), _i32(nr), float(maxd),
                               vmin, perm=(0, 1, 2), **geo)
    assert torch.equal(od, pd_all) and torch.equal(oi, pi_all)


def _dense_scene(rng, n):
    """TestGridParams._dense_scene (tests/test_pallas.py:768)."""
    pts = rng.random((n, 3), dtype=np.float32)
    pts[:, 0] = pts[:, 0] * 0.6
    pts[:, 1] = pts[:, 1] * 1.9
    pts[:, 2] = pts[:, 2] * 0.6
    nb = n // 3
    pts[:nb] = np.float32([0.3, 1.0, 0.3]) + rng.random((nb, 3), dtype=np.float32) * 0.1
    return pts


def _grid_scenes():
    rng = np.random.default_rng(5)
    yield _dense_scene(rng, 10000), _dense_scene(rng, 20000), 0.14, {}
    rng = np.random.default_rng(6)
    slab = rng.random((30000, 3), dtype=np.float32)
    slab[:, :2] *= 1.2
    slab[:, 2] *= 0.02
    yield slab[:10000], slab[10000:], 0.07, {}
    ball = (np.random.default_rng(8).random((50000, 3), dtype=np.float32) * 0.01).astype(np.float32)
    yield ball[:25000], ball[25000:], 0.1, {"fallback_budget": 1e6}


@pytest.mark.parametrize("case", range(3))
def test_grid_params_same_tuple(case):
    src, ref, maxd, kw = list(_grid_scenes())[case]
    a, b = jknn.nn_grid_params(src, ref, maxd, **kw), knn.nn_grid_params(src, ref, maxd, **kw)
    if a is None:
        assert b is None and case == 2
        return
    assert a[:5] == b[:5]
    np.testing.assert_array_equal(a[5], b[5])
