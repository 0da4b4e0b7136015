"""Kernel 6 parity: the port's key+payload sort (its plain version, which
CPU tensors run) against the JAX package's bitonic Pallas kernel in
interpret mode.  Keys must be bit-equal; neither sort is bound to an order
among equal keys, so each key's multiset of payload tuples must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu.ops.pallas_sort import sort3 as jax_sort3
from cwipc_util_tpu_torch import CwipcError
from cwipc_util_tpu_torch.ops.sort_kernel import sort3, sort_by_key, sort_by_key_plain

INT32_MAX = np.iinfo(np.int32).max


def _inputs(n, seed, npay=2):
    """As TestBitonicSortKernel makes them: heavy duplicates, 10 % padding
    sentinels, here also negative keys; full-range payloads."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-(n // 16), n // 16, n).astype(np.int32)
    k[rng.random(n) < 0.1] = INT32_MAX
    pays = [rng.integers(-(2**31), 2**31, n).astype(np.int32) for _ in range(npay)]
    return k, pays


def _tuples_per_key(k, *pays):
    """Sorted structured rows (key, payloads...): equal iff every key has
    the same multiset of payload tuples."""
    dt = [("k", "<i4")] + [(f"p{i}", "<i4") for i in range(len(pays))]
    return np.sort(np.stack([k, *pays], 1).view(dt).ravel())


def _port(k, *pays):
    return [t.numpy() for t in sort_by_key(*(torch.from_numpy(a) for a in (k, *pays)))]


@pytest.mark.parametrize("n", [8192, 1 << 15])
def test_matches_pallas_sort3(n):
    k, (a, b) = _inputs(n, n)
    jk, ja, jb = map(np.asarray, jax_sort3(jnp.asarray(k), jnp.asarray(a), jnp.asarray(b), interpret=True))
    ok, oa, ob = [t.numpy() for t in sort3(*(torch.from_numpy(x) for x in (k, a, b)))]
    np.testing.assert_array_equal(ok.view(np.uint32), jk.view(np.uint32))
    assert (np.diff(ok.astype(np.int64)) >= 0).all()
    assert (_tuples_per_key(ok, oa, ob) == _tuples_per_key(jk, ja, jb)).all()
    assert (_tuples_per_key(ok, oa, ob) == _tuples_per_key(k, a, b)).all()


@pytest.mark.parametrize("npay", [0, 1, 3])
def test_payload_counts(npay):
    """0, 1 and 3 payloads; NaN bit patterns among them pass unchanged."""
    k, pays = _inputs(8192, 11 + npay, npay)
    if npay:
        pays[0][:16] = np.float32(np.nan).view(np.int32) | np.arange(16, dtype=np.int32)
    out = _port(k, *pays)
    assert len(out) == 1 + npay
    np.testing.assert_array_equal(out[0], np.sort(k))
    assert (_tuples_per_key(*out) == _tuples_per_key(k, *pays)).all()


def test_edge_keys():
    """All keys equal, already sorted, reversed, the int32 extremes."""
    n = 8192
    rng = np.random.default_rng(3)
    pay = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    cases = [
        np.full(n, 7, np.int32),
        np.arange(n, dtype=np.int32),
        np.arange(n, dtype=np.int32)[::-1].copy(),
        np.resize(np.array([np.iinfo(np.int32).min, -1, 0, 1, INT32_MAX], np.int32), n),
    ]
    for k in cases:
        ok, op = _port(k, pay)
        np.testing.assert_array_equal(ok, np.sort(k))
        assert (_tuples_per_key(ok, op) == _tuples_per_key(k, pay)).all()


def test_plain_is_the_cpu_route():
    k, (a, b) = _inputs(8192, 5)
    got = sort_by_key(*(torch.from_numpy(x) for x in (k, a, b)))
    want = sort_by_key_plain(*(torch.from_numpy(x) for x in (k, a, b)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [4096, 8192 + 4096, 3 * 8192])
def test_rejects_lengths(n):
    """A length below 8192 or not a power of two raises, as the JAX
    wrapper's assertion does."""
    k = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(CwipcError):
        sort_by_key(k, k.clone())


def test_rejects_types_and_shapes():
    k = torch.zeros(8192, dtype=torch.int32)
    with pytest.raises(CwipcError):
        sort_by_key(k.to(torch.int64))
    with pytest.raises(CwipcError):
        sort_by_key(k, torch.zeros(8192, dtype=torch.float32))
    with pytest.raises(CwipcError):
        sort_by_key(k, torch.zeros(16384, dtype=torch.int32))
    with pytest.raises(CwipcError):
        sort_by_key(k.reshape(64, 128))
