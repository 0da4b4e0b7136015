"""Kernel 2 parity: the port's window kNN (its plain version, which CPU
tensors run) against the JAX package's XLA spec and its Pallas kernel in
interpret mode.

Tolerances: against the XLA spec rtol 1e-6 (same candidates and rounding
of d², only the order of the final sum may differ); against the TPU
kernel rtol 5e-6, because that kernel truncates 6 mantissa bits of d²
(<= 2^-18 relative on a distance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu.ops import outliers as joutliers
from cwipc_util_tpu.ops.pallas_window_knn import window_knn_mean_distance_cm as jax_kernel
from cwipc_util_tpu_torch.ops.window_knn import (
    window_knn_mean_distance_cm,
    window_knn_mean_distance_plain,
)


def _cloud(cap, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.random((cap, 3), dtype=np.float32), axis=0)


def _port(xyz, count, k, window):
    x, y, z = (torch.from_numpy(np.ascontiguousarray(xyz[:, a])) for a in range(3))
    c = torch.tensor(count, dtype=torch.int32)
    md = window_knn_mean_distance_cm(x, y, z, c, k, window)
    assert torch.equal(md, window_knn_mean_distance_plain(x, y, z, c, k, window))
    return md.numpy()


@pytest.mark.parametrize("window,count", [(16, 4000), (32, 4000), (16, 100), (32, 0)])
def test_matches_xla_and_pallas(window, count):
    """cap 4096 with count 4000: not a multiple of the TPU kernel's block."""
    xyz = _cloud(4096, count + window)
    got = _port(xyz, count, 30, window)
    spec = np.asarray(joutliers._mean_knn_dist_window(jnp.asarray(xyz), jnp.int32(count), 30, window=window))
    np.testing.assert_allclose(got, spec, rtol=1e-6, atol=0)
    tpu = np.asarray(jax_kernel(*(jnp.asarray(xyz[:, a]) for a in range(3)), jnp.int32(count), 30, window))
    np.testing.assert_allclose(got, tpu, rtol=5e-6, atol=0)
    assert not got[count:].any()


@pytest.mark.parametrize("k,window", [(30, 16), (5, 8)])
def test_ragged_capacity_matches_xla(k, window):
    """A capacity that is not a multiple of anything, count < capacity, and
    k both at and far below 2*window."""
    xyz = _cloud(3001, k)
    got = _port(xyz, 2999, k, window)
    spec = np.asarray(joutliers._mean_knn_dist_window(jnp.asarray(xyz), jnp.int32(2999), k, window=window))
    np.testing.assert_allclose(got, spec, rtol=1e-6, atol=0)
