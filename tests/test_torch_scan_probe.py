"""Kernel 7 parity: the port's scan probe (its plain version, which CPU
tensors run) against the JAX package's ``_scan_program`` in interpret mode,
all five forms, bit-equal, on the inputs ``scan_rates`` makes.  S stays at
64: the TPU kernel sums the bf16 indicator in bf16, exact only to 256."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu_torch import CwipcError
from cwipc_util_tpu_torch.ops.scan_probe import FORMS, make_inputs, scan_program, scan_program_plain

S, T, NTILES = 64, 4, 2
_SEL = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "sel_roofline.py"


@pytest.fixture(scope="module")
def sel_roofline():
    spec = importlib.util.spec_from_file_location("sel_roofline_under_test", _SEL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(S, NTILES)


def _jax_input(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def test_inputs_match_scan_rates():
    """make_inputs draws what scan_rates draws from default_rng(0)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 30, (S, NTILES * 128), dtype=np.int32)
    floats = rng.random((S, NTILES * 128), dtype=np.float32)
    got = make_inputs(S, NTILES)
    np.testing.assert_array_equal(got["i32"].numpy(), bits)
    np.testing.assert_array_equal(got["i16"].numpy(), (bits >> 15).astype(np.int16))
    want_bf16 = np.asarray(jnp.asarray(floats, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got["bf16"].float().numpy(), want_bf16)


@pytest.mark.parametrize("form", FORMS)
def test_matches_pallas_scan(form, sel_roofline, inputs):
    x = inputs[form]
    want = np.asarray(sel_roofline._scan_program(_jax_input(x), form=form, interpret=True, s=S, t=T, ntiles=NTILES))
    got = scan_program(x, form, T)
    assert got.shape == (8, NTILES * 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert torch.equal(got, scan_program_plain(x, form, T))


def test_counts_are_nonzero_somewhere(inputs):
    """The bf16 thresholds sit inside the data: the comparison is exercised."""
    out = scan_program(inputs["bf16"], "bf16", T)
    assert 0 < float(out[0].min()) and float(out[0].max()) < S * T


def test_rejects_bad_arguments(inputs):
    with pytest.raises(CwipcError):
        scan_program(inputs["i32"], "f64", T)
    with pytest.raises(CwipcError):
        scan_program(inputs["i16"], "i32", T)  # wrong dtype for the form
    with pytest.raises(CwipcError):
        scan_program(inputs["i32"][:, :100].contiguous(), "i32", T)  # not a multiple of 128 columns
    with pytest.raises(CwipcError):
        scan_program(inputs["i32"][:, ::2], "i32", T)  # not contiguous
