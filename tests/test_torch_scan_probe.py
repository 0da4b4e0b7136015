"""Kernel 7 parity: the port's scan probe (its plain version, which CPU
tensors run) against the JAX package's ``_scan_program`` in interpret mode,
all five forms, bit-equal, on the inputs ``scan_rates`` makes, at S 64 and
at S 256: the TPU kernel sums the bf16 indicator in bf16 and the i16 count
in int16, exact only to 256.

Also the identity the kernel's total path rests on: where S * T <= 2^24
the plain version's f32 step-order accumulator equals the integer total of
the per-step counts converted once (at sel_roofline.py's S); past 2^24,
on counts that are odd, the two differ, which is why the per-step path
stays."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwipc_util_tpu_torch import CwipcError
from cwipc_util_tpu_torch.ops.scan_probe import (
    EXACT,
    FORMS,
    _mid,
    make_inputs,
    rounding_input,
    scan_plan,
    scan_program,
    scan_program_plain,
)

S, T, NTILES = 64, 4, 2
_SEL = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "sel_roofline.py"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain version runs T small ops; with a thread a core in each of
    the suite's workers they oversubscribe the machine and each op waits on
    the others (the past-2^24 case took 212 s so, 6.5 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def test_matches_pallas_scan_at_256(sel_roofline):
    """At S 256, the largest S where the TPU's bf16 and int16 sums are exact."""
    s = 256
    xs = make_inputs(s, NTILES)
    for form in FORMS:
        x = xs[form]
        want = np.asarray(sel_roofline._scan_program(_jax_input(x), form=form, interpret=True, s=s, t=T,
                                                     ntiles=NTILES))
        got = scan_program(x, form, T)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32), err_msg=form)


def _integer_total(x: torch.Tensor, form: str, t: int) -> torch.Tensor:
    """The per-step counts summed as integers, converted to f32 once."""
    cols = torch.sort(x.T.to(torch.float64 if form == "bf16" else torch.int64), dim=1).values.contiguous()
    mids = torch.tensor([float(_mid(form, i)) if form == "bf16" else _mid(form, i) for i in range(t)],
                        dtype=cols.dtype)
    counts = torch.searchsorted(cols, mids.expand(cols.shape[0], t).contiguous(), right=True)
    return counts.sum(1).to(torch.float32)


@pytest.mark.parametrize("form", ["i32", "i16", "bf16", "mxu"])
def test_total_equals_the_integer_total_below_2_24(form):
    """At sel_roofline's S (1536) and a small T, S * T <= 2^24: the f32
    step-order accumulator is the integer total, so one register total a
    thread gives the plain version's bits."""
    s, t, ntiles = 1536, 64, 1
    assert not scan_plan(s, t, ntiles * 128, form).per_step
    x = make_inputs(s, ntiles)[form]
    got = scan_program_plain(x, form, t)[0]
    want = _integer_total(x, form, t)
    assert 0 < float(want.min())
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))


def test_step_order_matters_past_2_24():
    """One tile, S 4096, T 4200 (S * T just over 2^24), the i32 thresholds:
    the make_inputs bits cut to [0, 2^20) with row 0 above every threshold,
    so every count from step 16 on is 4095, odd, and the sum passes 2^24.
    The f32 accumulator then rounds where the integer total does not: the
    plan takes the per-step path."""
    s, t = 4096, 4200
    assert s * t > EXACT and scan_plan(s, t, 128, "i32").per_step
    x = rounding_input(s)
    got = scan_program_plain(x, "i32", t)[0]
    want = _integer_total(x, "i32", t)
    assert float(want.min()) > EXACT
    assert not torch.equal(got, want)
