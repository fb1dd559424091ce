"""Port parity for `copula_var_tpu_torch.copulas.student_sampler` on the
CPU against `copula_var_tpu.copulas.student_sampler`: the numpy pieces
(approximate t-cdf, its bisection inverse, the copula value) bit for bit,
the fixture's densities (exact t-cdf -> norm_ppf -> norm_pdf through the
port's `ops/special.py`) at rtol 1e-12, and the default fixture against
the JAX-written copy in `data/flagship_quirk_fits.npz`."""

import os

import numpy as np
import pytest
import torch

from copula_var_tpu.copulas import student_sampler as jss
from copula_var_tpu_torch.copulas import student_sampler as tss

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
RTOL = 1e-12


@pytest.mark.parametrize("nu", [1, 3, 5, 10])
def test_approx_t_cdf_bitwise(nu):
    xs = np.linspace(-8, 8, 41)
    np.testing.assert_array_equal(tss.approx_t_cdf(xs, nu),
                                  jss.approx_t_cdf(xs, nu))
    with pytest.raises(ValueError, match="positive"):
        tss.approx_t_cdf(xs, 0)


def test_inverse_and_copula_value_bitwise(rng):
    """Including the return-0 branch: u outside the approximate cdf's
    range on [-1000, 1000] has no sign change."""
    u = np.concatenate([rng.uniform(0.001, 0.999, 200), [0.0, 1.0, 1.5]])
    for nu in (3, 5):
        got = tss.inverse_approx_t_cdf(u, nu)
        np.testing.assert_array_equal(got, jss.inverse_approx_t_cdf(u, nu))
    assert np.all(tss.inverse_approx_t_cdf(np.array([1.5]), 5) == 0.0)
    u2 = rng.uniform(0.05, 0.95, (50, 2))
    np.testing.assert_array_equal(
        tss.t_copula_value(u2[:, 0], u2[:, 1], 0.5, 5),
        jss.t_copula_value(u2[:, 0], u2[:, 1], 0.5, 5))


def test_fixture_matches_jax():
    """n = 20000, top 200: the same pairs bit for bit, the densities at
    rtol 1e-12."""
    got_m, got_d = tss.generate_student_t_copula_data(
        n=20000, top_n=200, device="cpu")
    want_m, want_d = jss.generate_student_t_copula_data(n=20000, top_n=200)
    assert got_m.shape == got_d.shape == (200, 2)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=RTOL)


def test_default_fixture_matches_the_jax_written_copy():
    """The default fixture equals the JAX-written copy on this machine,
    and its density step alone equals the copy's densities from the
    copy's own pairs (the check that holds on any numpy build: every
    default copula value ties, see the module docstring)."""
    rec = np.load(os.path.join(DATA, "flagship_quirk_fits.npz"))
    np.random.seed(42)
    pairs = np.random.rand(100000, 2)
    vals = tss.t_copula_value(pairs[:, 0], pairs[:, 1], 0.5, 5)
    assert np.all(vals == 1.0)
    m, d = tss.generate_student_t_copula_data(device="cpu")
    np.testing.assert_array_equal(m, rec["student_marginals"])
    np.testing.assert_allclose(d, rec["student_densities"], rtol=RTOL)
    np.testing.assert_allclose(
        tss.fixture_densities(rec["student_marginals"], 5, device="cpu"),
        rec["student_densities"], rtol=RTOL)


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tss.generate_student_t_copula_data(n=100, top_n=5)
