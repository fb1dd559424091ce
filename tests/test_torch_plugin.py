"""The minimal-plugin route of the port on the CPU, against the JAX
package: the uncached integrands (`msm_integrals`, `garch_integrals` and
their one-day forms), the ragged-column helpers
(`copula_density_from_transformed`, `halfspace_mask_cols`,
`halfspace_frac_cols`) and `BOX_MAX` at rtol 1e-12 on numpy inputs from a
seed; `norm_logpdf` and `t_pdf` at rtol 1e-12; and an adapter holding
only JAX's minimal contract (`fit`, `marginals_densities`,
`integration_inputs`, `integrals`), wrapping the GARCH family and
registered in both packages, served on a 16-day flagship cut at
num_points 40: VaR and levels equal within 1e-9 and to the JAX-written
record (`data/wide_grid_var.npz`, `plugin_garch_*`), `verbose` printing
the host bisection, and portfolios, grids and refine_root raising in
both packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu import backtest as jbt
from copula_var_tpu.data import from_csv as jax_from_csv
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops import special as jspecial
from copula_var_tpu.ops.grids import garch_grid, msm_grid
from copula_var_tpu.utils.artifacts import load_artifacts as jax_load
from copula_var_tpu_torch import backtest as tbt
from copula_var_tpu_torch.copulas import student as tstudent
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.ops import quadrature as tq
from copula_var_tpu_torch.ops import special as tspecial
from copula_var_tpu_torch.utils.artifacts import load_artifacts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
N_IN = 1135
RTOL = 1e-12
ATOL_VAR = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
CORR = {2: np.array([[1.0, 0.55], [0.55, 1.0]]),
        3: np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35],
                     [0.25, 0.35, 1.0]])}
WEIGHTS = {2: np.array([0.6, 0.4]), 3: np.array([0.5, 0.3, 0.2])}


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _specs(kind, dim):
    corr = CORR[dim]
    if kind == "gaussian":
        return (jq.CopulaSpec("gaussian", (jnp.asarray(corr),)),
                tq.CopulaSpec("gaussian", (_t(corr),)))
    if kind == "student":
        return (jq.CopulaSpec("student", (6.5, jnp.asarray(corr))),
                tq.CopulaSpec("student", (6.5, _t(corr))))
    return (jq.CopulaSpec("plackett", (3.2,)),
            tq.CopulaSpec("plackett", (3.2,)))


def _inputs(dim, n=14, T=5, q=3, seed=7):
    rng = np.random.default_rng(seed)
    x, dx = msm_grid(n)
    vols = np.sort(rng.uniform(0.5, 2.0, (dim, q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    lo = rng.uniform(-6.0, -0.5, T)
    return dict(
        x=x, dx=dx, vols=vols, dens=dens,
        fbs=rng.dirichlet(np.ones(q), size=(T, dim)),
        fc=rng.dirichlet(np.ones(q ** dim), size=T),
        fv=rng.uniform(0.6, 1.8, (T, dim)),
        bounds=np.stack([lo, lo + rng.uniform(0.3, 4.0, T)], -1))


CASES = [(2, "gaussian"), (2, "student"), (2, "plackett"), (3, "student"),
         (3, "gaussian")]


@pytest.mark.parametrize("dim, kind", CASES)
def test_msm_integrals_match_jax(dim, kind):
    a = _inputs(dim)
    jspec, tspec = _specs(kind, dim)
    w = WEIGHTS[dim]
    want = np.asarray(jq.msm_integrals(
        jnp.asarray(a["bounds"]), a["fbs"], a["fc"], a["x"], a["dx"],
        a["dens"], a["vols"], jnp.asarray(w), jspec))
    got = tq.msm_integrals(_t(a["bounds"]), _t(a["fbs"]), _t(a["fc"]),
                           _t(a["x"]), _t(a["dx"]), _t(a["dens"]),
                           _t(a["vols"]), _t(w), tspec)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    day = tq.msm_integral_day(_t(a["bounds"][2]), _t(a["fbs"][2]),
                              _t(a["fc"][2]), _t(a["x"]), _t(a["dx"]),
                              _t(a["dens"]), _t(a["vols"]), _t(w), tspec)
    want_day = float(jq.msm_integral_day(
        jnp.asarray(a["bounds"][2]), a["fbs"][2], a["fc"][2], a["x"],
        a["dx"], a["dens"], a["vols"], jnp.asarray(w), jspec))
    np.testing.assert_allclose(float(day), want_day, rtol=RTOL)


@pytest.mark.parametrize("dim, kind", CASES)
def test_garch_integrals_match_jax(dim, kind):
    a = _inputs(dim)
    x, dx = garch_grid(14)
    jspec, tspec = _specs(kind, dim)
    w = WEIGHTS[dim]
    want = np.asarray(jq.garch_integrals(
        jnp.asarray(a["bounds"]), a["fv"], x, dx, jnp.asarray(w), jspec))
    got = tq.garch_integrals(_t(a["bounds"]), _t(a["fv"]), _t(x), _t(dx),
                             _t(w), tspec)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    day = tq.garch_integral_day(_t(a["bounds"][4]), _t(a["fv"][4]), _t(x),
                                _t(dx), _t(w), tspec)
    want_day = float(jq.garch_integral_day(
        jnp.asarray(a["bounds"][4]), a["fv"][4], x, dx, jnp.asarray(w),
        jspec))
    np.testing.assert_allclose(float(day), want_day, rtol=RTOL)


@pytest.mark.parametrize("dim, kind", CASES)
def test_copula_density_from_transformed_matches_jax(dim, kind):
    rng = np.random.default_rng(3)
    u = rng.uniform(0.01, 0.99, (dim, 11))
    jspec, tspec = _specs(kind, dim)
    want = np.asarray(jq.copula_density_from_transformed(
        jq.transform_u_columns(u, jspec), jspec))
    got = tq.copula_density_from_transformed(
        tq.transform_u_columns(_t(u), tspec), tspec)
    assert got.shape == (11,) * dim
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


def _ragged(dim, seed=4):
    """Per-axis coordinate vectors of different lengths (a chunk of the
    outermost axis, as JAX's grid engine passes them)."""
    rng = np.random.default_rng(seed)
    x, _ = msm_grid(13)
    cols = [x[2:9]] + [x] * (dim - 1)
    return cols, rng


@pytest.mark.parametrize("dim", [2, 3])
def test_halfspace_mask_cols_matches_jax(dim):
    cols, rng = _ragged(dim)
    w = WEIGHTS[dim]
    for lo, up in ((-2.0, 1.5), (-9.0, -1.0), (0.3, 0.2)):
        want = np.asarray(jq.halfspace_mask_cols(
            [jnp.asarray(c) for c in cols], lo, up, jnp.asarray(w)))
        got = tq.halfspace_mask_cols([_t(c) for c in cols], lo, up, _t(w))
        assert got.shape == tuple(len(c) for c in cols)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [2, 3])
def test_halfspace_frac_cols_matches_jax(dim):
    cols, _ = _ragged(dim)
    tw = np.asarray(jq.trap_weights(cols[-1]))
    w = WEIGHTS[dim]
    for lo, up in ((-2.0, 1.5), (-9.0, -1.0), (-0.41, 2.77)):
        want = np.asarray(jq.halfspace_frac_cols(
            [jnp.asarray(c) for c in cols], jnp.asarray(tw), lo, up,
            jnp.asarray(w)))
        got = tq.halfspace_frac_cols([_t(c) for c in cols], _t(tw), lo, up,
                                     _t(w))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


def test_box_bounds_match_jax():
    assert (tq.BOX_MIN, tq.BOX_MAX) == (jq.BOX_MIN, jq.BOX_MAX)


def test_norm_logpdf_and_t_pdf_match_jax():
    x = np.linspace(-30.0, 30.0, 241)
    for mean, std in ((0.0, 1.0), (0.3, 2.5)):
        np.testing.assert_allclose(
            tspecial.norm_logpdf(_t(x), mean, std).numpy(),
            np.asarray(jspecial.norm_logpdf(x, mean, std)), rtol=RTOL)
    for nu in (2.5, 6.5, 40.0):
        want = np.asarray(jspecial.t_pdf(x, nu))
        np.testing.assert_allclose(tspecial.t_pdf(_t(x), nu).numpy(), want,
                                   rtol=RTOL, atol=0)
    assert tstudent.t_pdf is tspecial.t_pdf  # re-exported, not copied


# -- a plugin adapter with JAX's minimal contract ------------------------------


class JaxMinimalGarch:
    """JAX's minimal contract over the GARCH family."""

    name = "test_minimal_garch"

    def __init__(self, **kw):
        self._inner = jbt.GarchAdapter(**kw)

    def fit(self, in_sample):
        return self._inner.fit(in_sample)

    def marginals_densities(self, in_sample, fits):
        return self._inner.marginals_densities(in_sample, fits)

    def integration_inputs(self, windows, fits, num_points, box=(-5.0, 5.0)):
        return self._inner.integration_inputs(windows, fits, num_points, box)

    def integrals(self, bounds, inputs, spec, weights, box_min=-5.0):
        return self._inner.integrals(bounds, inputs, spec, weights, box_min)


class TorchMinimalGarch:
    """The same contract in the port (its methods take `device`)."""

    name = "test_minimal_garch"

    def __init__(self, **kw):
        self._inner = tbt.GarchAdapter(**kw)

    def fit(self, in_sample, device="cuda", timings=None):
        return self._inner.fit(in_sample, device=device)

    def marginals_densities(self, in_sample, fits, device="cuda"):
        return self._inner.marginals_densities(in_sample, fits, device=device)

    def integration_inputs(self, windows, fits, num_points, box=(-5.0, 5.0),
                           device="cuda"):
        return self._inner.integration_inputs(windows, fits, num_points, box,
                                              device=device)

    def integrals(self, bounds, inputs, spec, weights, box_min=-5.0):
        return self._inner.integrals(bounds, inputs, spec, weights, box_min)


@pytest.fixture(scope="module")
def plugin():
    """(JAX backtest, port backtest, record) of the minimal adapter on the
    record's flagship cut, from the GARCH artifact's fits."""
    rec = np.load(os.path.join(DATA, "wide_grid_var.npz"))
    days, n = int(rec["plugin_days"]), int(rec["plugin_points"])
    path = os.path.join(DATA, "flagship_artifacts_garch.npz")
    jfull = jax_from_csv(os.path.join(DATA, "flagship.csv"), N_IN)
    tfull = from_csv(os.path.join(DATA, "flagship.csv"), N_IN)
    jbase, tbase = jax_load(path, jfull), load_artifacts(path, tfull,
                                                         device="cpu")
    jbt.register_adapter(JaxMinimalGarch.name, JaxMinimalGarch)
    tbt.register_adapter(TorchMinimalGarch.name, TorchMinimalGarch)
    jb = jbt.create_var_backtest(
        jax_from_returns(jfull.returns[:N_IN + days], jfull.tickers, N_IN),
        JaxMinimalGarch.name, "student", num_points=n,
        model_fits_override=jbase.model_fits,
        copula_fit_override=jbase.copula_fit)
    tb = tbt.create_var_backtest(
        from_returns(tfull.returns[:N_IN + days], tfull.tickers, N_IN),
        TorchMinimalGarch.name, "student", num_points=n,
        model_fits_override=tbase.model_fits,
        copula_fit_override=tbase.copula_fit, device="cpu")
    return jb, tb, rec


def test_minimal_adapter_takes_the_host_route(plugin):
    jb, tb, _ = plugin
    assert jb._cached_integral_fn() is None
    assert tb.plugin
    with pytest.raises(ValueError, match="no cached path"):
        tb.sweep_operands()
    bounds = np.stack([np.full(16, -3.0), np.full(16, -1.0)], -1)
    np.testing.assert_allclose(tb.compute_integral(bounds),
                               jb.compute_integral(bounds), rtol=RTOL)


def test_minimal_adapter_var_matches_jax(plugin, capsys):
    jb, tb, rec = plugin
    got = tb.calc_var(0.05, verbose=True)
    printed = capsys.readouterr().out
    want = np.asarray(jb.calc_var(0.05, verbose=True))
    assert printed == capsys.readouterr().out  # the same halvings printed
    assert printed.startswith("bisection iter 1: gap ")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VAR)
    np.testing.assert_allclose(got, rec["plugin_garch_var"], rtol=0,
                               atol=ATOL_VAR)


def test_minimal_adapter_levels_match_jax(plugin):
    jb, tb, rec = plugin
    levels = tuple(rec["plugin_levels"])
    got = tb.calc_var_levels(levels)
    np.testing.assert_allclose(got, np.asarray(jb.calc_var_levels(levels)),
                               rtol=0, atol=ATOL_VAR)
    np.testing.assert_allclose(got, rec["plugin_garch_levels"], rtol=0,
                               atol=ATOL_VAR)


@pytest.mark.parametrize("query", ["portfolios", "grid", "refine"])
def test_minimal_adapter_refuses_what_jax_refuses(plugin, query):
    jb, tb, _ = plugin
    for bt in (jb, tb):
        with pytest.raises(ValueError):
            if query == "portfolios":
                bt.calc_var_portfolios([[0.5, 0.5], [0.3, 0.7]], 0.05)
            elif query == "grid":
                bt.calc_var_grid([[0.5, 0.5]], [0.05])
            else:
                bt.refine_root = True
                try:
                    bt.calc_var(0.05)
                finally:
                    bt.refine_root = False
