"""Port parity for the three-asset (dim-3) serving path on the CPU: the
dim-general quadrature of `copula_var_tpu_torch.ops.quadrature`, the K4
operands and plain twin (`ops/cuda_quadrature3.py`), the sweep-driven
bisection and full solve (`ops/cuda_solver.py`), and `load_artifacts` ->
`calc_var*` on the committed dim-3 artifacts, all against the JAX
package. Small sizes (n = 24, T = 10, q = 3) except the artifact test,
which runs the full n = 100 grid on 8 days."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu import backtest as jbt
from copula_var_tpu.data import from_csv as jax_from_csv
from copula_var_tpu.data import from_returns as jax_from_returns
from copula_var_tpu.ops import pallas_quadrature3 as jpq3
from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu.utils.artifacts import load_artifacts as jax_load
from copula_var_tpu_torch.backtest import VaRBacktest
from copula_var_tpu_torch.data import from_returns
from copula_var_tpu_torch.device import resolve_device
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops import quadrature as tq
from copula_var_tpu_torch.ops import solvers as tsolvers
from copula_var_tpu_torch.utils.artifacts import load_artifacts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
CSV = os.path.join(DATA, "dim3.csv")
N_IN = 1135
RTOL = 1e-12
ATOL_ROOT = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
TOL = 1e-6
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)
T, N, Q = 10, 24, 3
W3 = np.array([0.5, 0.3, 0.2])  # unequal: exposes the weights pairing
CORR3 = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35],
                  [0.25, 0.35, 1.0]])


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _specs(kind):
    if kind == "gaussian":
        return (jq.CopulaSpec("gaussian", (jnp.asarray(CORR3),)),
                tq.CopulaSpec("gaussian", (_t(CORR3),)))
    return (jq.CopulaSpec("student", (6.5, jnp.asarray(CORR3))),
            tq.CopulaSpec("student", (6.5, _t(CORR3))))


def _bounds(rng, T, L=None):
    shape = (T,) if L is None else (L, T)
    lo = rng.uniform(-8.0, -1.0, shape)
    return np.stack([lo, lo + rng.uniform(0.05, 4.0, shape)], axis=-1)


@pytest.fixture(scope="module")
def case():
    """Raw dim-3 inputs of both families, n = 24 points, q = 3 states."""
    rng = np.random.default_rng(11)
    x, dx = msm_grid(N)
    vols = np.sort(rng.uniform(0.5, 2.0, (3, Q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    fbs = rng.dirichlet(np.ones(Q), size=(T, 3))
    fc = rng.dirichlet(np.ones(Q**3), size=T)
    fv = rng.uniform(0.6, 1.8, (T, 3))
    return dict(x=x, dx=dx, vols=vols, dens=dens, fbs=fbs, fc=fc, fv=fv)


def _family(case, family, kind):
    """(port Contract3Operands, JAX kernel_id, JAX aux without weights)."""
    jspec, tspec = _specs(kind)
    x, dx = case["x"], case["dx"]
    if family == "msm":
        tcols = tq.msm_day_columns(_t(case["fbs"]), _t(x), _t(case["vols"]),
                                   tspec)
        ops = cq3.contract3_operands(tcols, _t(x), _t(dx), tspec,
                                     densities=_t(case["dens"]),
                                     forecast_combos=_t(case["fc"]))
        jcols = jq.msm_day_columns(case["fbs"], x, case["vols"], jspec)
        kid = ("msm_tcached", kind, jq._day_batch(N, 3, T))
        aux = (jcols, jnp.asarray(case["fc"]), x, dx,
               jnp.asarray(case["dens"]))
        return ops, kid, aux, jspec
    tcols, p_cols = tq.garch_day_columns(_t(case["fv"]), _t(x), tspec)
    ops = cq3.contract3_operands(tcols, _t(x), _t(dx), tspec, p_cols=p_cols)
    jcols, jp = jq.garch_day_columns(case["fv"], x, jspec)
    kid = ("garch_tcached", kind, jq._day_batch(N, 3, T))
    return ops, kid, (jcols, jp, x, dx), jspec


def _aux(kid, aux, spec, weights):
    """The JAX `_call_integral_kernel` aux tuple at these weights."""
    return aux + (jnp.asarray(weights), spec.params, -5.0)


def test_halfspace_mask_dim3_matches_jax_bitwise(rng):
    x, _ = msm_grid(20)
    b = _bounds(rng, 12)
    b[:4] = np.stack([x[2:6], x[12:16]], axis=-1)  # bounds on grid values
    for w in (W3, np.array([0.2, 0.5, 0.3]), np.array([1 / 3] * 3)):
        got = tq.halfspace_mask(_t(x), _t(b[:, 0]), _t(b[:, 1]), _t(w))
        want = np.stack([
            np.asarray(jq.halfspace_mask(x, lo, up, w)) for lo, up in b
        ])
        assert got.shape == (12, 20, 20, 20)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["gaussian", "student"])
def test_density_dim3_matches_jax_from_same_columns(rng, kind):
    """Same transform columns into both packages' density builders."""
    jspec, tspec = _specs(kind)
    u = rng.uniform(1e-9, 1 - 1e-9, (4, 3, 16))
    cols = [np.stack([np.asarray(leaf) for leaf in leaves]) for leaves in
            zip(*[jq.transform_u_columns(jnp.asarray(d), jspec) for d in u])]
    if kind == "student":
        cols[1][1, 2, 5] = False  # a non-finite column: NaN cells
    got = tq.copula_density_cols(
        tuple(torch.from_numpy(c) for c in cols), tspec).numpy()
    want = np.stack([
        np.asarray(jq.copula_density_from_transformed(
            tuple(jnp.asarray(c[d]) for c in cols), jspec))
        for d in range(4)
    ])
    assert got.shape == (4, 16, 16, 16)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["gaussian", "student"])
def test_tcached_sweeps_match_jax(case, family, kind):
    ops, _, _, jspec = _family(case, family, kind)
    b = _bounds(np.random.default_rng(5), T)
    if family == "msm":
        got = tq.msm_integrals_tcached(
            _t(b), ops.cols, ops.forecast_combos, ops.x, ops.dx,
            ops.densities, _t(W3), ops.spec, day_batch=3)
        want = jq.msm_integrals_tcached(
            b, jq.msm_day_columns(case["fbs"], case["x"], case["vols"],
                                  jspec),
            case["fc"], case["x"], case["dx"], case["dens"], W3, jspec)
    else:
        got = tq.garch_integrals_tcached(
            _t(b), ops.cols, ops.p_cols, ops.x, ops.dx, _t(W3), ops.spec)
        jcols, jp = jq.garch_day_columns(case["fv"], case["x"], jspec)
        want = jq.garch_integrals_tcached(b, jcols, jp, case["x"],
                                          case["dx"], W3, jspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)


def _operand_form(ops, bounds, weights):
    """The algebra the CUDA kernel evaluates, in PyTorch: per slab i0 the
    density from z/fin/lu (or z) with Sigma^-1 and the normalizer, times
    the pdf product with nan_to_num (GARCH), folded with
    H = W1^T G[t, i0] W2, masked and summed."""
    z, lu, fin = ops.z, ops.lu, ops.fin
    s = ops.sigma_inv
    e = [z[:, d, :].reshape((-1,) + (1,) * d + (z.shape[-1],)
                            + (1,) * (2 - d)) for d in range(3)]
    quad = s[0, 0] * e[0] ** 2 + (2 * s[0, 1]) * (e[0] * e[1]) \
        + (2 * s[0, 2]) * (e[0] * e[2]) + s[1, 1] * e[1] ** 2 \
        + (2 * s[1, 2]) * (e[1] * e[2]) + s[2, 2] * e[2] ** 2
    if ops.spec.kind == "student":
        lsum = (lu[:, 0, :, None, None] + lu[:, 1, None, :, None]) \
            + lu[:, 2, None, None, :]
        V = torch.exp(ops.log_norm - (ops.nu + 3) / 2 * torch.log1p(
            quad / ops.nu) - lsum)
        ok = fin[:, 0, :, None, None] & fin[:, 1, None, :, None] \
            & fin[:, 2, None, None, :]
        V = torch.where(ok, V, torch.full_like(V, float("nan")))
    else:
        sz = (e[0] ** 2 + e[1] ** 2) + e[2] ** 2
        V = torch.exp(-0.5 * (ops.logdet + quad - sz))
    if ops.p_cols is not None:
        p = ops.p_cols
        V = torch.nan_to_num(V * ((p[:, 0, :, None, None]
                                   * p[:, 1, None, :, None])
                                  * p[:, 2, None, None, :]))
    H = torch.einsum("bj,tibc,ck->tijk", ops.w1, ops.G, ops.w2)
    rows = []
    for b, w in zip(bounds, weights):
        M = tq.halfspace_mask(ops.x, b[:, 0], b[:, 1], w)
        U = torch.where(M, V * H, torch.zeros(()))
        rows.append(U.sum(dim=(2, 3)).sum(dim=1))
    return torch.stack(rows)


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["gaussian", "student"])
def test_operand_form_matches_plain_twin(case, family, kind):
    """G folding: the kernel's operands give the tcached sweep."""
    ops, _, _, _ = _family(case, family, kind)
    assert ops.G.shape == ((T, N, Q, Q) if family == "msm" else (T, N, 1, 1))
    rng = np.random.default_rng(2)
    b = _t(_bounds(rng, T, L=3))
    w = _t([W3, [0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    plain = cq3.masked_contract3_reference(ops, b, w)
    np.testing.assert_allclose(_operand_form(ops, b, w).numpy(),
                               plain.numpy(), rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_plain_twin_within_f32_of_pallas_interpret(case, family):
    """K4 itself, float32 in interpret mode (Gaussian copula), within
    tests/test_pallas_dim3.py's bound of the port's f64 plain twin."""
    jspec, tspec = _specs("gaussian")
    ops, _, _, _ = _family(case, family, "gaussian")
    b = _bounds(np.random.default_rng(4), T)
    x, dx = case["x"], case["dx"]
    if family == "msm":
        cache = jpq3.build_msm_dim3_cache(case["fbs"], case["fc"], x, dx,
                                          case["dens"], case["vols"], W3,
                                          jspec)
    else:
        cache = jpq3.build_garch_dim3_cache(case["fv"], x, dx, W3, jspec)
    want = np.asarray(jpq3.dim3_integrals_pallas(
        b, cache, family=family, kind="gaussian", interpret=True))
    got = cq3.masked_contract3_reference(ops, _t(b)[None], _t(W3)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=1e-8)


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("quirks", [False, True])
def test_full_solve_levels_dim3_matches_jax(case, family, quirks):
    ops, kid, aux, jspec = _family(case, family, "student")
    obj = np.array([0.01, 0.05])
    want, want_nan = jbt._device_full_solve_levels_jit(
        kid, _aux(kid, aux, jspec, W3), jnp.asarray(obj), jnp.asarray(CFG),
        TOL, T, quirks)
    got, got_nan = cs.full_solve(ops, _t(obj), _t(W3), CFG, TOL, quirks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ROOT)
    np.testing.assert_array_equal(got_nan.numpy(), np.asarray(want_nan))


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("quirks", [False, True])
def test_full_solve_portfolios_dim3_matches_jax(case, family, quirks):
    ops, kid, aux, jspec = _family(case, family, "student")
    wb = np.array([W3, [0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    obj = np.array([0.05, 0.01, 0.025])
    want, want_nan = jbt._device_full_solve_portfolios_jit(
        kid, _aux(kid, aux, jspec, W3), jnp.asarray(obj), jnp.asarray(wb),
        jnp.asarray(CFG), TOL, T, quirks)
    got, got_nan = cs.full_solve(ops, _t(obj), _t(wb), CFG, TOL, quirks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ROOT)
    np.testing.assert_array_equal(got_nan.numpy(), np.asarray(want_nan))


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_fixed_count_bisection_equals_while_loop_dim3(case, family):
    """The CUDA path's bisection (host-counted halvings, device-side
    freeze and exit gates) gives the while-loop's roots; extra halvings
    past the while-loop's exit change nothing. A row whose CDF is
    exactly zero everywhere freezes in both."""
    ops, _, _, _ = _family(case, family, "student")
    wrows = _t([W3, [0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    obj = _t([0.01, 0.05, 0.1])
    stage1 = torch.stack([torch.full((T,), -100.0, dtype=torch.float64),
                          torch.full((T,), CFG[0], dtype=torch.float64)], -1)
    F1 = cq3.masked_contract3(ops, stage1.expand(3, T, 2).contiguous(), wrows)
    state = [s.clone() for s in tsolvers.bracket_state_batched(
        F1, obj, lambda b: cq3.masked_contract3(ops, b, wrows), CFG,
        False)[:5]]
    # row 2: a bracket far below the grid, where every slab is exactly 0
    state[0][2], state[1][2] = -60.0, -50.0
    state[2][2], state[3][2] = 0.0, -60.0
    _, bisect = cs._routes(ops, False)
    plain = bisect(ops, *state, obj, wrows, TOL)
    n_iters = cs.halvings(float((state[1] - state[0]).max()), TOL)
    for extra in (0, 3):
        fixed = cs.bisect_fixed_count(
            ops, *state, obj, wrows, TOL, n_iters + extra,
            cq3.masked_contract3_reference)
        np.testing.assert_array_equal(fixed.numpy(), plain.numpy())
    assert float(plain[2, 0]) == -55.0  # frozen on its first halving


def _truncated(tmp_path, est, days):
    """The dim-3 artifact cut to its first `days` out-of-sample days, as
    written by the JAX package, and matching returns for both packages."""
    z = np.load(os.path.join(DATA, f"dim3_artifacts_{est}.npz"))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos",
              "ii_forecast_vols"):
        if k in arrays:
            arrays[k] = arrays[k][:days]
    path = str(tmp_path / f"{est}_{days}.npz")
    np.savez(path, **arrays)
    w = np.load(os.path.join(DATA, "dim3_var.npz"))["weights"]
    full = jax_from_csv(CSV, n_insample=N_IN, weights=w)
    rets = full.returns[: N_IN + days]
    return (path, jax_from_returns(rets, full.tickers, N_IN, weights=w),
            from_returns(rets, full.tickers, N_IN, weights=w))


def test_dim3_artifact_serves_like_jax(tmp_path):
    """`load_artifacts` reads the JAX package's dim-3 `.npz` as it is; on
    its first 8 days at the full n = 100 grid, calc_var, a portfolio
    batch and one sweep equal the JAX `xla` engine, and calc_var equals
    the committed record."""
    path, jdata, tdata = _truncated(tmp_path, "msm", 8)
    jb, tb = jax_load(path, jdata), load_artifacts(path, tdata, device="cpu")
    assert tb.data.dim == 3 and tb.integration_inputs.x.shape == (100,)
    var = tb.calc_var(0.05)
    np.testing.assert_allclose(var, jb.calc_var(0.05), rtol=0,
                               atol=ATOL_ROOT)
    rec = np.load(os.path.join(DATA, "dim3_var.npz"))["msm_var"][:8]
    np.testing.assert_allclose(var, rec, rtol=0, atol=ATOL_ROOT)
    wb = np.array([[0.2, 0.5, 0.3], [0.6, 0.1, 0.3]])
    got = tb.calc_var_portfolios(wb, [0.01, 0.05])
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, jb.calc_var_portfolios(wb, [0.01, 0.05]),
                               rtol=0, atol=ATOL_ROOT)
    bounds = np.stack([np.full(8, -100.0), np.full(8, -3.0)], -1)
    np.testing.assert_allclose(tb.compute_integral(bounds),
                               jb.compute_integral(bounds), rtol=1e-12)


def test_dim3_port_runs_with_jax_blocked(tmp_path):
    """The port solves at dim 3 with `jax` unimportable, and pulls in
    nothing of the JAX package."""
    path, _, _ = _truncated(tmp_path, "garch", 2)
    code = f"""
import sys
sys.modules["jax"] = None
import numpy as np
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.utils.artifacts import load_artifacts
full = from_csv({CSV!r}, n_insample={N_IN}, weights=(0.5, 0.3, 0.2))
data = from_returns(full.returns[:{N_IN + 2}], full.tickers, {N_IN},
                    weights=(0.5, 0.3, 0.2))
var = load_artifacts({path!r}, data, device="cpu").calc_var(0.05)
assert var.shape == (2,) and np.all(np.isfinite(var)), var
leaked = [m for m, mod in sys.modules.items() if mod is not None
          and m.split(".")[0] in ("jax", "jaxlib", "copula_var_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_dim3_rejections(case, tmp_path):
    """Plackett at dim 3 and 4 and the `meta` device raise; dim 4, once
    refused here, serves as JAX does."""
    path, _, tdata = _truncated(tmp_path, "garch", 2)
    bt = load_artifacts(path, tdata, device="cpu")
    args = (bt.adapter, bt.copula, bt.copula_fit, bt.model_fits,
            bt.integration_inputs)
    z = np.load(os.path.join(DATA, "dim4_artifacts_msm.npz"))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos"):
        arrays[k] = arrays[k][:2]
    path4 = str(tmp_path / "dim4_msm_2.npz")
    np.savez(path4, **arrays)
    w4 = np.load(os.path.join(DATA, "dim4_var.npz"))["weights"]
    full4 = jax_from_csv(os.path.join(DATA, "dim4.csv"), N_IN, weights=w4)
    four = from_returns(full4.returns[:N_IN + 2], full4.tickers, N_IN,
                        weights=w4)
    bt4 = load_artifacts(path4, four, device="cpu")
    got4 = VaRBacktest(four, bt4.adapter, bt4.copula, bt4.copula_fit,
                       bt4.model_fits, bt4.integration_inputs, device="cpu")
    np.testing.assert_allclose(
        got4.calc_var(0.05), jax_load(path4, jax_from_returns(
            full4.returns[:N_IN + 2], full4.tickers, N_IN,
            weights=w4)).calc_var(0.05), rtol=0, atol=ATOL_ROOT)
    for data in (tdata, four):
        with pytest.raises(ValueError, match="bivariate"):
            VaRBacktest(data, bt.adapter, "plackett", bt.copula_fit,
                        bt.model_fits, bt.integration_inputs)
    refined = VaRBacktest(tdata, *args, device="cpu", refine_root=True)
    got, plain = refined.calc_var(0.05), bt.calc_var(0.05)
    assert np.all(np.abs(got - plain) <= refined._plateau_h())
    with pytest.raises(ValueError, match="Plackett"):
        tq.copula_density_cols((_t(np.full((3, 4), 0.5)),),
                               tq.CopulaSpec("plackett", (4.0,)))
    with pytest.raises(ValueError, match="Gaussian or Student"):
        cq3.contract3_operands((_t(np.full((2, 3, 4), 0.5)),), _t(np.ones(4)),
                               _t(np.ones(4)),
                               tq.CopulaSpec("plackett", (4.0,)))
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    ops, _, _, _ = _family(case, "garch", "gaussian")
    meta = cq3.Contract3Operands(*[
        t.to("meta") if torch.is_tensor(t) else t for t in ops
    ])
    b = torch.zeros((1, T, 2), dtype=torch.float64, device="meta")
    w = torch.zeros((1, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cq3.masked_contract3(meta, b, w)
    with pytest.raises(ValueError, match="unsupported device"):
        cs.full_solve(meta, w[:, 0], w, CFG, TOL)


def test_cpu_tensors_take_the_plain_twin(case, tmp_path):
    ops, _, _, _ = _family(case, "msm", "student")
    b = _t(_bounds(np.random.default_rng(8), T, L=2))
    w = _t([W3, [0.2, 0.5, 0.3]])
    before = cq.launch_count(cq3.masked_contract3)
    got = cq3.masked_contract3(ops, b, w)
    np.testing.assert_array_equal(
        got.numpy(), cq3.masked_contract3_reference(ops, b, w).numpy())
    path, _, tdata = _truncated(tmp_path, "garch", 2)
    load_artifacts(path, tdata, device="cpu").calc_var(0.05)
    assert cq.launch_count(cq3.masked_contract3) == before


def test_day_batch_matches_jax_budget():
    for n, dim, T_ in ((100, 3, 500), (24, 3, 10), (100, 2, 500)):
        assert tq._day_batch(n, dim, T_) == jq._day_batch(n, dim, T_)
        assert tq._device_day_batch(n, dim, T_, "cpu") == \
            jq._day_batch(n, dim, T_)
    assert tq._device_day_batch(100, 3, 500, "cuda") == 67
    with pytest.raises(ValueError, match="transient budget"):
        tq._day_batch(100, 4, 10)
