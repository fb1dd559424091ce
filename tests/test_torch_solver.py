"""Port parity: the bracketing stage, the bisection and the full
three-stage solve (`copula_var_tpu_torch.ops.solvers`, `.cuda_solver`)
against the JAX package's f64 `xla` programs and its f32 Pallas solve in
interpret mode (CPU). Small sizes: T = 16 days, a 32-point grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu import backtest as jbt
from copula_var_tpu.ops import pallas_solver as jps
from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops import solvers as jsolvers
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops import solvers as tsolvers

torch.set_num_threads(2)

ATOL_ROOT = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
TOL = 1e-6
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)
T, N, Q = 16, 32, 5


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


@pytest.fixture(scope="module")
def case():
    """Day tensors for both families (Student copula, nu = 6.5)."""
    rng = np.random.default_rng(7)
    x, dx = msm_grid(N)
    vols = np.sort(rng.uniform(0.4, 2.5, (2, Q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    fbs = rng.dirichlet(np.ones(Q), size=(T, 2))
    fc = rng.dirichlet(np.ones(Q * Q), size=T)
    spec = jq.CopulaSpec("student", (6.5, jnp.asarray([[1.0, 0.7],
                                                       [0.7, 1.0]])))
    C = np.asarray(jq.msm_day_tensors(fbs, x, vols, spec))
    V = np.asarray(jq.garch_day_tensors(rng.uniform(0.6, 1.8, (T, 2)), x,
                                        spec))
    return dict(x=x, dx=dx, dens=dens, fc=fc, C=C, V=V)


def _family(case, family, weights):
    """(port SweepOperands, JAX kernel_id, JAX aux) for one family."""
    x, dx, w = case["x"], case["dx"], jnp.asarray(weights)
    if family == "msm":
        ops = cq.sweep_operands(_t(case["C"]), _t(x), _t(dx),
                                _t(case["dens"]), _t(case["fc"]))
        aux = (jnp.asarray(case["C"]), jnp.asarray(case["fc"]), x, dx,
               jnp.asarray(case["dens"]), w, -5.0)
        return ops, ("msm_cached",), aux
    ops = cq.sweep_operands(_t(case["V"]), _t(x), _t(dx))
    return ops, ("garch_cached",), (jnp.asarray(case["V"]), x, dx, w, -5.0)


def test_halvings_is_the_while_loop_count():
    assert cs.halvings(4.0, 1e-6) == 22  # min_var .. second_guess[0]
    assert cs.halvings(7.5, 1e-6) == 23  # the full default bracket
    assert cs.halvings(1e-6, 1e-6) == 0
    w, k = 2.0, 0
    while w > 1e-6:
        w, k = w / 2.0, k + 1
    assert cs.halvings(2.0, 1e-6) == k


@pytest.mark.parametrize("quirks", [False, True])
def test_bracket_state_matches_jax(case, quirks):
    rng = np.random.default_rng(3)
    ops, kid, aux = _family(case, "msm", [0.3, 0.7])
    F1 = rng.uniform(0.0, 0.12, (3, T))
    obj = np.array([0.01, 0.05, 0.1])

    def jsweep(b):
        return jnp.stack([jbt._call_integral_kernel(kid, bb, aux)
                          for bb in b])

    want = jsolvers.bracket_state_batched(
        jnp.asarray(F1), jnp.asarray(obj), jsweep, jnp.asarray(CFG), quirks)
    w = _t([[0.3, 0.7]] * 3)
    got = tsolvers.bracket_state_batched(
        _t(F1), _t(obj), lambda b: cq.masked_sweep(ops, b, w), CFG, quirks)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("quirks", [False, True])
def test_full_solve_levels_matches_jax(case, family, quirks):
    weights = [0.3, 0.7]  # unequal: exposes the weights pairing
    ops, kid, aux = _family(case, family, weights)
    obj = np.array([0.01, 0.025, 0.05])
    want, want_nan = jbt._device_full_solve_levels_jit(
        kid, aux, jnp.asarray(obj), jnp.asarray(CFG), TOL, T, quirks)
    got, got_nan = cs.full_solve(ops, _t(obj), _t(weights), CFG, TOL, quirks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ROOT)
    np.testing.assert_array_equal(got_nan.numpy(), np.asarray(want_nan))


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_full_solve_portfolios_matches_jax(case, family):
    ops, kid, aux = _family(case, family, [0.5, 0.5])
    wb = np.array([[0.3, 0.7], [0.8, 0.2], [0.5, 0.5], [0.65, 0.35]])
    obj = np.array([0.05, 0.01, 0.025, 0.05])
    want, want_nan = jbt._device_full_solve_portfolios_jit(
        kid, aux, jnp.asarray(obj), jnp.asarray(wb), jnp.asarray(CFG), TOL,
        T, False)
    got, got_nan = cs.full_solve(ops, _t(obj), _t(wb), CFG, TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ROOT)
    np.testing.assert_array_equal(got_nan.numpy(), np.asarray(want_nan))


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_full_solve_within_plateau_of_pallas_interpret(case, family):
    """K1's fused f32 Pallas solve (interpret mode) resolves roots to the
    edge of the same masked-grid plateau as the f64 solve, within
    `root_plateau_bound` (one grid cell x |weights[0]|) plus the
    bisection tolerance."""
    weights = np.array([0.3, 0.7])
    ops, _, _ = _family(case, family, weights)
    obj = np.array([0.01, 0.05])
    if family == "msm":
        want, _ = jps.msm_full_solve_pallas_levels(
            case["C"], case["fc"], case["x"], case["dx"], case["dens"],
            weights, obj, interpret=True, day_block=8)
    else:
        want, _ = jps.garch_full_solve_pallas_levels(
            case["V"], case["x"], case["dx"], weights, obj, interpret=True,
            day_block=8)
    got, _ = cs.full_solve(ops, _t(obj), _t(weights), CFG, TOL)
    bound = jps.root_plateau_bound(case["dx"], weights) + TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)


def _kernel_emulation(ops, lo, up, pr, pu, us, obj, weights, n_iters):
    """The CUDA bisection kernel's algorithm in PyTorch: a fixed count of
    halvings, no all-zeros break."""
    for _ in range(n_iters):
        mid = (lo + up) / 2.0
        b_lo = torch.where(us, lo, mid)
        b_up = torch.where(us, mid, up)
        slab = cq.masked_sweep_reference(
            ops, torch.stack((b_lo, b_up), -1), weights)
        res = torch.where(b_lo == pu, pr + slab, pr - slab)
        below = res < obj[:, None]
        lo, up = torch.where(below, mid, lo), torch.where(below, up, mid)
        pr, pu, us = res, mid, below
    return (lo + up) / 2.0


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_fixed_count_bisection_equals_while_loop(case, family):
    """The kernel's semantics (host-counted iterations) give the same
    roots as the while-loop twin on bracket states with unequal weights;
    on the CPU, bisect_levels is that twin and launches nothing."""
    wrows = _t([[0.3, 0.7], [0.8, 0.2], [0.5, 0.5]])
    ops, _, _ = _family(case, family, [0.5, 0.5])
    obj = _t([0.01, 0.05, 0.1])
    stage1 = torch.stack([torch.full((T,), -100.0, dtype=torch.float64),
                          torch.full((T,), CFG[0], dtype=torch.float64)], -1)
    F1 = cq.masked_sweep(ops, stage1.expand(3, T, 2), wrows)
    state = tsolvers.bracket_state_batched(
        F1, obj, lambda b: cq.masked_sweep(ops, b, wrows), CFG, False)[:5]
    before = cq.launch_count(cs.bisect_levels)
    plain = cs.bisect_levels(ops, *state, obj, wrows, TOL)
    assert cq.launch_count(cs.bisect_levels) == before
    n_iters = cs.halvings(float((state[1] - state[0]).max()), TOL)
    emulated = _kernel_emulation(ops, *state, obj, wrows, n_iters)
    np.testing.assert_array_equal(emulated.numpy(), plain.numpy())
