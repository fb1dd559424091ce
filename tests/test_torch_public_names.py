"""The port's last public names of the JAX package's `parallel/`, held to
JAX on the CPU as `tests/test_torch_parallel.py` holds the sharded
functions: the day-sharded dim >= 3 functions `sharded_tcached_integrals`,
`sharded_tcached_bisection_solve_levels`,
`sharded_tcached_full_solve_levels` (levels, and portfolios with the
refine) and `sharded_tcached_trap_refine` on a spawned gloo world of two
ranks (blocks of 4 and 3 days), against JAX's on a mesh of two CPU
devices at atol 1e-12, every rank bit-equal to rank 0; and
`trap_refine_gspmd_jit` (dim 2, no mesh) against JAX's. The inputs are
`_torch_names_worker`'s numpy arrays, the same on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_names_worker as nw
from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu.parallel import make_mesh as jax_make_mesh
from copula_var_tpu.parallel import quadrature as jpq
from copula_var_tpu_torch import parallel as par
from copula_var_tpu_torch.parallel import distributed

torch.set_num_threads(2)

ATOL = 1e-12  # tests/test_sharded_engine.py's bar for the sharded engine


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("names") / "r%d.npz")
    distributed.run_world(nw.rank_main, 2, (path,), backend="gloo",
                          device="cpu", timeout_s=300)
    return [dict(np.load(path % r)) for r in range(2)]


def _jax_functions(family):
    a = nw.inputs(family)
    mesh = jax_make_mesh(n_devices=2)
    spec = jq.CopulaSpec("student", (nw.NU, jnp.asarray(nw.CORR)))
    fc = None if a["fcombos"] is None else jnp.asarray(a["fcombos"])
    cols_s, fc_s, Tp = jpq._tcached_place(mesh, a["cols"], fc, family, nw.T)
    day_batch = jq._day_batch(nw.N, 3, Tp // 2)
    placed = (cols_s, fc_s, a["densities"], a["x"], a["dx"])
    tail = (spec, family, day_batch)
    bounds = np.stack([np.full(nw.T, -100.0), np.full(nw.T, -2.5)], -1)
    out = {"integrals": jpq.sharded_tcached_integrals(
        mesh, bounds, *placed, nw.WEIGHTS, *tail)}
    out["bisect"] = jpq.sharded_tcached_bisection_solve_levels(
        mesh, *placed, nw.WEIGHTS, *a["state"].values(), nw.LEVELS, 1e-6,
        *tail)
    roots, nan_days = jpq.sharded_tcached_full_solve_levels(
        mesh, *placed, nw.WEIGHTS, nw.LEVELS, *nw.SOLVE, *tail, T=nw.T)
    out["full"], out["full_nan"] = roots, nan_days
    out["full_ports"] = jpq.sharded_tcached_full_solve_levels(
        mesh, *placed, nw.W_ROWS, nw.LEVELS, *nw.SOLVE, *tail, T=nw.T,
        portfolios=True, refine=True, refine_h=0.05)[0]
    out["trap"] = jpq.sharded_tcached_trap_refine(
        mesh, cols_s, fc_s, a["densities"], a["x"], nw.WEIGHTS,
        np.asarray(roots), nw.LEVELS, 0.05, *tail, T=nw.T)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("family", nw.FAMILIES)
def test_sharded_tcached_functions_equal_jax(ranks, family):
    want = _jax_functions(family)
    got = ranks[0]
    for name, w in want.items():
        g = got[f"{family}/{name}"]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
    for name in want:
        np.testing.assert_array_equal(ranks[1][f"{family}/{name}"],
                                      got[f"{family}/{name}"])


def test_sharded_tcached_refuses_a_padded_day_count():
    a = nw.inputs("garch")
    with pytest.raises(ValueError, match="unpadded"):
        par.sharded_tcached_full_solve_levels(
            _OneRank(), a["cols"], None, None, a["x"], a["dx"], nw.WEIGHTS,
            nw.LEVELS, *nw.SOLVE, nw.spec(), "garch", T=nw.T + 1)


class _OneRank:
    """A day mesh of one rank, without a process group: every day is
    this rank's (the refusal above raises before any collective)."""

    device = torch.device("cpu")
    size, rank = 1, 0

    def days(self, T):
        return slice(0, T)


@pytest.mark.parametrize("is_msm", [True, False])
@pytest.mark.parametrize("portfolios", [False, True])
def test_trap_refine_gspmd_jit_matches_jax(is_msm, portfolios):
    """Dim 2, day tensors (T, n, n): the staircase roots of two levels
    re-solved against the trap sweep, shared weights or one row each."""
    rng = np.random.default_rng(12)
    T, n, q = 6, 16, 3
    x, _ = msm_grid(n)
    tensors = rng.gamma(2.0, 0.02, (T, n, n))
    fc = rng.dirichlet(np.ones(q * q), size=T)
    dens = rng.uniform(0.0, 0.5, (2, q, n))
    roots = rng.uniform(-2.5, -1.0, (2, T))
    obj = np.array([0.05, 0.01])
    weights = (np.array([[0.6, 0.4], [0.3, 0.7]]) if portfolios
               else np.array([0.6, 0.4]))
    h = np.array([0.05, 0.08]) if portfolios else 0.05
    want = np.asarray(jpq.trap_refine_gspmd_jit(
        jnp.asarray(tensors), jnp.asarray(fc), jnp.asarray(dens),
        jnp.asarray(x), jnp.asarray(weights), jnp.asarray(roots),
        jnp.asarray(obj), jnp.asarray(h), -5.0, is_msm, portfolios))
    got = par.trap_refine_gspmd_jit(
        tensors, fc, dens, x, weights, roots, obj, h, -5.0, is_msm,
        portfolios)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
