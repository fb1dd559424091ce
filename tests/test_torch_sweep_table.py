"""The dim-2 sweep's prefix table (K2/K3, csrc/quadrature.cu), on the CPU:
the table's plain twin `sweep_table_reference` read through the interval
rule, as `prefix_sweep_kernel` reads it, against the JAX package's cached
sweeps (MSM q = 5 and GARCH q = 1; stage-1 and random bounds; unequal
weights; a day with a NaN cell; a row with one saturated +/-DBL_MAX
cell); the table's layout; and the CPU refusal of the table build. Small
sizes (n = 16-32, T = 5-16), inputs from numpy seeds.

The tolerance is the port's sweep bar, 1e-12 relative to the sweep's
largest magnitude: a prefix difference rounds to a few ulps of the row's
running sum, not of the interval."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu_torch.ops import cuda_quadrature as cq

torch.set_num_threads(2)

BOX_MIN = -5.0
RTOL = 1e-12  # RTOL_SWEEP of the card tests and chip_smoke.py
T, N, Q = 8, 24, 5
CORR = np.array([[1.0, 0.6], [0.6, 1.0]])
WEIGHTS = ([0.3, 0.7], [0.65, 0.35])  # unequal: exposes the pairing
DBL_MAX = np.finfo(np.float64).max


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def table_sums(P, flags, x, dlo, dup):
    """One row of P read as the kernel reads it: rows (..., n) of prefix
    sums on the ascending grid x, or of cells where flagged; bounds dlo,
    dup (...) -> (...) masked sums. hi and lo count the grid points <= dup
    and <= dlo; an unflagged row gives S[hi-1] - S[lo-1] (S[-1] = 0), a
    flagged row the sum of its cells [lo, hi); NaN bounds give 0."""
    n = x.shape[0]
    cells = P[..., :n]
    S0 = torch.cat([torch.zeros_like(cells[..., :1]), cells], dim=-1)
    hi = torch.searchsorted(x, dup.contiguous(), right=True)
    lo = torch.searchsorted(x, dlo.contiguous(), right=True)
    pref = (torch.gather(S0, -1, hi[..., None])
            - torch.gather(S0, -1, lo[..., None]))[..., 0]
    j = torch.arange(n)
    inside = (j >= lo[..., None]) & (j < hi[..., None])
    direct = torch.where(inside, cells, torch.zeros_like(cells)).sum(dim=-1)
    out = torch.where(flags, direct, pref)
    out = torch.where(hi > lo, out, torch.zeros_like(out))
    nan = torch.isnan(dlo) | torch.isnan(dup)
    return torch.where(nan, torch.zeros_like(out), out)


def table_sweep(ops, bounds, weights, box_min=BOX_MIN):
    """The redesigned K2's arithmetic: per (bound row, day, grid row i) the
    two dynamic bounds on x_j, the rule on row i of P, the sum over i ->
    (L, T)."""
    P, flags = cq.sweep_table_reference(ops)
    out = []
    for b, w in zip(bounds, weights):
        p = ops.x * w[1]
        dup = (b[:, 1, None] - p) / w[0]
        dlo = torch.maximum((b[:, 0, None] - p) / w[0],
                            torch.tensor(box_min, dtype=torch.float64))
        out.append(table_sums(P, flags, ops.x, dlo, dup).sum(dim=-1))
    return torch.stack(out)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    x, dx = msm_grid(N)
    vols = np.sort(rng.uniform(0.4, 2.5, (2, Q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    spec = jq.CopulaSpec("student", (6.5, jnp.asarray(CORR)))
    C = np.asarray(jq.msm_day_tensors(rng.dirichlet(np.ones(Q), (T, 2)), x,
                                      vols, spec))
    V = np.asarray(jq.garch_day_tensors(rng.uniform(0.6, 1.8, (T, 2)), x,
                                        spec))
    lo = rng.uniform(-8.0, -1.0, (len(WEIGHTS), T))
    return dict(x=x, dx=dx, dens=dens, C=C, V=V,
                fc=rng.dirichlet(np.ones(Q * Q), size=T),
                random=np.stack([lo, lo + rng.uniform(0.05, 4.0, lo.shape)],
                                -1),
                stage1=np.broadcast_to([-100.0, -3.0],
                                       (len(WEIGHTS), T, 2)).copy())


def _ops(case, family, V=None):
    """(port SweepOperands on the CPU, JAX sweep of bounds (T, 2) at w)."""
    x, dx = case["x"], case["dx"]
    if family == "msm":
        V = case["C"] if V is None else V
        ops = cq.sweep_operands(_t(V), _t(x), _t(dx), _t(case["dens"]),
                                _t(case["fc"]))

        def jax_sweep(b, w):
            return np.asarray(jq.msm_integrals_cached(
                b, V, case["fc"], x, dx, case["dens"], jnp.asarray(w)))
        return ops, jax_sweep
    V = case["V"] if V is None else V
    ops = cq.sweep_operands(_t(V), _t(x), _t(dx))

    def jax_sweep(b, w):
        return np.asarray(jq.garch_integrals_cached(b, V, x, dx,
                                                    jnp.asarray(w)))
    return ops, jax_sweep


def _check(ops, jax_sweep, bounds):
    """The table through the rule against JAX, row by row: the same NaN
    cells, the others within RTOL of the largest finite magnitude."""
    got = table_sweep(ops, _t(bounds), _t(WEIGHTS)).numpy()
    want = np.stack([jax_sweep(b, np.asarray(w))
                     for b, w in zip(bounds, WEIGHTS)])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                               atol=RTOL * scale)
    return want


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["stage1", "random"])
def test_table_through_the_rule_matches_jax(case, family, kind):
    ops, jax_sweep = _ops(case, family)
    assert ops.w1.shape[0] == (Q if family == "msm" else 1)
    want = _check(ops, jax_sweep, case[kind])
    assert np.isfinite(want).all() and (want > 0).any()


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_table_nan_cell_poisons_only_its_slabs(case, family):
    """A NaN cell flags its row, kept raw: the slabs that hold it are NaN,
    the others are the JAX values."""
    V = case["C" if family == "msm" else "V"].copy()
    V[2, 7, 11] = np.nan
    ops, jax_sweep = _ops(case, family, V)
    P, flags = cq.sweep_table_reference(ops)
    assert flags.nonzero().tolist() == [[2, 7]]
    want = _check(ops, jax_sweep, case["random"])
    wide = np.broadcast_to([-100.0, 100.0], (len(WEIGHTS), T, 2)).copy()
    want_wide = _check(ops, jax_sweep, wide)
    assert np.isnan(want_wide[:, 2]).all() and not np.isnan(want).all()
    assert np.isfinite(np.delete(want_wide, 2, axis=1)).all()


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_table_saturated_cell_does_not_absorb_its_row(case, family):
    """One cell per day saturated to +/-DBL_MAX (as nan_to_num leaves an
    overflowed GARCH density) near the start of a row: the row is flagged
    and kept raw, so intervals wholly after the cell give the moderate
    JAX sums, and intervals that hold it the huge ones."""
    V = case["C" if family == "msm" else "V"].copy()
    rows = np.arange(T) % N
    V[np.arange(T), rows, 1] = np.where(np.arange(T) % 2 == 0, DBL_MAX,
                                        -DBL_MAX)
    ops, jax_sweep = _ops(case, family, V)
    _, flags = cq.sweep_table_reference(ops)
    assert flags.nonzero()[:, 1].tolist() == rows.tolist()
    x = case["x"]
    # each saturated row i holds the cell at x_1: dlo_i > x_1 for every
    # bound row, so that cell lies outside every interval
    lo = np.empty((len(WEIGHTS), T))
    for r, (w_in, w_out) in enumerate(WEIGHTS):
        lo[r] = x[1] * w_in + x[rows] * w_out + 0.5
    after = np.stack([lo, lo + 2.0], -1)
    want = _check(ops, jax_sweep, after)
    assert np.isfinite(want).all() and (np.abs(want) < 10.0).all()
    assert (want != 0).any()
    wide = np.broadcast_to([-100.0, 100.0], (len(WEIGHTS), T, 2)).copy()
    want = _check(ops, jax_sweep, wide)
    assert (np.abs(want) > 1e300).all()


@pytest.mark.parametrize("n", [15, 16])
def test_table_layout(n):
    """pitch n | 1 (odd n: rows unpadded; even n: one zero pad cell per
    row); unflagged rows are the inclusive prefix sums of U = V .* (wfc
    W1); a row with a cell outside [-1, 1] (NaN included) is flagged and
    kept as its cells."""
    rng = np.random.default_rng(n)
    x, dx = msm_grid(n)
    V = rng.gamma(2.0, 0.05, (5, n, n))
    V[1, 3, 4], V[2, 0, n - 1], V[4, n - 1, 0] = np.nan, 2e3, -np.inf
    ops = cq.sweep_operands(_t(V), _t(x), _t(dx))
    P, flags = cq.sweep_table_reference(ops)
    assert cq.row_pitch(n) == n + (n % 2 == 0)
    assert P.shape == (5, n, cq.row_pitch(n)) and flags.dtype == torch.bool
    assert flags.nonzero().tolist() == [[1, 3], [2, 0], [4, n - 1]]
    U = ops.V * torch.outer(ops.dx, ops.dx)
    np.testing.assert_array_equal(P[flags][:, :n].numpy(),
                                  U[flags].numpy())
    np.testing.assert_allclose(P[~flags][:, :n].numpy(),
                               np.cumsum(U[~flags].numpy(), axis=-1),
                               rtol=1e-14)
    assert bool((P[..., n:] == 0).all())


def test_cpu_operands_carry_no_table(case):
    """On the CPU the sweep runs the plain twin and needs no table; the
    build itself runs on a CUDA device only."""
    ops, _ = _ops(case, "msm")
    assert ops.P is None and ops.flags is None
    before = cq.launch_count(cq.sweep_table)
    with pytest.raises(ValueError, match="CUDA device only"):
        cq.sweep_table(ops)
    assert cq.launch_count(cq.sweep_table) == before
