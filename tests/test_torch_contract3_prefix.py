"""The dim-3 table's stored form, on the CPU: `contract3_table_reference`
(each (day, i0, i1) row of U as its inclusive prefix sum over i2, a
flagged row as its cells) read through the interval rule as the table
sweep reads it (two prefixes per row lookup whose interval holds a grid
point, a flagged row's cells one by one) gives the plain sweep's sums,
for MSM and GARCH, Student and Gaussian, in float64 and float32, on all
outer slabs and on a range of them; a NaN cell still poisons the slabs
that hold it, and a cell past MAX_CELL is summed cell by cell. Small
sizes (n = 13-20, T = 4), inputs from numpy seeds; no JAX."""

import numpy as np
import pytest
import torch

from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    transform_u_columns,
)

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
BOX_MIN = -5.0
CORR3 = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35], [0.25, 0.35, 1.0]])
# the rule on stored prefixes against the plain masked sum: float64 sums
# of the same cells in other orders; in float32 each stored prefix is
# rounded once, the plain twin sums in float32
RTOL = {F64: 1e-12, F32: 1e-5}


def _ops3(family, kind, dtype=F64, T=4, n=17, q=3, seed=0, edit=None,
          rows=None):
    """Random dim-3 operands on the CPU (the card tests' fixture);
    `edit(cols, p)` may poke the columns first."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64))

    corr = t(CORR3)
    spec = (CopulaSpec("student", (6.5, corr)) if kind == "student"
            else CopulaSpec("gaussian", (corr,)))
    cols = list(transform_u_columns(t(rng.uniform(0.002, 0.998, (T, 3, n))),
                                    spec))
    x = t(np.linspace(-5.0, 5.0, n))
    dx = t(np.full(n, 10.0 / n))
    p = t(rng.uniform(0.0, 0.5, (T, 3, n))) if family == "garch" else None
    if edit is not None:
        edit(cols, p)
    if family == "garch":
        return cq3.contract3_operands(tuple(cols), x, dx, spec, p_cols=p,
                                      rows=rows, dtype=dtype)
    dens = t(rng.uniform(0.0, 0.5, (3, q, n)))
    fc = t(rng.dirichlet(np.ones(q**3), size=T))
    return cq3.contract3_operands(tuple(cols), x, dx, spec, densities=dens,
                                  forecast_combos=fc, rows=rows, dtype=dtype)


def _bounds(T, L, dtype, seed=1):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-6.0, -0.5, (L, T))
    b = np.stack([lo, lo + rng.uniform(0.0, 4.0, (L, T))], -1)
    b[0] = [-100.0, 100.0]  # every cell of the box: each whole row
    w = rng.dirichlet([2.0, 2.0, 2.0], size=L)
    return torch.tensor(b, dtype=dtype), torch.tensor(w, dtype=dtype)


def stored_sweep(S, flags, x, bounds, weights, row0=0, box_min=BOX_MIN):
    """The table sweep's arithmetic on the stored form S (T, r, n, n) with
    its flags (T, r, n): per bound row l, day, i0 and i1 the dynamic
    bounds on x2 in the operands' type, lo and hi the counts of x <= dlo
    and x <= dup, the row's S[hi - 1] - S[lo - 1] in float64 (a flagged
    row: its cells [lo, hi)), 0 for an empty interval or a NaN bound;
    summed over i1 and i0 in float64 and rounded once -> (L, T)."""
    T, r, n = flags.shape
    x0 = x[row0:row0 + r]
    S64 = S.to(F64)
    S0 = torch.cat([torch.zeros_like(S64[..., :1]), S64], dim=-1)
    j = torch.arange(n)
    out = []
    for b, w in zip(bounds, weights):
        prev = x0[:, None] * w[1] + x[None, :] * w[2]  # (r, n)
        dup = (b[:, 1, None, None] - prev) / w[0]
        dlo = torch.maximum((b[:, 0, None, None] - prev) / w[0],
                            torch.tensor(box_min, dtype=x.dtype))
        hi = torch.searchsorted(x, dup.contiguous(), right=True)
        lo = torch.searchsorted(x, dlo.contiguous(), right=True)
        pref = (torch.gather(S0, -1, hi[..., None])
                - torch.gather(S0, -1, lo[..., None]))[..., 0]
        inside = (j >= lo[..., None]) & (j < hi[..., None])
        cells = torch.where(inside, S64, torch.zeros_like(S64)).sum(dim=-1)
        row = torch.where(flags, cells, pref)
        empty = (hi <= lo) | torch.isnan(dlo) | torch.isnan(dup)
        row = torch.where(empty, torch.zeros_like(row), row)
        out.append(row.sum(dim=(1, 2)))
    return torch.stack(out).to(S.dtype)


def _assert_close(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max())
    assert float((got[fin] - want[fin]).abs().max()) <= RTOL[dtype] * scale


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["student", "gaussian"])
def test_stored_form_through_the_rule_matches_plain(family, kind, dtype):
    ops = _ops3(family, kind, dtype)
    S, flags = cq3.contract3_table_reference(ops)
    n = ops.x.shape[0]
    assert S.shape == (ops.days, n, n, n) and S.dtype == dtype
    assert flags.shape == (ops.days, n, n) and not bool(flags.any())
    bounds, weights = _bounds(ops.days, 5, dtype)
    _assert_close(stored_sweep(S, flags, ops.x, bounds, weights),
                  cq3.masked_contract3_reference(ops, bounds, weights),
                  dtype)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_stored_form_is_the_prefix_of_each_row(dtype):
    """An unflagged row is the float64 running sum of its cells, in index
    order, rounded once; its last entry the row's sum."""
    ops = _ops3("msm", "student", dtype, T=2, n=13)
    U = cq3.contract3_weights_reference(ops)
    S, flags = cq3.contract3_table_reference(ops)
    run = torch.zeros(U.shape[:-1], dtype=F64)
    want = torch.empty_like(U)
    for k in range(U.shape[-1]):
        run = run + U[..., k].to(F64)
        want[..., k] = run.to(dtype)
    assert torch.equal(S, want)
    days = slice(1, 2)
    S1, f1 = cq3.contract3_table_reference(ops, days)
    assert torch.equal(S1, S[days]) and torch.equal(f1, flags[days])


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_stored_form_on_a_range_of_outer_slabs(family):
    """Operands of outer slabs [i0, i1): the whole stored form's slabs, and
    their sweep the plain twin's share."""
    whole = _ops3(family, "student", n=16)
    S, flags = cq3.contract3_table_reference(whole)
    ops = _ops3(family, "student", n=16, rows=(5, 11))
    S_r, f_r = cq3.contract3_table_reference(ops)
    assert torch.equal(S_r, S[:, 5:11]) and torch.equal(f_r, flags[:, 5:11])
    bounds, weights = _bounds(ops.days, 4, F64)
    _assert_close(stored_sweep(S_r, f_r, ops.x, bounds, weights, row0=5),
                  cq3.masked_contract3_reference(ops, bounds, weights), F64)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("family", ["msm", "garch"])
def test_flagged_rows_keep_their_cells(family, dtype):
    """A non-finite asset-1 column (a row of NaN cells), a non-finite
    asset-2 column (a NaN cell in every row of its slab) and an
    overflowing one (cells past MAX_CELL: inf for MSM, saturated by
    nan_to_num for GARCH, whose NaN cells are 0): those rows are flagged
    and stored as their cells, the rest as prefixes; the rule over the
    stored form poisons exactly the slabs the plain sweep poisons and
    sums the huge cells one by one."""
    def edit(cols, p):
        cols[1][0, 1, 5] = False
        cols[1][1, 2, 14] = False
        cols[2][2, 2, 15] = -1000.0

    ops = _ops3(family, "student", dtype, n=20, edit=edit)
    U = cq3.contract3_weights_reference(ops)
    S, flags = cq3.contract3_table_reference(ops)
    assert torch.equal(flags, ~(U.abs() <= cq3.MAX_CELL).all(dim=-1))
    assert torch.equal(flags, cq3.contract3_row_flags_reference(ops))
    assert bool(flags.any()) and not bool(flags.all())
    assert bool(flags[2].any())
    if family == "msm":
        assert bool(flags[0, :, 5].all())
    same = torch.isnan(U) & torch.isnan(S) | (U == S)
    assert bool(same[flags].all())
    assert not bool(same[~flags].all())
    bounds, weights = _bounds(ops.days, 6, dtype)
    want = cq3.masked_contract3_reference(ops, bounds, weights)
    assert bool(torch.isfinite(want).any())
    if family == "msm":
        assert not bool(torch.isfinite(want).all())
    else:
        assert float(want.abs().max()) > 1e30
    _assert_close(stored_sweep(S, flags, ops.x, bounds, weights), want,
                  dtype)
