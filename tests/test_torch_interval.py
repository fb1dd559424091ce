"""The interval rule of the redesigned kernels (csrc/interval.cuh), on the
CPU: a plain PyTorch model of the rule against the plain masked sum; the
dim-3 table U (`contract3_weights_reference`) summed under the mask, and
read through the rule, against the JAX package's transform-cached sweeps;
the dim-2 bisection with the rule as its sweep against the port's plain
bisection; the table's memory guard; and the build's hash over headers.
Small sizes (n = 16-32, T = 5-16), inputs from numpy seeds."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops import quadrature as tq
from copula_var_tpu_torch.ops import solvers as tsolvers

torch.set_num_threads(2)

BOX_MIN = -5.0
RTOL_RULE = 1e-13  # prefix difference vs masked sum, moderate cells
RTOL = 1e-12  # the port's parity bar for sweeps (tests/test_torch_dim3.py)
ATOL_ROOT = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
TOL = 1e-6
MAX_CELL = 1.0  # interval.cuh kMaxCell: larger cells flag their row
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)
CORR3 = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35], [0.25, 0.35, 1.0]])


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def interval_sums(rows, x, dlo, dup):
    """The rule, in PyTorch: rows (..., n) cells on the ascending grid x,
    bounds dlo, dup (...) -> (...) masked sums as prefix differences
    (searchsorted for hi and lo), rows flagged for a cell outside
    [-MAX_CELL, MAX_CELL] (NaN included) summed directly, NaN bounds
    giving 0."""
    n = x.shape[0]
    S = torch.cumsum(rows, dim=-1)
    flagged = ~(rows.abs() <= MAX_CELL).all(dim=-1)
    S0 = torch.cat([torch.zeros_like(S[..., :1]), S], dim=-1)  # S0[k] = S[k-1]
    hi = torch.searchsorted(x, dup.contiguous(), right=True).clamp(0, n)
    lo = torch.searchsorted(x, dlo.contiguous(), right=True).clamp(0, n)
    pref = (torch.gather(S0, -1, hi[..., None])
            - torch.gather(S0, -1, lo[..., None]))[..., 0]
    pref = torch.where(hi > lo, pref, torch.zeros_like(pref))
    j = torch.arange(n)
    inside = (j >= lo[..., None]) & (j < hi[..., None])
    direct = torch.where(inside, rows, torch.zeros_like(rows)).sum(dim=-1)
    out = torch.where(flagged, direct, pref)
    nan = torch.isnan(dlo) | torch.isnan(dup)
    return torch.where(nan, torch.zeros_like(out), out)


def masked_sums(rows, x, dlo, dup):
    """The plain masked form the kernels replaced."""
    m = (x > dlo[..., None]) & (x <= dup[..., None])
    return torch.where(m, rows, torch.zeros_like(rows)).sum(dim=-1)


def _clip(d):
    """max(d, box_min), NaN-propagating, as the kernels form dlo."""
    return torch.maximum(d, torch.tensor(BOX_MIN, dtype=torch.float64))


def _rule_case(name, rng, R=64, n=24):
    x = np.sort(rng.uniform(-5.0, 5.0, n))
    rows = rng.gamma(2.0, 0.05, (R, n))
    # dynamic lower bounds below box_min in the "clipped" case
    lo = rng.uniform(-9.0 if name == "clipped" else -6.0, 5.0, R)
    up = lo + rng.uniform(0.0, 4.0, R)
    big = np.finfo(np.float64).max
    if name == "ties":  # bounds on grid points, strict-lower / incl-upper
        k = rng.integers(0, n, (2, R))
        lo, up = x[np.minimum(k[0], k[1])], x[np.maximum(k[0], k[1])]
        up[:8] = lo[:8]
    elif name == "nan_bounds":
        lo[::3], up[1::3] = np.nan, np.nan
    elif name == "empty":
        up = lo - rng.uniform(0.0, 1.0, R)
    elif name == "inf_bounds":
        lo[::2], up[1::2] = -np.inf, np.inf
    elif name == "nonfinite_cells":
        rows[::4, 3], rows[1::4, 10] = np.nan, np.inf
        rows[2::4, 17] = -np.inf
    elif name == "dbl_max_cells":
        # two same-sign DBL_MAX cells side by side: the running sum
        # overflows; rows of ~1e299 cells stay finite; all are flagged
        rows[0::3, 4:6] = big
        rows[1::3, 7:9] = -big
        rows[2::3] *= 1e300
    elif name == "saturated_cell":
        # one GARCH cell saturated by nan_to_num (+/-DBL_MAX, or DBL_MAX
        # times a quadrature weight), early in the row: the row stays
        # finite, but a prefix sum would absorb every cell after it
        k = rng.integers(0, 6, R)
        r = np.arange(R)
        rows[r, k] = np.where(r % 2 == 0, big, -big) * np.where(
            r % 4 < 2, 1.0, 1e-3)
        lo = x[np.minimum(k + rng.integers(0, 4, R), n - 1)]
        up = lo + rng.uniform(0.5, 4.0, R)
    return _t(rows), _t(x), _clip(_t(lo)), _t(up)


@pytest.mark.parametrize("name", [
    "random", "ties", "nan_bounds", "empty", "clipped", "inf_bounds",
    "nonfinite_cells", "dbl_max_cells", "saturated_cell"])
def test_interval_rule_equals_masked_sum(name):
    rows, x, dlo, dup = _rule_case(name, np.random.default_rng(
        zlib.crc32(name.encode())))
    got = interval_sums(rows, x, dlo, dup)
    want = masked_sums(rows, x, dlo, dup)
    np.testing.assert_array_equal(torch.isnan(got).numpy(),
                                  torch.isnan(want).numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL_RULE,
                               atol=0)
    if name in ("nonfinite_cells", "dbl_max_cells"):
        # the non-finite cells poison only the intervals that hold them
        assert bool(torch.isfinite(want).any())
        assert not bool(torch.isfinite(want).all())
    if name == "saturated_cell":
        # most intervals lie wholly after the huge cell and are moderate
        small = want.abs() < 10.0
        assert int(small.sum()) > len(want) // 2
        assert bool((want[small] != 0).any())


# -- the dim-3 table ----------------------------------------------------------

T3, N3, Q3 = 5, 16, 3


@pytest.fixture(scope="module")
def case3():
    rng = np.random.default_rng(21)
    x, dx = msm_grid(N3)
    vols = np.sort(rng.uniform(0.5, 2.0, (3, Q3)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    lo = rng.uniform(-8.0, -1.0, T3)
    return dict(x=x, dx=dx, vols=vols, dens=dens,
                fbs=rng.dirichlet(np.ones(Q3), size=(T3, 3)),
                fc=rng.dirichlet(np.ones(Q3**3), size=T3),
                fv=rng.uniform(0.6, 1.8, (T3, 3)),
                bounds=np.stack([lo, lo + rng.uniform(0.05, 4.0, T3)], -1))


def _ops3(case, family, kind):
    """(port Contract3Operands on the CPU, JAX integrals at weights w)."""
    if kind == "gaussian":
        jspec = jq.CopulaSpec("gaussian", (jnp.asarray(CORR3),))
        tspec = tq.CopulaSpec("gaussian", (_t(CORR3),))
    else:
        jspec = jq.CopulaSpec("student", (6.5, jnp.asarray(CORR3)))
        tspec = tq.CopulaSpec("student", (6.5, _t(CORR3)))
    x, dx, b = case["x"], case["dx"], case["bounds"]
    if family == "msm":
        cols = tq.msm_day_columns(_t(case["fbs"]), _t(x), _t(case["vols"]),
                                  tspec)
        ops = cq3.contract3_operands(cols, _t(x), _t(dx), tspec,
                                     densities=_t(case["dens"]),
                                     forecast_combos=_t(case["fc"]))

        def jax_sweep(w):
            return np.asarray(jq.msm_integrals_tcached(
                b, jq.msm_day_columns(case["fbs"], x, case["vols"], jspec),
                case["fc"], x, dx, case["dens"], w, jspec))
        return ops, jax_sweep
    cols, p = tq.garch_day_columns(_t(case["fv"]), _t(x), tspec)
    ops = cq3.contract3_operands(cols, _t(x), _t(dx), tspec, p_cols=p)

    def jax_sweep(w):
        jcols, jp = jq.garch_day_columns(case["fv"], x, jspec)
        return np.asarray(jq.garch_integrals_tcached(b, jcols, jp, x, dx, w,
                                                     jspec))
    return ops, jax_sweep


def interval_contract3(U, x, bounds, w, box_min=BOX_MIN):
    """The new dim-3 sweep's arithmetic for one row: per (t, i0, i1) the
    dynamic bounds on x2, the rule on the row of U, then the sum over i1
    and i0 -> (T,)."""
    prev = x[:, None] * w[1] + x[None, :] * w[2]  # (i0, i1)
    dup = (bounds[:, 1, None, None] - prev) / w[0]
    dlo = _clip((bounds[:, 0, None, None] - prev) / w[0])
    return interval_sums(U, x, dlo, dup).sum(dim=2).sum(dim=1)


@pytest.mark.parametrize("family", ["msm", "garch"])
@pytest.mark.parametrize("kind", ["student", "gaussian"])
def test_table_under_the_mask_matches_jax(case3, family, kind):
    """U summed under the half-space mask, and U read through the interval
    rule, equal the JAX transform-cached sweep."""
    ops, jax_sweep = _ops3(case3, family, kind)
    assert ops.U is None  # built on the card only
    U = cq3.contract3_weights_reference(ops)
    assert U.shape == (T3, N3, N3, N3)
    b = _t(case3["bounds"])
    for w in ([0.5, 0.3, 0.2], [0.2, 0.5, 0.3]):
        M = tq.halfspace_mask(ops.x, b[:, 0], b[:, 1], _t(w))
        masked = torch.where(M, U, torch.zeros(())).sum(dim=(1, 2, 3))
        want = jax_sweep(np.asarray(w))
        np.testing.assert_allclose(masked.numpy(), want, rtol=RTOL, atol=0)
        got = interval_contract3(U, ops.x, b, _t(w))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _padded(cells):
    """The card's layout of cells (T, n, n, n), built by hand: each row
    padded to row_pitch(n) and each (t, i0) slab to slab_stride(n), pads
    -1 so that they show."""
    T, n = cells.shape[:2]
    p, s = cq3.row_pitch(n), cq3.slab_stride(n)
    U = torch.full((T, n, s), -1.0, dtype=torch.float64)
    U[..., : n * p].view(T, n, n, p)[..., :n] = cells
    return U


@pytest.mark.parametrize("n, pitch, stride, pads", [
    (16, 17, 16 * 17, 16), (15, 15, 226, 1)])
def test_table_layout(n, pitch, stride, pads):
    """Even n: one pad cell per row (pitch n + 1); odd n: rows unpadded
    and one pad cell per slab (n*n is odd); `pads` per (t, i0) slab.
    table_cells views exactly the cells, table_pads exactly the pads."""
    cells = _t(np.random.default_rng(n).uniform(0.0, 1.0, (3, n, n, n)))
    assert (cq3.row_pitch(n), cq3.slab_stride(n)) == (pitch, stride)
    U = _padded(cells)
    np.testing.assert_array_equal(cq3.table_cells(U, n).numpy(),
                                  cells.numpy())
    assert cq3.table_pads(U, n).shape == (3 * n * pads,)
    assert bool((cq3.table_pads(U, n) == -1.0).all())


def test_table_day_subsets_and_cpu_refusal(case3):
    """A day subset of the plain twin is the same days of the whole; the
    table itself is built on a CUDA device only."""
    ops, _ = _ops3(case3, "garch", "student")
    full = cq3.contract3_weights_reference(ops)
    np.testing.assert_array_equal(
        cq3.contract3_weights_reference(ops, slice(1, 4)).numpy(),
        full[1:4].numpy())
    with pytest.raises(ValueError, match="CUDA device only"):
        cq3.contract3_weights(ops)


# -- the dim-2 bisection with the rule as its sweep ---------------------------

T2, N2, Q2 = 16, 32, 5


def interval_sweep2(ops, bounds, weights, box_min=BOX_MIN):
    """The new K1's slab arithmetic: U = V .* (wfc W1), per day row i the
    dynamic bounds on x_j, the rule, the sum over i -> (L, T)."""
    U = ops.V * (ops.wfc @ ops.w1)  # (T, n, n)
    out = []
    for b, w in zip(bounds, weights):
        p = ops.x * w[1]
        dup = (b[:, 1, None] - p) / w[0]
        dlo = _clip((b[:, 0, None] - p) / w[0])
        out.append(interval_sums(U, ops.x, dlo, dup).sum(dim=-1))
    return torch.stack(out)


@pytest.fixture(scope="module")
def ops2():
    rng = np.random.default_rng(7)
    x, dx = msm_grid(N2)
    vols = np.sort(rng.uniform(0.4, 2.5, (2, Q2)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    fbs = rng.dirichlet(np.ones(Q2), size=(T2, 2))
    fc = rng.dirichlet(np.ones(Q2 * Q2), size=T2)
    spec = tq.CopulaSpec("student", (6.5, _t([[1.0, 0.7], [0.7, 1.0]])))
    C = tq.msm_day_tensors(_t(fbs), _t(x), _t(vols), spec)
    V = tq.garch_day_tensors(_t(rng.uniform(0.6, 1.8, (T2, 2))), _t(x), spec)
    return {"msm": cq.sweep_operands(C, _t(x), _t(dx), _t(dens), _t(fc)),
            "garch": cq.sweep_operands(V, _t(x), _t(dx))}


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_bisection_with_the_rule_matches_plain(ops2, family):
    ops = ops2[family]
    wrows = _t([[0.5, 0.5], [0.3, 0.7], [0.75, 0.25], [0.9, 0.1]])
    obj = _t([0.01, 0.025, 0.05, 0.1])
    stage1 = torch.stack([torch.full((T2,), -100.0, dtype=torch.float64),
                          torch.full((T2,), CFG[0], dtype=torch.float64)], -1)
    sweep = cq.masked_sweep_reference
    np.testing.assert_allclose(
        interval_sweep2(ops, stage1.expand(4, T2, 2), wrows).numpy(),
        sweep(ops, stage1.expand(4, T2, 2), wrows).numpy(), rtol=RTOL)
    F1 = sweep(ops, stage1.expand(4, T2, 2).contiguous(), wrows)
    state = tsolvers.bracket_state_batched(
        F1, obj, lambda b: sweep(ops, b, wrows), CFG, False)[:5]
    want = cs.bisect_levels_reference(ops, *state, obj, wrows, TOL)
    n_iters = cs.halvings(float((state[1] - state[0]).max()), TOL)
    got = cs.bisect_fixed_count(ops, *state, obj, wrows, TOL, n_iters,
                                interval_sweep2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ATOL_ROOT)


# -- the table's memory guard and the build's hash ----------------------------

def test_table_bytes_and_memory_guard():
    # the flagship width: 500 x 100 slabs of 100 rows of pitch 101
    assert cq3.table_bytes(500, 100) == 4_040_000_000
    assert cq3.table_bytes(2, 3) == 2 * 3 * 10 * 8  # 9 cells padded to 10
    for n in range(1, 40):
        p, s = cq3.row_pitch(n), cq3.slab_stride(n)
        assert p % 2 == 1 and 0 <= p - n <= 1
        assert s in (n * p, n * p + 1) and (s * 8) % 16 == 0
    cq3.require_table_fits(500, 100, 4_040_000_000)  # exactly fits
    with pytest.raises(RuntimeError,
                       match=r"4040000000 bytes .* 4039999999 bytes are "
                             r"free.*rebuild the slabs on every launch"):
        cq3.require_table_fits(500, 100, 4_039_999_999)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """An edited header changes every library's hash, so no stale build
    is reused."""
    (tmp_path / "a.cu").write_text('#include "rule.cuh"\n')
    (tmp_path / "rule.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("a.cu")
    (tmp_path / "rule.cuh").write_text("// v2\n")
    assert _build.library_path("a.cu") != before
    (tmp_path / "rule.cuh").write_text("// v1\n")
    assert _build.library_path("a.cu") == before
