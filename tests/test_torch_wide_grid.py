"""Grids wider than the flagship's on the CPU: the routes the card takes
by width and memory (`cuda_solver.dim2_bisect_route`,
`cuda_quadrature3.contract3_route`, pure functions of the shapes and the
free bytes) at their edges, the rebuild kernel's tiling modelled in
PyTorch against the JAX package, and the port's CPU path against the
JAX-written record `data/wide_grid_var.npz`
(`examples/make_wide_grid_records.py`): dim 2 at n = 200 and dim 3 at
n = 180, on 2 days each, at 1e-9. The integration inputs the record
stores at each width are the port's own from the artifacts' fits."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu_torch import backtest as tbt
from copula_var_tpu_torch.data import from_csv, from_returns
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops import quadrature as tq
from copula_var_tpu_torch.utils.artifacts import load_artifacts

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
N_IN = 1135
ATOL_VAR = 1e-9  # the flagship record's bar (tests/test_flagship.py:63)
RTOL = 1e-12  # the port's parity bar for sweeps and inputs
BIG = 1 << 40  # free bytes that hold any table here


def _record():
    return np.load(os.path.join(DATA, "wide_grid_var.npz"))


# -- the routes, at their edges -----------------------------------------------

@pytest.mark.parametrize("n, route", [(100, "k1"), (169, "k1"),
                                      (170, "sweeps"), (192, "sweeps"),
                                      (193, "sweeps"), (1024, "sweeps")])
def test_dim2_route_by_width(n, route):
    """K1 holds a day of n <= 169 in shared memory; wider grids bisect
    by K2 sweeps, whose rows reach 1024 cells (192 before)."""
    assert cs.dim2_bisect_route(n) == route


def test_dim2_limits():
    assert cq.bisect_max_grid_points() == 169
    assert cq.bisect_shared_bytes(169) <= cq.MAX_SHARED_BYTES
    assert cq.bisect_shared_bytes(170) > cq.MAX_SHARED_BYTES
    assert cq.SWEEP_MAX_GRID_POINTS == 1024
    # P at n = 406, T = 500: 661 MB, and its flags
    assert cq.prefix_table_bytes(500, 406) == 500 * 406 * (407 * 8 + 1)
    cq.require_prefix_table_fits(500, 100, cq.prefix_table_bytes(500, 100))
    with pytest.raises(RuntimeError, match="prefix table P .* 40450000 "
                                           "bytes .* 40449999 bytes are free"):
        cq.require_prefix_table_fits(500, 100, 40_449_999)


def test_limits_have_one_home():
    """The routes' limits are the ones `_build` compiles into the kernels:
    passed to nvcc as defines, and written nowhere in csrc."""
    from copula_var_tpu_torch.ops import _build

    flags = set(_build.NVCC_FLAGS)
    assert {f"-DCVT_MAX_SHARED_BYTES={cq.MAX_SHARED_BYTES}",
            f"-DCVT_SHORT_CHUNKS={cq.BISECT_MAX_ROW // 32}",
            f"-DCVT_MAX_CHUNKS={cq.SWEEP_MAX_GRID_POINTS // 32}"} <= flags
    assert (cq.MAX_SHARED_BYTES, cq.BISECT_MAX_ROW,
            cq.SWEEP_MAX_GRID_POINTS) == (232448, 192, 1024)
    for src in _build.CSRC.glob("*.cu*"):
        text = src.read_text()
        assert str(cq.MAX_SHARED_BYTES) not in text, src.name
        assert "cvt_max_grid_points" not in text, src.name


def test_dim2_operands_past_the_rule_raise():
    f64 = dict(dtype=torch.float64)
    ops = cq.SweepOperands(torch.zeros((1, 1025, 1025), **f64),
                           torch.linspace(-5, 5, 1025, **f64),
                           torch.ones(1025, **f64), None, None,
                           torch.zeros((1, 1025, 1), **f64),
                           torch.zeros((1, 1025), **f64))
    with pytest.raises(ValueError, match="n <= 1024"):
        cq.check_day_operands(ops)


@pytest.mark.parametrize("T, n, q, rows, free, route", [
    (500, 169, 5, None, BIG, "table"),
    (500, 170, 5, None, BIG, "rebuild"),
    (500, 192, 5, None, BIG, "rebuild"),
    (500, 193, 5, None, BIG, "rebuild"),
    (500, 100, 5, None, 4_040_000_000, "table"),  # U exactly fits
    (500, 100, 5, None, 4_039_999_999, "rebuild"),  # one byte short
    (500, 100, 5, 25, 1_010_000_000, "table"),  # a grid rank's 25 slabs
    (2000, 169, 5, None, 80_000_000_000, "table"),  # U 77.2 GB fits
    (2100, 169, 5, None, 80_000_000_000, "rebuild"),  # U 81.1 GB
    (8, 300, 5, None, BIG, "rebuild"),
    (8, 1024, 5, None, BIG, "rebuild"),
])
def test_dim3_route(T, n, q, rows, free, route):
    """The table where its sweep takes n (169 at q = 5) and U fits in the
    free bytes, else the rebuild kernel."""
    assert cq3.contract3_route(T, n, q, rows, free) == route


def test_dim3_route_refuses_past_the_interval_rule():
    with pytest.raises(ValueError, match="n <= 1024"):
        cq3.contract3_route(8, 1025, 5, None, BIG)


@pytest.mark.parametrize("n, q, tile", [(2, 5, 64), (100, 5, 64),
                                        (300, 5, 64), (406, 5, 64),
                                        (420, 5, 32), (1024, 5, 16),
                                        (1024, 1, 16), (1024, 16, 8)])
def test_rebuild_tiles(n, q, tile):
    """64 rows a block (the table sweep's lookup span) while they fit in
    shared memory with x and the (q, n) fold, then halves."""
    assert cq3.rebuild_tile_rows(n, q) == tile


@pytest.mark.parametrize("q", [1, 5, 16])
def test_table_limit(q):
    """One padded slab, x and the flags in a block's shared memory: 169."""
    assert cq3.table_max_grid_points(q) == 169


# -- the rebuild kernel's tiling, modelled in PyTorch ---------------------------

def _rule_rows(rows, x, dlo, dup):
    """interval.cuh's row sum: prefix difference, NaN bounds 0."""
    S0 = torch.cat([torch.zeros_like(rows[..., :1]),
                    torch.cumsum(rows, dim=-1)], dim=-1)
    hi = torch.searchsorted(x, dup.contiguous(), right=True)
    lo = torch.searchsorted(x, dlo.contiguous(), right=True)
    out = (torch.gather(S0, -1, hi[..., None])
           - torch.gather(S0, -1, lo[..., None]))[..., 0]
    out = torch.where(hi > lo, out, torch.zeros_like(out))
    return torch.where(torch.isnan(dlo) | torch.isnan(dup),
                       torch.zeros_like(out), out)


def rebuild_model(ops, bounds, w, tile_rows, box_min=-5.0):
    """(T,) as the rebuild kernel sums one bound row: per (t, i0) slab the
    cells of U, per tile of `tile_rows` i1 rows one partial (each row's
    masked sum read off its prefix sums), the partials added in (i0,
    tile) order."""
    U = cq3.contract3_weights_reference(ops)  # (T, n, n, n)
    x = ops.x
    n = x.shape[0]
    prev = x[:, None] * w[1] + x[None, :] * w[2]  # (i0, i1)
    dup = (bounds[:, 1, None, None] - prev) / w[0]
    dlo = torch.maximum((bounds[:, 0, None, None] - prev) / w[0],
                        torch.tensor(box_min, dtype=torch.float64))
    rows = _rule_rows(U, x, dlo, dup)  # (T, i0, i1)
    tiles = [rows[:, :, s:s + tile_rows].sum(dim=-1)
             for s in range(0, n, tile_rows)]
    partial = torch.stack(tiles, dim=-1).reshape(rows.shape[0], -1)
    return partial.sum(dim=-1)


def _case3(n=24, T=4, q=2, seed=5):
    rng = np.random.default_rng(seed)
    x, dx = msm_grid(n)
    vols = np.sort(rng.uniform(0.5, 2.0, (3, q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    fbs = rng.dirichlet(np.ones(q), size=(T, 3))
    fc = rng.dirichlet(np.ones(q ** 3), size=T)
    corr = np.array([[1.0, 0.45, 0.25], [0.45, 1.0, 0.35],
                     [0.25, 0.35, 1.0]])
    lo = rng.uniform(-6.0, -0.5, T)
    bounds = np.stack([lo, lo + rng.uniform(0.5, 4.0, T)], -1)
    return dict(x=x, dx=dx, vols=vols, dens=dens, fbs=fbs, fc=fc, corr=corr,
                bounds=bounds)


@pytest.mark.parametrize("tile_rows", [8, 64])
def test_rebuild_tiling_matches_jax(tile_rows):
    """Summed tile by tile, as the rebuild kernel sums, the masked cells
    of U equal the JAX transform-cached sweep (n = 24: three 8-row tiles,
    or one partial 64-row tile)."""
    c = _case3()
    t = torch.tensor
    tspec = tq.CopulaSpec("student", (6.5, t(c["corr"])))
    jspec = jq.CopulaSpec("student", (6.5, jnp.asarray(c["corr"])))
    cols = tq.msm_day_columns(t(c["fbs"]), t(c["x"]), t(c["vols"]), tspec)
    ops = cq3.contract3_operands(cols, t(c["x"]), t(c["dx"]), tspec,
                                 densities=t(c["dens"]),
                                 forecast_combos=t(c["fc"]))
    jcols = jq.msm_day_columns(c["fbs"], c["x"], c["vols"], jspec)
    for w in ([0.5, 0.3, 0.2], [0.2, 0.5, 0.3]):
        got = rebuild_model(ops, t(c["bounds"]), t(w), tile_rows)
        want = np.asarray(jq.msm_integrals_tcached(
            c["bounds"], jcols, c["fc"], c["x"], c["dx"], c["dens"],
            np.asarray(w), jspec))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


# -- the record: JAX's xla engine at wide grids --------------------------------

CASES = {2: ("flagship.csv", "flagship_artifacts", None),
         3: ("dim3.csv", "dim3_artifacts", "weights3")}


def _wide_backtest(dim, est, n, days):
    """The port's CPU backtest of the record's series `dim{dim}_{est}_n{n}`
    on its first `days` days: the artifact's fits, the record's inputs at
    that width."""
    rec = _record()
    csv, prefix, wkey = CASES[dim]
    w = None if wkey is None else tuple(rec[wkey])
    data = from_csv(os.path.join(DATA, csv), n_insample=N_IN, weights=w)
    base = load_artifacts(os.path.join(DATA, f"{prefix}_{est}.npz"), data,
                          device="cpu")
    cls = (tbt.MsmIntegrationInputs if est == "msm"
           else tbt.GarchIntegrationInputs)
    tag = f"dim{dim}_{est}_n{n}"
    inputs = cls(*[rec[f"{tag}_ii_{f}"][:days] if f in tbt._DAY_FIELDS
                   else rec[f"{tag}_ii_{f}"] for f in cls._fields])
    cut = from_returns(data.returns[:N_IN + days], data.tickers, N_IN,
                       weights=w)
    return tbt.VaRBacktest(cut, base.adapter, base.copula, base.copula_fit,
                           base.model_fits, inputs, num_points=n,
                           device="cpu"), rec[f"{tag}_var"][:days]


@pytest.mark.parametrize("dim, n", [(2, 200), (3, 180)])
@pytest.mark.parametrize("est", ["msm", "garch"])
def test_wide_grid_record_on_the_cpu(dim, n, est):
    bt, want = _wide_backtest(dim, est, n, days=2)
    got = bt.calc_var(float(_record()["obj_var"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_VAR)


@pytest.mark.parametrize("dim, n", [(2, 400), (3, 300)])
@pytest.mark.parametrize("est", ["msm", "garch"])
def test_wide_grid_inputs_are_the_ports(dim, n, est):
    """The record's inputs at each width are what the port's adapter
    builds from the artifact's fits on the same windows."""
    rec = _record()
    days = int(rec[f"dim{dim}_days"])
    bt, _ = _wide_backtest(dim, est, n, days)
    windows = bt.data.rolling_windows()
    got = bt.adapter.integration_inputs(windows, bt.model_fits, n,
                                        device="cpu")
    for field, value in got._asdict().items():
        np.testing.assert_allclose(
            np.asarray(value), rec[f"dim{dim}_{est}_n{n}_ii_{field}"],
            rtol=RTOL, atol=1e-300, err_msg=field)
