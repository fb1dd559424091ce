"""The fused dim-2 route of the float64 solve on the CPU
(`ops/cuda_solver.py`): which solves take it (`fused_stages`, a pure
function of the device, type, asset count, grid width and meshes), the
plumbing of `_full_solve` through it (forced onto the CPU) against the
composed route, the widest bracket it folds, the device count's refusal
of a day mesh, and the launchers it registers. The kernel itself runs on
the card only (`tests/test_torch_cuda_kernels.py`)."""

import numpy as np
import pytest
import torch

from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.parallel.mesh import DayMesh

F64, F32 = torch.float64, torch.float32
CFG = (-3.0, -3.5, -2.0, -5.0, 0.0)
MESH = object()  # any mesh: the route looks only at whether there is one


@pytest.mark.parametrize("device, dtype, dim, n, reducer, grid, fused", [
    ("cuda", F64, 2, 100, None, None, True),
    ("cuda:0", F64, 2, 169, None, None, True),
    (torch.device("cuda", 1), F64, 2, 2, None, None, True),
    ("cuda", F64, 2, 170, None, None, False),  # K2 sweeps bisect it
    ("cuda", F64, 2, 1024, None, None, False),
    ("cuda", F32, 2, 100, None, None, False),  # the f32 engine
    ("cpu", F64, 2, 100, None, None, False),
    ("cuda", F64, 3, 100, None, None, False),
    ("cuda", F64, 4, 32, None, None, False),
    ("cuda", F64, 2, 100, MESH, None, False),  # a day mesh: a global MAX
    ("cuda", F64, 2, 100, None, MESH, False),  # a grid mesh: summed sweeps
    ("cuda", F64, 2, 100, MESH, MESH, False),
], ids=["flagship", "k1_edge", "tiny", "past_k1", "widest", "f32", "cpu",
        "dim3", "dim4", "day_mesh", "grid_mesh", "both_meshes"])
def test_fused_route_choice(device, dtype, dim, n, reducer, grid, fused):
    assert cs.fused_stages(device, dtype, dim, n, reducer, grid) is fused


def _ops(T=5, n=24, q=3, seed=0, edit=None):
    """Random MSM day operands on the CPU (no prefix table)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-5.0, 5.0, n))
    dx = np.diff(x, prepend=x[0] - 0.2)
    V = rng.gamma(2.0, 0.05, (T, n, n))
    if edit is not None:
        edit(V)
    dens = rng.uniform(0.0, 0.5, (2, q, n))
    fc = rng.dirichlet(np.ones(q * q), size=T)
    return cq.sweep_operands(*(torch.tensor(a) for a in (V, x, dx, dens, fc)))


def _rows(L, shared, seed=1):
    rng = np.random.default_rng(seed)
    obj = torch.tensor(rng.choice([0.01, 0.05, 0.1, 0.2], L))
    w = rng.uniform(0.1, 0.9, (L, 1))
    w = torch.tensor(np.concatenate([w, 1.0 - w], axis=1))
    return obj, (w[0] if shared else w)


def test_fused_plumbing_of_full_solve(monkeypatch):
    """`_full_solve` on the fused route (forced onto the CPU): shared
    weights (2,) become (L, 2) rows for one `solve_stages` call, whose
    state and widest bracket go to the bisection, and a NaN cell in two
    days' stage slabs flags those days. Roots and NaN days are the
    composed route's bits, and the widest bracket handed on is the
    composed state's max(upper - lower)."""
    def edit(V):
        V[:2, 2, 6] = np.nan

    ops = _ops(edit=edit)
    obj, weights = _rows(3, shared=True)
    want = cs.full_solve_levels(ops, obj, weights, CFG, quirks=True)
    state, _ = cs._stages(ops, obj, weights, CFG, True, -5.0,
                          cq.masked_sweep_reference, F64)
    seen = {"stages": [], "widest": []}
    stages, bisect = cs.solve_stages, cs.bisect_levels

    def counted(ops_, obj_, weights_, *args, **kwargs):
        seen["stages"].append(tuple(weights_.shape))
        return stages(ops_, obj_, weights_, *args, **kwargs)

    def bisect_seen(*args, widest=None, **kwargs):
        seen["widest"].append(widest)
        return bisect(*args, widest=widest, **kwargs)

    monkeypatch.setattr(cs, "fused_stages", lambda *a, **k: True)
    monkeypatch.setattr(cs, "solve_stages", counted)
    monkeypatch.setattr(cs, "bisect_levels", bisect_seen)
    roots, nan = cs.full_solve_levels(ops, obj, weights, CFG, quirks=True)
    assert seen["stages"] == [(3, 2)]
    assert len(seen["widest"]) == 1
    assert torch.equal(seen["widest"][0],
                       (state[1] - state[0]).max().reshape(1))
    assert bool(nan[:, :2].all()) and not bool(nan[:, 2:].any())
    assert torch.equal(nan, want[1]) and torch.equal(roots, want[0])


@pytest.mark.parametrize("lower, upper, widest", [
    ([[-7.5, -3.5]], [[-3.5, -3.0]], 4.0),
    ([[-3.0, -2.0]], [[-3.5, -2.5]], 0.0),  # every width negative: 0
    ([[-3.0, -2.0]], [[float("nan"), -1.0]], float("nan")),
])
def test_widest_bracket(lower, upper, widest):
    """max(upper - lower) and at least 0, NaN when a width is NaN, as the
    kernel folds it; 0 for no day."""
    got = cs._widest(torch.tensor(lower), torch.tensor(upper))
    assert got.shape == (1,)
    assert torch.equal(got, torch.tensor([widest])) or (
        np.isnan(widest) and bool(torch.isnan(got).all()))
    assert cs.halvings(float(got), 1e-6) == (
        0 if not widest > 1e-6 else cs.halvings(widest, 1e-6))


def test_widest_bracket_of_no_day():
    empty = torch.empty((2, 0), dtype=F64)
    assert torch.equal(cs._widest(empty, empty), torch.zeros(1, dtype=F64))


def test_device_count_refuses_a_day_mesh():
    ops = _ops()
    obj, weights = _rows(2, False)
    *state, _, widest = cs.solve_stages(ops, obj, weights, CFG)
    with pytest.raises(ValueError, match="global MAX"):
        cs.bisect_levels(ops, *state, obj, weights, 1e-6,
                         reducer=DayMesh(None, 0, 1, "cpu"), widest=widest)


def test_the_fused_route_launchers_are_f64_only():
    """The fused route's two C launchers are registered with their
    arguments, in float64 alone."""
    fns = _build.SOURCES["quadrature.cu"]
    assert len(fns["cvt_solve_stages"]) == 24
    assert len(fns["cvt_bisect_levels_widest"]) == 20
    assert len(fns["cvt_bisect_levels"]) == 19
    assert "cvt_solve_stages_f32" not in fns
    assert "cvt_bisect_levels_widest_f32" not in fns
    assert "cvt_bisect_levels_f32" in fns
