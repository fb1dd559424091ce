"""The solve's route (`ops/cuda_solver.py::route`, a pure function of the
device, type, asset count, grid width, table and meshes) and the fused
dim-2 route of the float64 solve on the CPU: the plumbing of
`_full_solve` through it (forced onto the CPU) against the composed
route, the widest bracket it folds, the device count's refusal of a day
mesh, and the launchers it registers. The kernel itself runs on the card
only (`tests/test_torch_cuda_kernels.py`)."""

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


@pytest.mark.parametrize(
    "device, dtype, dim, n, table, plain, reducer, grid, want", [
        ("cuda", F64, 2, 100, False, False, None, None,
         ("solve_stages", "masked_sweep", "k1", "device")),
        ("cuda:0", F64, 2, 169, False, False, None, None,
         ("solve_stages", "masked_sweep", "k1", "device")),
        (torch.device("cuda", 1), F64, 2, 2, False, False, None, None,
         ("solve_stages", "masked_sweep", "k1", "device")),
        # past K1's day: K2 sweeps bisect it
        ("cuda", F64, 2, 170, False, False, None, None,
         (None, "masked_sweep", "halvings", "host")),
        ("cuda", F64, 2, 1024, False, False, None, None,
         (None, "masked_sweep", "halvings", "host")),
        # the f32 engine: K1 in float32 for a fixed count
        ("cuda", F32, 2, 100, False, False, None, None,
         (None, "masked_sweep", "k1", "fixed")),
        ("cpu", F64, 2, 100, False, False, None, None,
         (None, "masked_sweep_reference", "while", "loop")),
        # the table U on one card: K4 on the device
        ("cuda", F64, 3, 100, True, False, None, None,
         ("solve_stages3", "masked_contract3", "k4", "device")),
        ("cuda", F64, 4, 32, False, False, None, None,
         (None, "tcached_sweep", "halvings", "host")),
        # a day mesh: K1 for a global MAX, read on the host
        ("cuda", F64, 2, 100, False, False, MESH, None,
         (None, "masked_sweep", "k1", "host")),
        # a grid mesh: summed sweeps
        ("cuda", F64, 2, 100, False, False, None, MESH,
         (None, "masked_sweep", "halvings", "host")),
        ("cuda", F64, 2, 100, False, False, MESH, MESH,
         (None, "masked_sweep", "halvings", "host")),
        ("cuda", F64, 2, 400, False, False, MESH, None,
         (None, "masked_sweep", "halvings", "host")),
        ("cuda", F64, 3, 100, False, False, None, None,
         (None, "masked_contract3_rebuild", "halvings", "host")),
        ("cuda", F64, 3, 100, True, False, MESH, None,
         (None, "masked_contract3", "halvings", "host")),
        ("cuda", F64, 3, 100, True, False, None, MESH,
         (None, "masked_contract3", "halvings", "host")),
        ("cuda", F64, 4, 32, False, False, MESH, MESH,
         (None, "tcached_sweep", "halvings", "host")),
        ("cuda", F32, 2, 192, False, False, None, None,
         (None, "masked_sweep", "k1", "fixed")),
        ("cuda", F32, 2, 193, False, False, None, None,
         (None, "masked_sweep", "fixed_halvings", "fixed")),
        ("cuda", F32, 2, 100, False, False, MESH, None,
         (None, "masked_sweep", "k1", "fixed")),
        ("cuda", F32, 3, 100, True, False, None, None,
         (None, "masked_contract3", "halvings", "host")),
        ("cuda", F32, 3, 193, False, False, MESH, None,
         (None, "masked_contract3_rebuild", "halvings", "host")),
        ("cuda", F64, 2, 100, False, True, None, None,
         (None, "masked_sweep_reference", "while", "loop")),
        ("cuda", F64, 3, 100, True, True, MESH, None,
         (None, "masked_contract3_reference", "while", "loop")),
        ("cuda", F64, 4, 32, False, True, None, MESH,
         (None, "tcached_sweep", "while", "loop")),
        ("cuda", F32, 2, 100, False, True, None, None,
         (None, "masked_sweep_reference", "fixed_halvings", "fixed")),
        ("cuda", F32, 3, 100, True, True, None, None,
         (None, "masked_contract3_reference", "while", "loop")),
        ("cpu", F64, 3, 100, False, False, MESH, None,
         (None, "masked_contract3_reference", "while", "loop")),
        ("cpu", F64, 2, 100, False, False, None, MESH,
         (None, "masked_sweep_reference", "while", "loop")),
        ("cpu", F32, 2, 300, False, False, MESH, None,
         (None, "masked_sweep_reference", "fixed_halvings", "fixed")),
        ("cpu", F32, 3, 100, False, False, None, None,
         (None, "masked_contract3_reference", "while", "loop")),
        ("cuda:0", F64, 3, 169, True, False, None, None,
         ("solve_stages3", "masked_contract3", "k4", "device")),
        ("cuda", F64, 3, 100, True, False, MESH, MESH,
         (None, "masked_contract3", "halvings", "host")),
        ("cuda", F32, 3, 100, True, False, MESH, None,
         (None, "masked_contract3", "halvings", "host")),
        ("cuda", F64, 3, 300, False, False, None, None,
         (None, "masked_contract3_rebuild", "halvings", "host")),
        ("cpu", F64, 3, 100, True, False, None, None,
         (None, "masked_contract3_reference", "while", "loop")),
    ], ids=["flagship", "k1_edge", "tiny", "past_k1", "widest", "f32", "cpu",
            "dim3", "dim4", "day_mesh", "grid_mesh", "both_meshes",
            "day_mesh_past_k1", "dim3_rebuild", "dim3_day_mesh",
            "dim3_grid_mesh", "dim4_both_meshes", "f32_k1_edge",
            "f32_past_k1", "f32_day_mesh", "f32_dim3", "f32_dim3_rebuild",
            "plain", "plain_dim3", "plain_dim4", "plain_f32",
            "plain_f32_dim3", "cpu_dim3", "cpu_grid_mesh", "cpu_f32",
            "cpu_f32_dim3", "dim3_table_edge", "dim3_both_meshes",
            "f32_dim3_day_mesh", "dim3_wide_rebuild", "cpu_dim3_table"])
def test_fused_route_choice(device, dtype, dim, n, table, plain, reducer,
                            grid, want):
    """Every row of the route table: the stages (a fused wrapper only for
    float64 operands on a CUDA device, on one card: `solve_stages` at dim
    2 on a grid K1 bisects, `solve_stages3` at dim 3 with the table U;
    else None, the composed stages), the sweep, the bisection and its
    count. f32 dim 3, either mesh and the rebuild (no U) keep the composed
    route."""
    stages, sweep, bisect, count = want
    assert cs.route(device, dtype, dim, n, table, plain, reducer, grid) == \
        cs.Route(stages and getattr(cs, stages), getattr(cs, sweep), bisect,
                 count)


@pytest.mark.parametrize("device, dtype, grid, match", [
    ("meta", F64, None, "unsupported device"),
    ("cuda", F32, MESH, "f32 engine"),
    ("cpu", F32, MESH, "f32 engine"),
])
def test_route_refusals(device, dtype, grid, match):
    """A device other than the CPU or CUDA, and the f32 engine on a grid
    mesh (the JAX package has none), raise."""
    with pytest.raises(ValueError, match=match):
        cs.route(device, dtype, 2, 100, grid=grid)


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
    want = cs.full_solve(ops, obj, weights, CFG, quirks=True)
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

    fused = cs.Route(counted, cq.masked_sweep_reference, "k1", "device")
    monkeypatch.setattr(cs, "route", lambda *a, **k: fused)
    monkeypatch.setattr(cs, "bisect_levels", bisect_seen)
    roots, nan = cs.full_solve(ops, obj, weights, CFG, quirks=True)
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
    """The fused routes' C launchers (two at dim 2, two at dim 3) are
    registered with their arguments, in float64 alone."""
    fns = _build.SOURCES["quadrature.cu"]
    assert len(fns["cvt_solve_stages"]) == 24
    assert len(fns["cvt_bisect_levels_widest"]) == 20
    assert len(fns["cvt_bisect_levels"]) == 19
    assert "cvt_solve_stages_f32" not in fns
    assert "cvt_bisect_levels_widest_f32" not in fns
    assert "cvt_bisect_levels_f32" in fns
    fns3 = _build.SOURCES["contract3.cu"]
    assert len(fns3["cvt_solve_stages3"]) == 25
    assert len(fns3["cvt_bisect3"]) == 24
    assert "cvt_solve_stages3_f32" not in fns3
    assert "cvt_bisect3_f32" not in fns3
    assert "cvt_masked_contract3_f32" in fns3
