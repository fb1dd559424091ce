"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports neither JAX nor the JAX package, so it runs where JAX is not
installed (the repository's conftest imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from copula_var_tpu_torch.data import from_csv
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import cuda_solver as cs
from copula_var_tpu_torch.ops.solvers import bracket_state_batched
from copula_var_tpu_torch.utils.artifacts import load_artifacts

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
CFG = (-3.0, -3.5, -2.0, -7.5, 0.0)
# kernel and plain sweep sum the same float64 terms in different orders
RTOL_SWEEP = 1e-12
# identical masks and bookkeeping: a root moves only if rounding of a
# slab flipped res < obj
ATOL_ROOT = 1e-9


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _ops(dev, family, T=37, n=48, q=5, seed=0):
    """Random day operands on the card; n not a multiple of 32."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), device=dev)

    x = np.sort(rng.uniform(-5.0, 5.0, n))
    dx = np.diff(x, prepend=x[0] - 0.2)
    V = rng.gamma(2.0, 0.05, (T, n, n))
    if family == "garch":
        return cq.sweep_operands(t(V), t(x), t(dx))
    dens = rng.uniform(0.0, 0.5, (2, q, n))
    fc = rng.dirichlet(np.ones(q * q), size=T)
    return cq.sweep_operands(t(V), t(x), t(dx), t(dens), t(fc))


def _rows(dev, T, L, seed=1):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-8.0, -1.0, (L, T))
    b = np.stack([lo, lo + rng.uniform(0.0, 4.0, (L, T))], -1)
    w = rng.uniform(0.1, 0.9, (L, 1))
    w = np.concatenate([w, 1.0 - w], axis=1)  # unequal weights per row
    return (torch.tensor(b, device=dev), torch.tensor(w, device=dev))


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_masked_sweep_matches_plain(dev, family):
    ops = _ops(dev, family)
    bounds, weights = _rows(dev, ops.V.shape[0], 6)
    before = cq.masked_sweep.launches
    got = cq.masked_sweep(ops, bounds, weights)
    assert cq.masked_sweep.launches == before + 1
    want = cq.masked_sweep_reference(ops, bounds, weights)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL_SWEEP * scale


def test_masked_sweep_nan_cell_poisons_only_its_slabs(dev):
    ops = _ops(dev, "msm", T=8)
    V = ops.V.clone()
    V[:, 5, 5] = float("nan")  # inside some random slabs, outside others
    ops = cq.sweep_operands(V, ops.x, ops.dx, ops.densities,
                            ops.forecast_combos)
    bounds, weights = _rows(dev, 8, 6)
    got = cq.masked_sweep(ops, bounds, weights)
    want = cq.masked_sweep_reference(ops, bounds, weights)
    assert bool(torch.isnan(want).any()) and not bool(torch.isnan(want).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert float((got[fin] - want[fin]).abs().max()) <= \
        RTOL_SWEEP * float(want[fin].abs().max())


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_bisect_levels_matches_plain(dev, family):
    ops = _ops(dev, family)
    T = ops.V.shape[0]
    _, weights = _rows(dev, T, 4)
    obj = torch.tensor([0.01, 0.05, 0.1, 0.2], dtype=torch.float64,
                       device=dev)
    stage1 = torch.tensor([-100.0, CFG[0]], dtype=torch.float64,
                          device=dev).expand(4, T, 2).contiguous()
    F1 = cq.masked_sweep(ops, stage1, weights)
    state = [s.contiguous() for s in bracket_state_batched(
        F1, obj, lambda b: cq.masked_sweep(ops, b.contiguous(), weights),
        CFG, False)[:5]]
    before = cs.bisect_levels.launches
    got = cs.bisect_levels(ops, *state, obj, weights, 1e-6)
    assert cs.bisect_levels.launches == before + 1
    want = cs.bisect_levels_reference(ops, *state, obj, weights, 1e-6)
    assert float((got - want).abs().max()) <= ATOL_ROOT


@pytest.mark.parametrize("est", ["msm", "garch"])
def test_flagship_through_kernels(dev, est):
    rec = np.load(os.path.join(DATA, "flagship_var.npz"))
    data = from_csv(os.path.join(DATA, "flagship.csv"), n_insample=1135)
    bt = load_artifacts(os.path.join(DATA, f"flagship_artifacts_{est}.npz"),
                        data, device="cuda")
    before = (cq.masked_sweep.launches, cs.bisect_levels.launches)
    var = bt.calc_var(float(rec["obj_var"]))
    assert cq.masked_sweep.launches > before[0]
    assert cs.bisect_levels.launches > before[1]
    np.testing.assert_allclose(var, rec[f"{est}_var"], rtol=0,
                               atol=ATOL_ROOT)


def test_kernels_reject_what_they_do_not_take(dev):
    ops = _ops(dev, "garch", T=2, n=200)  # U would not fit shared memory
    bounds, weights = _rows(dev, 2, 1)
    with pytest.raises(ValueError, match="shared"):
        cq.masked_sweep(ops, bounds, weights)
    ops = _ops(dev, "garch", T=2)
    strided = torch.zeros((1, 2, 4), dtype=torch.float64, device=dev)[..., ::2]
    strided.copy_(bounds)
    with pytest.raises(ValueError, match="contiguous"):
        cq.masked_sweep(ops, strided, weights)
    with pytest.raises(ValueError, match="float64"):
        cq.masked_sweep(ops, bounds.float(), weights)
