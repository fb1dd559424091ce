"""Port parity: `copula_var_tpu_torch.ops.quadrature` and the sweep wrapper
against the JAX package (CPU). Masks are held bit for bit; densities and
cached sweeps at float64 rtol 1e-12; whole day tensors at 1e-10 (see
RTOL_PHI); the Pallas kernels K2/K3 run in interpret mode at float32 and
are held at rtol 1e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copula_var_tpu.ops import pallas_quadrature as jpq
from copula_var_tpu.ops import quadrature as jq
from copula_var_tpu.ops.grids import msm_grid
from copula_var_tpu_torch.ops import cuda_quadrature as cq
from copula_var_tpu_torch.ops import quadrature as tq

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
RTOL = 1e-12
WEIGHTS = np.array([0.3, 0.7])  # unequal: exposes the weights pairing


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _specs(kind):
    corr = np.array([[1.0, 0.6], [0.6, 1.0]])
    if kind == "gaussian":
        return jq.CopulaSpec("gaussian", (jnp.asarray(corr),)), \
            tq.CopulaSpec("gaussian", (_t(corr),))
    if kind == "student":
        return jq.CopulaSpec("student", (6.5, jnp.asarray(corr))), \
            tq.CopulaSpec("student", (6.5, _t(corr)))
    return jq.CopulaSpec("plackett", (4.0,)), tq.CopulaSpec("plackett", (4.0,))


def _msm_inputs(rng, T=10, n=32, q=5):
    x, dx = msm_grid(n)
    vols = np.sort(rng.uniform(0.4, 2.5, (2, q)), axis=1)
    dens = np.exp(-0.5 * (x / vols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * vols[:, :, None])
    fbs = rng.dirichlet(np.ones(q), size=(T, 2))
    fc = rng.dirichlet(np.ones(q * q), size=T)
    return x, dx, dens, vols, fbs, fc


def _bounds(rng, T):
    lo = rng.uniform(-8.0, -1.0, T)
    return np.stack([lo, lo + rng.uniform(0.05, 4.0, T)], axis=-1)


def test_halfspace_mask_matches_jax_bitwise(rng):
    x, _ = msm_grid(40)
    b = _bounds(rng, 30)
    b[:5] = np.stack([x[2:7], x[12:17]], axis=-1)  # bounds on grid values
    for w in (WEIGHTS, np.array([0.5, 0.5]), np.array([0.8, 0.2])):
        got = tq.halfspace_mask(_t(x), _t(b[:, 0]), _t(b[:, 1]), _t(w))
        want = np.stack([
            np.asarray(jq.halfspace_mask(x, lo, up, w)) for lo, up in b
        ])
        np.testing.assert_array_equal(got.numpy(), want)


# Day tensors end to end: XLA's and PyTorch's erf/erfc round Phi
# differently in the last bit, and norm_ppf / t_ppf magnify a one-ulp
# change in a marginal u near 1 by ~ulp / (1 - u) (1 - u ~ 3e-7 at x = 5,
# vol = 1 on the flagship grid). Measured: 8e-11 relative on the flagship
# MSM tensors, in tail-corner cells only. Given the SAME marginal columns
# the density is held at 1e-12 (test_grid_density_matches_jax); cells
# below 1e-15 carry no quadrature mass at this grid's scale.
RTOL_PHI = 1e-10


@pytest.mark.parametrize("kind", ["gaussian", "student", "plackett"])
def test_grid_density_matches_jax(rng, kind):
    u = rng.uniform(1e-9, 1 - 1e-9, (6, 2, 40))
    u[:, :, :3] = rng.uniform(0.4, 0.6, (6, 2, 3))
    jspec, tspec = _specs(kind)
    got = tq.grid_copula_density(_t(u), tspec).numpy()
    want = np.stack([np.asarray(jq.grid_copula_density(d, jspec)) for d in u])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", ["gaussian", "student", "plackett"])
def test_day_tensors_match_jax(rng, kind):
    x, _, _, vols, fbs, _ = _msm_inputs(rng)
    jspec, tspec = _specs(kind)
    got = tq.msm_day_tensors(_t(fbs), _t(x), _t(vols), tspec).numpy()
    want = np.asarray(jq.msm_day_tensors(fbs, x, vols, jspec))
    np.testing.assert_allclose(got, want, rtol=RTOL_PHI, atol=1e-15)
    fv = rng.uniform(0.5, 2.0, (10, 2))
    got = tq.garch_day_tensors(_t(fv), _t(x), tspec).numpy()
    want = np.asarray(jq.garch_day_tensors(fv, x, jspec))
    np.testing.assert_allclose(got, want, rtol=RTOL_PHI, atol=1e-15)


def _flagship(est, days):
    z = np.load(os.path.join(DATA, f"flagship_artifacts_{est}.npz"))
    ii = {k[3:]: z[k] for k in z.files if k.startswith("ii_")}
    for k in ("forecasts_by_states", "forecast_combos", "forecast_vols"):
        if k in ii:
            ii[k] = ii[k][:days]
    import json

    cf = json.loads(str(z["meta"]))["copula_fit"]
    corr = np.asarray(cf["corr_matrix"])
    return ii, (jq.CopulaSpec("student", (cf["nu"], jnp.asarray(corr))),
                tq.CopulaSpec("student", (cf["nu"], _t(corr))))


def test_flagship_day_tensors_match_jax():
    """The flagship inputs (n = 100, Student copula), first 8 days."""
    ii, (jspec, tspec) = _flagship("msm", 8)
    got = tq.msm_day_tensors(_t(ii["forecasts_by_states"]), _t(ii["x"]),
                             _t(ii["unique_vols"]), tspec).numpy()
    want = np.asarray(jq.msm_day_tensors(ii["forecasts_by_states"], ii["x"],
                                         ii["unique_vols"], jspec))
    np.testing.assert_allclose(got, want, rtol=RTOL_PHI, atol=1e-15)
    ii, (jspec, tspec) = _flagship("garch", 8)
    got = tq.garch_day_tensors(_t(ii["forecast_vols"]), _t(ii["x"]),
                               tspec).numpy()
    want = np.asarray(jq.garch_day_tensors(ii["forecast_vols"], ii["x"],
                                           jspec))
    np.testing.assert_allclose(got, want, rtol=RTOL_PHI, atol=1e-15)


def _cached_case(rng):
    x, dx, dens, vols, fbs, fc = _msm_inputs(rng)
    jspec, tspec = _specs("student")
    C = np.asarray(jq.msm_day_tensors(fbs, x, vols, jspec))
    V = np.asarray(jq.garch_day_tensors(rng.uniform(0.5, 2.0, (10, 2)), x,
                                        jspec))
    return x, dx, dens, fc, C, V


def test_cached_sweeps_match_jax(rng):
    x, dx, dens, fc, C, V = _cached_case(rng)
    b = _bounds(rng, C.shape[0])
    got = tq.msm_integrals_cached(_t(b), _t(C), _t(fc), _t(x), _t(dx),
                                  _t(dens), _t(WEIGHTS)).numpy()
    want = np.asarray(jq.msm_integrals_cached(b, C, fc, x, dx, dens,
                                              jnp.asarray(WEIGHTS)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)
    got = tq.garch_integrals_cached(_t(b), _t(V), _t(x), _t(dx),
                                    _t(WEIGHTS)).numpy()
    want = np.asarray(jq.garch_integrals_cached(b, V, x, dx,
                                                jnp.asarray(WEIGHTS)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


def test_sweep_matches_pallas_kernels_interpret(rng):
    """The plain sweep against K3 (`masked_sandwich_integrals`, one day
    per program) and K2 (`masked_sandwich_integrals_blocked`, 8 days per
    program), both float32 in interpret mode."""
    x, dx, dens, fc, C, V = _cached_case(rng)
    T = C.shape[0]
    b = _bounds(rng, T)
    w0, w1 = dens[1] * dx, dens[0] * dx
    ops = cq.sweep_operands(_t(C), _t(x), _t(dx), _t(dens), _t(fc))
    got = cq.masked_sweep_reference(ops, _t(b)[None], _t(WEIGHTS)[None])[0]
    for fn in (jpq.masked_sandwich_integrals,
               lambda *a, **k: jpq.masked_sandwich_integrals_blocked(
                   *a, day_block=8, **k)):
        want = np.asarray(fn(b, C, w0, w1, fc, x, WEIGHTS, interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    ops = cq.sweep_operands(_t(V), _t(x), _t(dx))
    got = cq.masked_sweep_reference(ops, _t(b)[None], _t(WEIGHTS)[None])[0]
    want = np.asarray(jpq.masked_sandwich_integrals_blocked(
        b, V, dx[None], dx[None], np.ones((T, 1)), x, WEIGHTS,
        interpret=True, day_block=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_kernel_operand_form_matches_cached_sweep(rng, family):
    """The algebra the CUDA sweep kernel evaluates, written in PyTorch:
    sum over masked cells of U = V .* (wfc W1), with the hoisted
    wfc = W0^T FC. It must equal the cached sweep."""
    x, dx, dens, fc, C, V = _cached_case(rng)
    if family == "msm":
        ops = cq.sweep_operands(_t(C), _t(x), _t(dx), _t(dens), _t(fc))
    else:
        ops = cq.sweep_operands(_t(V), _t(x), _t(dx))
    assert ops.wfc.shape[-1] == ops.w1.shape[0] == (5 if family == "msm"
                                                    else 1)
    b = _t(_bounds(rng, C.shape[0]))
    U = ops.V * torch.einsum("tik,kj->tij", ops.wfc, ops.w1)
    M = tq.halfspace_mask(ops.x, b[:, 0], b[:, 1], _t(WEIGHTS))
    emulated = torch.where(M, U, torch.zeros(())).sum(dim=(1, 2))
    plain = cq.masked_sweep_reference(ops, b[None], _t(WEIGHTS)[None])[0]
    np.testing.assert_allclose(emulated.numpy(), plain.numpy(), rtol=RTOL,
                               atol=1e-15)


def test_masked_sweep_dispatches_cpu_to_plain_twin(rng):
    x, dx, dens, fc, C, _ = _cached_case(rng)
    ops = cq.sweep_operands(_t(C), _t(x), _t(dx), _t(dens), _t(fc))
    T = C.shape[0]
    b = _t(np.stack([_bounds(rng, T) for _ in range(3)]))
    w = _t([[0.5, 0.5], [0.3, 0.7], [0.9, 0.1]])
    before = cq.launch_count(cq.masked_sweep)
    got = cq.masked_sweep(ops, b, w)
    assert cq.launch_count(cq.masked_sweep) == before  # no kernel on the CPU
    assert got.shape == (3, T)
    for l in range(3):
        row = tq.msm_integrals_cached(b[l], ops.V, ops.forecast_combos,
                                      ops.x, ops.dx, ops.densities, w[l])
        np.testing.assert_array_equal(got[l].numpy(), row.numpy())


def test_masked_sweep_rejects_other_devices(rng):
    x, dx, dens, fc, C, _ = _cached_case(rng)
    ops = cq.sweep_operands(_t(C), _t(x), _t(dx), _t(dens), _t(fc))
    meta = cq.SweepOperands(*[
        t.to("meta") if torch.is_tensor(t) else t for t in ops
    ])
    with pytest.raises(ValueError, match="unsupported device"):
        cq.masked_sweep(meta, torch.zeros((1, C.shape[0], 2), device="meta"),
                        torch.zeros((1, 2), device="meta"))
