"""In-sample volatility-model fits (counterpart of
`copula_var_tpu/models/fit.py`): the GARCH Newton sweep with BIC
selection and the MSM basin hop with its L-BFGS polish. The UKF EM fit
is not ported yet (ROADMAP.md queue 1); `UkfFit` stays so that saved
artifacts load.

  * GARCH: every asset x (p, q) pair x start is one row of a batched
    damped-Newton solve (`_newton_garch_assets`) with exact gradients and
    Hessians from autograd; BIC selection happens on the host
    (`garch/opti.py:89-181`).
  * MSM: the 10 b-grid starts of every asset advance in lockstep through
    the basin hop (one batched filter per hop), the top 3 starts per
    asset are polished by `box_lbfgs_batch`, and the start with the
    maximum true log-likelihood wins (`opti.py:25-139`; the reference's
    minimum-LL selection is a defect the JAX package fixes too).

Randomness comes from an explicit `torch.Generator` per asset on the work
device, seeded `seed + i`: a different stream from JAX's, so the two are
held to each other at the optimum, not along the trajectory.
`reference_quirks=True` (the reference's optimizer trajectories) is not
ported and raises.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from copula_var_tpu_torch.device import resolve_device, synchronize
from copula_var_tpu_torch.models import garch as garch_mod
from copula_var_tpu_torch.models import msm as msm_mod
from copula_var_tpu_torch.ops.lbfgs import box_lbfgs_batch

_QUIRKS_LATER = ("the reference_quirks optimizer trajectories are not "
                 "ported yet (ROADMAP.md queue 1, item 8)")


class GarchFit(NamedTuple):
    p: int
    q: int
    omega: float
    alpha: np.ndarray
    beta: np.ndarray
    nll: float
    bic: float
    params: np.ndarray  # packed [omega, alpha..., beta...]


class MsmFit(NamedTuple):
    m_0: float
    b: float
    gamma: float
    sigma: float
    log_likelihood: float


class UkfFit(NamedTuple):
    a: float
    l: float  # noqa: E741  (the model's own parameter name)
    q: float
    log_likelihood: float


# ---------------------------------------------------------------------------
# GARCH
# ---------------------------------------------------------------------------

# Damping of the Newton system: mu = 1e-10, x10 per failed factorization,
# up to 1e6 (the JAX while-loop's sequence, tried here all at once).
_MUS = [1e-10]
while _MUS[-1] < 1e6:
    _MUS.append(_MUS[-1] * 10.0)
# Backtracking: t = 1, 1/2, ... while the step is worse and t > 1e-8;
# t = 2^-27 is the first at or below 1e-8 and is taken unchecked.
_HALVINGS = 27


def _garch_nll_rows(x, returns, mask, extra, p_max):
    """Penalized NLL of padded candidate rows x (..., R, m) on series
    returns (R, N), inactive lags pinned by mask (R, m), the first
    extra (R,) observations chopped -> (..., R)."""
    xm = x * mask
    ok = xm[..., 1:].sum(-1) < 1.0
    s2 = garch_mod.conditional_variances(
        returns, xm[..., 0], xm[..., 1:1 + p_max], xm[..., 1 + p_max:])
    keep = torch.arange(returns.shape[-1], device=x.device) >= extra[:, None]
    terms = torch.log(2.0 * np.pi * s2) + (returns * returns) / s2
    ll = -0.5 * torch.sum(torch.where(keep, terms, torch.zeros_like(terms)),
                          -1)
    return torch.where(ok, -ll, torch.full_like(ll, 1e10))


def _newton_garch_assets(returns_a, inits_a, masks, extras, p_max, q_max,
                         max_iter, tol, eps):
    """Every asset x candidate row's damped-Newton solve in lockstep.
    returns_a (A, N), inits_a (A, C, m), masks (C, m), extras (C,), all
    on the work device. Returns (x (A, C, m), nll (A, C)).

    Per iteration and row: exact gradient and Hessian; a Cholesky of
    H + mu I with the first mu of 1e-10 x 10^k that factors (-g when none
    does); a backtracking search over t = 2^-j, all j evaluated in one
    batched call; renormalize alpha, beta when they sum above 1; the
    positivity floor eps + 1e-7; the step rejected unless it improves;
    stop when the step norm falls below tol (floored at 64 eps) or after
    max_iter steps. A stopped row keeps its x. One host read per
    iteration."""
    A, C, m = inits_a.shape
    dev, dt = returns_a.device, returns_a.dtype
    tol = max(float(tol), 64.0 * torch.finfo(dt).eps)
    floor = eps + 1e-7
    returns = returns_a.repeat_interleave(C, 0)  # (R, N), R = A*C
    mask = masks.repeat(A, 1)
    extra = extras.repeat(A)
    R = A * C

    def nll(x):
        return _garch_nll_rows(x, returns, mask, extra, p_max)

    def project(v):
        return torch.where(mask > 0, torch.clamp_min(v, floor),
                           torch.zeros_like(v))

    eye = torch.eye(m, dtype=dt, device=dev)
    mus = torch.tensor(_MUS, dtype=dt, device=dev)[:, None, None, None]
    ts = 0.5 ** torch.arange(_HALVINGS + 1, dtype=dt, device=dev)
    x = inits_a.reshape(R, m).clone()
    active = torch.ones(R, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = nll(xg)
            (g,) = torch.autograd.grad(f.sum(), xg, create_graph=True)
            (h,) = torch.autograd.grad(
                g, xg, grad_outputs=eye[:, None, :].expand(m, R, m),
                is_grads_batched=True)
        f_cur, g = f.detach(), g.detach()
        h = h.detach().transpose(0, 1)  # (R, m, m): h[r, j] = d g_j / dx
        h = torch.where(torch.isfinite(h), h, torch.zeros_like(h))
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        # damped Cholesky: the first mu whose factorization succeeds
        L, info = torch.linalg.cholesky_ex(h + mus * eye)
        ok = (info == 0) & torch.isfinite(L).all(-1).all(-1)  # (K, R)
        Ls = torch.where(ok[..., None, None], L, eye)
        d = -torch.cholesky_solve(g[None, :, :, None].expand(
            len(_MUS), R, m, 1), Ls)[..., 0]
        first = torch.argmax(ok.to(torch.int8), 0)
        delta = torch.where(ok.any(0)[:, None],
                            d[first, torch.arange(R, device=dev)], -g)
        # backtracking over every t at once: the first t whose projected
        # point is no worse, else 2^-27
        f_t = nll(project(x + ts[:, None, None] * delta))  # (J+1, R)
        better = ~(f_t[:-1] > f_cur)  # a NaN ends the search, as there
        j = torch.where(better.any(0),
                        torch.argmax(better.to(torch.int8), 0),
                        torch.full_like(first, _HALVINGS))
        x_new = x + ts[j][:, None] * delta
        s = torch.sum(torch.where(mask[:, 1:] > 0, x_new[:, 1:],
                                  torch.zeros_like(x_new[:, 1:])), -1)
        x_new = torch.cat([x_new[:, :1], torch.where(
            (s > 1.0)[:, None], x_new[:, 1:] / s[:, None], x_new[:, 1:])], 1)
        x_new = project(x_new)
        improved = nll(x_new) <= f_cur
        x_new = torch.where(improved[:, None], x_new, x)
        norm = torch.linalg.vector_norm(x_new - x, dim=-1)
        x = torch.where(active[:, None], x_new, x)
        active = active & (norm >= tol)
        if not bool(active.any()):
            break
    return x.reshape(A, C, m), nll(x).reshape(A, C)


def _garch_candidates(returns, p_max, q_max):
    """(inits, masks, extras, pairs): 3 starts per (p, q) pair, padded to
    (p_max, q_max) with inactive lags pinned at zero (`fit.py:203-240`)."""
    var = float(np.var(returns))
    m = 1 + p_max + q_max
    inits, masks, extras, pairs = [], [], [], []
    for p in range(1, p_max + 1):
        for q in range(1, q_max + 1):
            ab = 0.5 / (p + q)
            mask = np.zeros(m)
            mask[0] = 1.0
            mask[1:1 + p] = 1.0
            mask[1 + p_max:1 + p_max + q] = 1.0

            def pack(omega, a, b):
                x = np.zeros(m)
                x[0] = omega
                x[1:1 + p] = a
                x[1 + p_max:1 + p_max + q] = b
                return x

            # the reference's single init (`opti.py:103-104`), a
            # persistence-style init and a low-omega init
            for x0 in (
                pack(0.1, ab, ab),
                pack(0.05 * var, 0.1 / p, 0.85 / q),
                pack(0.01 * var, 0.05 / p, 0.9 / q),
            ):
                inits.append(x0)
                masks.append(mask)
                extras.append(max(p, q))
                pairs.append((p, q))
    return np.stack(inits), np.stack(masks), np.asarray(extras), pairs


def fit_garch(returns, p_max: int = 3, q_max: int = 3, tol: float = 1e-10,
              max_iter: int = 1000, eps: float = 1e-5,
              reference_quirks: bool = False, device="cuda") -> GarchFit:
    """BIC-selected GARCH(p, q) fit of one series (`garch/opti.py:89-181`)."""
    return fit_garch_batch(
        np.asarray(returns, dtype=float)[:, None], p_max=p_max, q_max=q_max,
        tol=tol, max_iter=max_iter, eps=eps,
        reference_quirks=reference_quirks, device=device,
    )[0]


def fit_garch_batch(returns_2d, p_max: int = 3, q_max: int = 3,
                    tol: float = 1e-10, max_iter: int = 1000,
                    eps: float = 1e-5, reference_quirks: bool = False,
                    device="cuda") -> list:
    """`fit_garch` for a whole (N, A) asset panel in one batched solve on
    `device`: per asset and pair the start with the lowest nll, then the
    pair with the strictly lowest BIC in p-major order."""
    if reference_quirks:
        raise NotImplementedError(f"fit_garch_batch: {_QUIRKS_LATER}")
    dev = resolve_device(device)
    returns_2d = np.asarray(returns_2d, dtype=float)
    n_obs, A = returns_2d.shape
    per_asset = [_garch_candidates(returns_2d[:, i], p_max, q_max)
                 for i in range(A)]
    masks, extras, pairs = per_asset[0][1], per_asset[0][2], per_asset[0][3]
    inits_a = np.stack([c[0] for c in per_asset])  # (A, C, m)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    xs, nlls = _newton_garch_assets(
        t(returns_2d.T), t(inits_a), t(masks), t(extras, torch.int64),
        p_max, q_max, max_iter, tol, eps)
    xs, nlls = xs.cpu().numpy(), nlls.cpu().numpy()
    fits = []
    n_starts = len(pairs) // (p_max * q_max)
    for a in range(A):
        best: Optional[GarchFit] = None
        for j in range(p_max * q_max):
            rows = slice(j * n_starts, (j + 1) * n_starts)
            p, q = pairs[j * n_starts]
            i = int(np.argmin(nlls[a, rows])) + j * n_starts
            x, nll = xs[a, i], float(nlls[a, i])
            alpha = x[1:1 + p].copy()
            beta = x[1 + p_max:1 + p_max + q].copy()
            packed = np.concatenate([[x[0]], alpha, beta])
            bic = 2.0 * nll + (1 + p + q) * np.log(n_obs)
            if best is None or bic < best.bic:
                best = GarchFit(p, q, float(x[0]), alpha, beta, nll, bic,
                                packed)
        fits.append(best)
    return fits


# ---------------------------------------------------------------------------
# MSM
# ---------------------------------------------------------------------------

MSM_BOUNDS = np.array([[0.2, 0.8], [1.0, 50.0], [0.05, 0.95]])  # `opti.py:113`
_PATIENCE = 10


def estimate_sigma(sample_variance, m_0, k):
    """Closed-form sigma given m_0 (`opti.py:25-27`).

    Kept as the reference has it: the profile assumes vol = sigma *
    prod(m) (second moment (m_0^2 - 2 m_0 + 2)^k), but the filter uses
    vol = sigma * sqrt(prod(m)), whose second moment is 1, so sigma comes
    out biased low and the (m_0, b, gamma) optimum shifts to compensate;
    the fitted parameters feed the VaR series and must match.
    """
    factor = (m_0**2 - 2 * m_0 + 2) ** (k / 2)
    return np.sqrt(sample_variance) / factor


def _msm_nll(k, params, returns, sample_var, gamma_weight, b_weight, n):
    """Penalized MSM NLL of parameter rows params (..., 3) = [m_0, b,
    gamma], sigma profiled from the sample variance, on the series
    `returns` (broadcast against the rows' batch, then N) -> (...)."""
    m0, b, gm = params[..., 0], params[..., 1], params[..., 2]
    factor = (m0**2 - 2 * m0 + 2) ** (k / 2)
    sigma = torch.sqrt(sample_var) / factor
    ll = msm_mod.log_likelihood(k, m0, sigma, b, gm, returns)
    reg = (gamma_weight * n * (gm - 0.5) ** 2
           + b_weight * n * (1.0 / b) ** 2)
    return -ll + reg


def _basin_hop(k, cur, lo, hi, step0, gens, returns, sample_var, gw, bw, n,
               iters):
    """The basin hop of every asset's starts in lockstep (`fit.py:461-513`,
    `opti.py:58-105`): cur (A, S, 3) on the work device, returns (A, 1, N),
    sample_var (A, 1). Per hop, each start proposes a Gaussian step of
    step x span, clipped to the box, and takes it when its NLL is lower;
    a taken step shrinks the start's step x0.9. After `_PATIENCE` hops
    without one, the step grows x1.1 and coordinates within 1 % of the
    span of a bound are re-drawn uniformly in the inner 80 % of the box.
    One host read per hop."""
    A, S, _ = cur.shape
    span = hi - lo

    def nll(p):
        return _msm_nll(k, p, returns, sample_var, gw, bw, n)

    cur_nll = nll(cur)
    steps = torch.full((A, S), float(step0), dtype=cur.dtype,
                       device=cur.device)
    stall = torch.zeros((A, S), dtype=torch.int64, device=cur.device)
    for _ in range(iters):
        noise = torch.stack([torch.randn((S, 3), generator=g, dtype=cur.dtype,
                                         device=cur.device) for g in gens])
        prop = torch.clamp(cur + noise * steps[..., None] * span, lo, hi)
        prop_nll = nll(prop)
        better = prop_nll < cur_nll
        cur = torch.where(better[..., None], prop, cur)
        cur_nll = torch.where(better, prop_nll, cur_nll)
        steps = torch.where(better, steps * 0.9, steps)
        stall = torch.where(better, torch.zeros_like(stall), stall + 1)
        hit = stall >= _PATIENCE
        if not bool(hit.any()):
            continue
        steps = torch.where(hit, steps * 1.1, steps)
        stall = torch.where(hit, torch.zeros_like(stall), stall)
        near = ((cur <= lo + 0.01 * span) | (cur >= hi - 0.01 * span)) \
            & hit[..., None]
        fresh = torch.stack([
            torch.rand((S, 3), generator=g, dtype=cur.dtype,
                       device=cur.device) for g in gens])
        fresh = lo + 0.1 * span + fresh * (0.8 * span)
        cur = torch.where(near, fresh, cur)
        changed = near.any(-1)
        cur_nll = torch.where(changed, nll(cur), cur_nll)
    return cur, cur_nll


def fit_msm(returns, k: int, basin_iter: int = 100, step_size: float = 0.2,
            b_values=None, gamma_weight: float = 0.0, b_weight: float = 0.0,
            seed: int = 0, bounds=None, reference_quirks: bool = False,
            polish_max_iter: int = 200, device="cuda") -> MsmFit:
    """Basin-hopping MLE over (m_0, b, gamma) of one series, sigma
    closed-form."""
    return fit_msm_batch(
        np.asarray(returns, dtype=float)[:, None], k,
        basin_iter=basin_iter, step_size=step_size, b_values=b_values,
        gamma_weight=gamma_weight, b_weight=b_weight, seed=seed,
        bounds=bounds, reference_quirks=reference_quirks,
        polish_max_iter=polish_max_iter, device=device,
    )[0]


def fit_msm_batch(returns_2d, k: int, basin_iter: int = 100,
                  step_size: float = 0.2, b_values=None,
                  gamma_weight: float = 0.0, b_weight: float = 0.0,
                  seed: int = 0, bounds=None, reference_quirks: bool = False,
                  polish_max_iter: int = 200, device="cuda",
                  timings: Optional[dict] = None) -> list:
    """`fit_msm` for a whole (N, A) asset panel on `device`: the basin hops
    of all assets in lockstep, one batched L-BFGS polish of every asset's
    top 3 starts by basin NLL (a polished start is kept only when
    better), and the true log-likelihood of every start in one call; each
    asset takes its start of maximum log-likelihood. Asset i draws from a
    `torch.Generator` seeded `seed + i`. polish_max_iter=0 skips the
    polish. When `timings` is a dict, it receives the wall seconds of
    "basin", "polish" and "final_ll" (the device synchronized at each
    end)."""
    if reference_quirks:
        raise NotImplementedError(f"fit_msm_batch: {_QUIRKS_LATER}")
    dev = resolve_device(device)
    returns_2d = np.asarray(returns_2d, dtype=float)
    n, A = returns_2d.shape
    if b_values is None:
        b_values = np.linspace(1.0, 50.0, 10)  # `opti.py:21`
    bounds = MSM_BOUNDS if bounds is None else np.asarray(bounds, dtype=float)
    n_starts = len(b_values)
    sample_var = np.var(returns_2d, axis=0)  # (A,)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    r_a = t(returns_2d.T)  # (A, N)
    sv = t(sample_var)
    lo, hi = t(bounds[:, 0]), t(bounds[:, 1])
    cur0 = np.tile(np.array([0.5, 10.0, 0.5]), (A, n_starts, 1))
    cur0[:, :, 1] = b_values
    gens = []
    for i in range(A):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + i)
        gens.append(g)
    clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        if timings is not None:
            synchronize(dev)
            now = time.perf_counter()
            timings[name] = now - clock
            clock = now

    with torch.no_grad():
        cur, cur_nll = _basin_hop(
            k, t(cur0), lo, hi, step_size, gens, r_a[:, None, :],
            sv[:, None], float(gamma_weight), float(b_weight), float(n),
            basin_iter)
    lap("basin")
    if polish_max_iter > 0:
        # L-BFGS polish of each asset's top starts by basin NLL
        # (`fit.py:671-703`); rows are asset x top start
        top = min(3, n_starts)
        order = torch.argsort(cur_nll, dim=1)[:, :top]  # (A, top)
        x0 = torch.gather(cur, 1, order[..., None].expand(A, top, 3))
        xs, fs = box_lbfgs_batch(
            lambda p, r, v: _msm_nll(k, p, r, v, float(gamma_weight),
                                     float(b_weight), float(n)),
            lo, hi, x0.reshape(A * top, 3),
            batched_args=(r_a.repeat_interleave(top, 0),
                          sv.repeat_interleave(top)),
            max_iter=polish_max_iter, fwd_grad=True,
        )
        xs, fs = xs.reshape(A, top, 3), fs.reshape(A, top)
        gain = fs < torch.gather(cur_nll, 1, order)
        cur = cur.scatter(1, order[..., None].expand(A, top, 3), torch.where(
            gain[..., None], xs, torch.gather(
                cur, 1, order[..., None].expand(A, top, 3))))
    lap("polish")
    # the true log-likelihood (no regularization) of every start; best
    # start by maximum LL (`fit.py:705-727`)
    with torch.no_grad():
        m0, b, gm = cur[..., 0], cur[..., 1], cur[..., 2]
        sigma = torch.sqrt(sv[:, None]) / (m0**2 - 2 * m0 + 2) ** (k / 2)
        final_ll = msm_mod.log_likelihood(k, m0, sigma, b, gm,
                                          r_a[:, None, :]).cpu().numpy()
    lap("final_ll")
    cur = cur.cpu().numpy()
    fits = []
    for a in range(A):
        i = int(np.argmax(final_ll[a]))
        m0, b, gm = cur[a, i]
        fits.append(MsmFit(float(m0), float(b), float(gm),
                           float(estimate_sigma(sample_var[a], m0, k)),
                           float(final_ll[a, i])))
    return fits
