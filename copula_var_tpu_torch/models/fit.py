"""In-sample volatility-model fits (counterpart of
`copula_var_tpu/models/fit.py`): the GARCH Newton sweep with BIC
selection, the MSM basin hop with its L-BFGS polish, and the UKF EM.

  * GARCH: every asset x (p, q) pair x start is one row of a batched
    damped-Newton solve (`_newton_garch_assets`) with exact gradients and
    Hessians from autograd; BIC selection happens on the host
    (`garch/opti.py:89-181`). `reference_quirks=True` replays the
    reference optimizer's own trajectory instead
    (`_garch_reference_trajectories`).
  * MSM: the 10 b-grid starts of every asset advance in lockstep through
    the basin hop (one batched filter per hop), the top 3 starts per
    asset are polished by `box_lbfgs_batch`, and the start with the
    maximum true log-likelihood wins (`opti.py:25-139`; the reference's
    minimum-LL selection is a defect the JAX package fixes too, and
    `reference_quirks=True` restores it, with no polish).
  * UKF: EM over (a, l, q) (`kalman_mean_reverting/optimize.py:28-167`):
    the E-step is the filter, the M-step closed form (q from the state's
    spread, l from q, a by OLS on the state's autoregression), with
    rejection perturbations of a and a restart sweep at convergence. The
    assets are rows of one batched filter and advance in lockstep; a
    finished row no-ops while the others run, as the JAX vmapped
    while-loop does.

Randomness comes from an explicit `torch.Generator` per asset on the work
device, seeded `seed + i`: a different stream from JAX's, so the two are
held to each other at the optimum, not along the trajectory; the
reference-quirks trajectories draw nothing (MSM at basin_iter = 0) and
are held along it.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from copula_var_tpu_torch.device import generator, resolve_device, synchronize
from copula_var_tpu_torch.models import garch as garch_mod
from copula_var_tpu_torch.models import msm as msm_mod
from copula_var_tpu_torch.models import ukf as ukf_mod
from copula_var_tpu_torch.ops.lbfgs import box_lbfgs_batch


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


def _garch_stencil_nll(returns_a, p_max, q_max):
    """The reference trajectory's default stencil evaluator: NLL rows
    `(x (R, 1 + p_max + q_max), asset (R,), p (R,), q (R,)) -> (R,)`, all
    numpy, as one batched `_garch_nll_rows` call on the device of
    returns_a (A, N): row r is asset[r]'s series under GARCH(p[r], q[r])
    with x[r] packed [omega, alpha (p_max), beta (q_max)]."""
    m = 1 + p_max + q_max
    dev = returns_a.device

    def nll_rows(x, asset, p, q):
        col = np.arange(m)
        mask = ((col == 0) | ((col >= 1) & (col < 1 + p[:, None]))
                | ((col >= 1 + p_max) & (col < 1 + p_max + q[:, None])))
        vals = _garch_nll_rows(
            torch.as_tensor(x, dtype=torch.float64, device=dev),
            returns_a[torch.as_tensor(asset, device=dev)],
            torch.as_tensor(mask, dtype=torch.float64, device=dev),
            torch.as_tensor(np.maximum(p, q), device=dev), p_max)
        return vals.cpu().numpy()

    return nll_rows


def _garch_reference_trajectories(n_obs, n_assets, p_max, q_max, tol,
                                  max_iter, eps, nll_rows) -> list:
    """The reference `GarchOptimizer`'s own trajectory
    (`garch/opti.py:39-181`) for every asset and (p, q) pair, all in
    lockstep: per pair the single start [0.1] + [0.5 / (p + q)] * (p + q);
    per iteration a central-difference gradient and Hessian from the
    2m + 1 points x, x +- eps e_i (m = 1 + p + q), with the reference's
    mixed-partial stencil (f(+e_i) - f(+e_j) - f(-e_i) + f(-e_j)) /
    (4 eps^2), which is not a cross derivative and is kept for the
    trajectory; a `np.linalg.pinv` Newton step on the host; alpha, beta
    renormalized when they sum above 1, then every coordinate floored at
    eps + 1e-7; stop when the pre-projection step's norm is below tol or
    after max_iter steps. A pair whose pinv fails is skipped. Per asset,
    the pair of strictly lowest BIC in p-major order.

    Every pair of every asset still running evaluates its stencil as
    rows of ONE `nll_rows(x, asset, p, q)` call per iteration (see
    `_garch_stencil_nll`; x padded to 1 + p_max + q_max), so the host
    reads once per iteration; a finished pair drops out. Returns one
    GarchFit per asset (None when every pair failed)."""
    width = 1 + p_max + q_max
    tasks = [(a, p, q) for a in range(n_assets) for p in range(1, p_max + 1)
             for q in range(1, q_max + 1)]

    def padded(x, p, q):
        out = np.zeros(x.shape[:-1] + (width,))
        out[..., :1 + p] = x[..., :1 + p]
        out[..., 1 + p_max:1 + p_max + q] = x[..., 1 + p:]
        return out

    def call(xs, idx):
        """nll_rows of the unpadded point rows xs[k] of tasks idx[k]."""
        rows = [padded(x, tasks[i][1], tasks[i][2]) for x, i in zip(xs, idx)]
        own = [np.full(len(x), i) for x, i in zip(xs, idx)]
        meta = np.asarray(tasks)[np.concatenate(own)]
        return nll_rows(np.concatenate(rows), meta[:, 0], meta[:, 1],
                        meta[:, 2])

    x = [np.array([0.1] + [0.5 / (p + q)] * (p + q)) for _, p, q in tasks]
    result = [None] * len(tasks)
    running = list(range(len(tasks)))
    for _ in range(max_iter):
        if not running:
            break
        pts = []
        for i in running:
            eye = np.eye(len(x[i]))
            pts.append(np.concatenate([x[i][None, :] + eps * eye,
                                       x[i][None, :] - eps * eye,
                                       x[i][None, :]], axis=0))
        vals = call(pts, running)
        nxt, at = [], 0
        for i in running:
            m = len(x[i])
            v = vals[at:at + 2 * m + 1]
            at += 2 * m + 1
            f_up, f_dn, f0 = v[:m], v[m:2 * m], v[2 * m]
            grad = (f_up - f_dn) / (2.0 * eps)
            hess = np.empty((m, m))
            for a in range(m):
                hess[a, a] = (f_up[a] - 2.0 * f0 + f_dn[a]) / eps**2
                for b in range(a + 1, m):
                    hess[a, b] = hess[b, a] = (
                        f_up[a] - f_up[b] - f_dn[a] + f_dn[b]
                    ) / (4.0 * eps**2)
            try:
                hess_inv = np.linalg.pinv(hess)
            except np.linalg.LinAlgError:
                result[i] = None  # `opti.py:110-112`: the pair is skipped
                continue
            delta = -hess_inv @ grad
            xi = x[i] + delta
            s_rest = np.sum(xi[1:])
            if s_rest > 1:
                xi[1:] = xi[1:] / s_rest
            x[i] = result[i] = np.maximum(xi, eps + 1e-7)
            if not np.linalg.norm(delta) < tol:
                nxt.append(i)
        running = nxt
    done = [i for i in range(len(tasks)) if result[i] is not None]
    nlls = (dict(zip(done, call([result[i][None, :] for i in done], done)))
            if done else {})
    fits = []
    for a in range(n_assets):
        best: Optional[GarchFit] = None
        for i in (i for i in done if tasks[i][0] == a):
            _, p, q = tasks[i]
            xi, nll = result[i], float(nlls[i])
            bic = 2.0 * nll + (1 + p + q) * np.log(n_obs)
            if best is None or bic < best.bic:
                best = GarchFit(p, q, float(xi[0]), xi[1:1 + p].copy(),
                                xi[1 + p:].copy(), nll, bic, xi.copy())
        fits.append(best)
    return fits


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
                    device="cuda", nll_rows=None) -> list:
    """`fit_garch` for a whole (N, A) asset panel in one batched solve on
    `device`: per asset and pair the start with the lowest nll, then the
    pair with the strictly lowest BIC in p-major order.

    reference_quirks=True runs the reference optimizer's trajectory
    (`_garch_reference_trajectories`) for every asset and pair in
    lockstep, its stencil points evaluated by `nll_rows` (default: the
    port's NLL on `device`, `_garch_stencil_nll`)."""
    dev = resolve_device(device)
    returns_2d = np.asarray(returns_2d, dtype=float)
    n_obs, A = returns_2d.shape
    if reference_quirks:
        if nll_rows is None:
            nll_rows = _garch_stencil_nll(
                torch.as_tensor(returns_2d.T.copy(), device=dev), p_max,
                q_max)
        return _garch_reference_trajectories(n_obs, A, p_max, q_max, tol,
                                             max_iter, eps, nll_rows)
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
    polish. reference_quirks=True is the reference's selection: no
    polish, and each asset takes its start of MINIMUM final
    log-likelihood (`opti.py:125-128`). When `timings` is a dict, it
    receives the wall seconds of "basin", "polish" and "final_ll" (the
    device synchronized at each end)."""
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
    gens = [generator(seed + i, dev) for i in range(A)]
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
    if not reference_quirks and polish_max_iter > 0:
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
        i = int(np.argmin(final_ll[a]) if reference_quirks
                else np.argmax(final_ll[a]))
        m0, b, gm = cur[a, i]
        fits.append(MsmFit(float(m0), float(b), float(gm),
                           float(estimate_sigma(sample_var[a], m0, k)),
                           float(final_ll[a, i])))
    return fits


# ---------------------------------------------------------------------------
# UKF mean-reverting
# ---------------------------------------------------------------------------

A_CLIP = (0.5, 0.99)  # the M-step's OLS a (`optimize.py:141-149`)
A_PERTURB_CLIP = (0.5, 0.999999)  # a perturbed a (`optimize.py:55-76`)
_STALL_LIMIT = 30  # EM iterations without a best-LL gain before stopping


def fit_ukf_em(returns, a0: float = 0.99, l0: float = 0.5, q0: float = 0.1,
               max_iter: int = 1000, tol: float = 1e-6,
               perturb_scale: float = 0.05, restart_attempts: int = 5,
               seed: int = 0, reference_quirks: bool = False,
               device="cuda") -> UkfFit:
    """EM over (a, l, q) of one series (`optimize.py:78-167`); see
    `fit_ukf_em_batch`."""
    return fit_ukf_em_batch(
        np.asarray(returns, dtype=float)[:, None], a0=a0, l0=l0, q0=q0,
        max_iter=max_iter, tol=tol, perturb_scale=perturb_scale,
        restart_attempts=restart_attempts, seed=seed,
        reference_quirks=reference_quirks, device=device,
    )[0]


def fit_ukf_em_batch(returns_2d, a0: float = 0.99, l0: float = 0.5,
                     q0: float = 0.1, max_iter: int = 1000, tol: float = 1e-6,
                     perturb_scale: float = 0.05, restart_attempts: int = 5,
                     seed: int = 0, reference_quirks: bool = False,
                     device="cuda") -> list:
    """UKF EM of a whole (N, A) asset panel on `device`, the assets in
    lockstep as rows of one batched filter.

    Per iteration and asset: the E-step filters with init (l, q). An
    invalid filter perturbs a (below). A log-likelihood within tol_eff =
    max(tol, 50 eps max(1, |best LL|)) of the best is converged and runs
    the restart sweep: `restart_attempts` perturbations of the best point,
    each kept when its LL beats the best; an asset whose sweep finds no
    gain is done. Otherwise the M-step: q = std(state) sqrt(1 - a^2), l =
    q^2 / (2 (1 - a^2)), a by OLS on the state shifted by a l, clipped to
    [0.5, 0.99]; when that a equals the current one exactly (pinned at
    the clip), the best point is perturbed instead. An asset also stops
    after 30 valid iterations without a gain, or at max_iter.

    A perturbation adds U(-perturb_scale, perturb_scale) to a, clipped to
    [0.5, 0.999999], cumulatively until the filter runs valid, then sets
    q and l from that filter's state as the M-step does. At
    perturb_scale = 0 an invalid filter would repeat forever (the JAX
    loop spins); here it raises.

    reference_quirks=True is the reference's frozen-a M-step: q, l and
    the OLS shift use a0 on every iteration (`optimize.py:83-84`).

    Asset i draws from a `torch.Generator` seeded `seed + i`. One host
    read per iteration, and one per perturbation attempt."""
    dev = resolve_device(device)
    r = torch.as_tensor(np.asarray(returns_2d, dtype=np.float64).T.copy(),
                        device=dev)  # (A, N)
    A = r.shape[0]
    dt = r.dtype
    eps = torch.finfo(dt).eps
    scale = float(perturb_scale)
    gens = [generator(seed + i, dev) for i in range(A)]

    def e_step(p, rows=None):
        means, _, ll, _, valid = ukf_mod.filter_series(
            r if rows is None else r[rows], p[:, 0], p[:, 1], p[:, 2])
        return means, ll, valid

    def from_state(a, state):
        """The M-step's (l, q) for a given a and filtered state."""
        q = torch.std(state, dim=-1, correction=0) * torch.sqrt(1.0 - a * a)
        return q * q / (2.0 * (1.0 - a * a)), q

    def perturb(base, rows):
        """Rejection perturbation of the points base (R, 3) of the assets
        `rows` (R host indices) -> (R, 3) (`optimize.py:55-76`)."""
        p = base.clone()
        state = torch.empty((len(rows), r.shape[1]), dtype=dt, device=dev)
        todo = np.arange(len(rows))
        while len(todo):
            u = torch.stack([torch.rand((), generator=gens[rows[j]], dtype=dt,
                                        device=dev) for j in todo])
            at = torch.as_tensor(todo, device=dev)
            p[at, 0] = torch.clamp(p[at, 0] - scale + 2.0 * scale * u,
                                   *A_PERTURB_CLIP)
            means, _, valid = e_step(p[at], [rows[j] for j in todo])
            state[at] = means
            ok = valid.cpu().numpy()
            if scale == 0.0 and not ok.all():
                raise RuntimeError(
                    "fit_ukf_em: the filter is invalid (a step's likelihood "
                    "Z < 1e-10) at a point the perturbation cannot move, "
                    "since perturb_scale=0 (the JAX loop spins forever "
                    "there); use perturb_scale > 0 or other starting values")
            todo = todo[~ok]
        l, q = from_state(p[:, 0], state)
        return torch.stack([p[:, 0], l, q], -1)

    params = torch.tensor([[a0, l0, q0]] * A, dtype=dt, device=dev)
    best_p = params.clone()
    best_ll = torch.full((A,), -np.inf, dtype=dt, device=dev)
    no_imp = torch.zeros(A, dtype=torch.int64, device=dev)
    done = torch.zeros(A, dtype=torch.bool, device=dev)
    a_frozen = torch.full((A,), float(a0), dtype=dt, device=dev)
    for _ in range(max_iter):
        state, ll, valid = e_step(params)
        mag = torch.where(torch.isfinite(best_ll), best_ll.abs(), 1.0)
        tol_eff = torch.clamp_min(50.0 * eps * torch.clamp_min(mag, 1.0),
                                  float(tol))
        converged = (ll - best_ll).abs() < tol_eff
        # the M-step of every row; a row takes it only on its own branch
        a_m = a_frozen if reference_quirks else params[:, 0]
        l_new, q_new = from_state(a_m, state)
        shifted = state - (a_m * l_new)[:, None]
        denom = torch.sum(shifted[:, :-1] ** 2, -1)
        pos = denom > 0.0
        a_ols = torch.where(
            pos, torch.sum(shifted[:, :-1] * shifted[:, 1:], -1)
            / torch.where(pos, denom, 1.0), 0.01)
        a_new = torch.clamp(a_ols, *A_CLIP)
        stuck = params[:, 0] == a_new
        flags = torch.stack([done, valid, converged, stuck]).cpu().numpy()
        act = ~flags[0]
        if not act.any():
            break
        valid_h, conv_h, stuck_h = flags[1], flags[2], flags[3]
        act_d = ~done
        took = act_d & valid
        bl = torch.where(took, torch.maximum(best_ll, ll), best_ll)
        bp = torch.where((took & (ll > best_ll))[:, None], params, best_p)
        nxt = torch.where((act_d & valid & ~converged & ~stuck)[:, None],
                          torch.stack([a_new, l_new, q_new], -1), params)
        finished = torch.zeros(A, dtype=torch.bool, device=dev)
        # invalid: perturb the current point; stuck: perturb the best
        redo = np.flatnonzero(act & (~valid_h | (~conv_h & stuck_h)))
        if len(redo):
            at = torch.as_tensor(redo, device=dev)
            base = torch.where(valid[at][:, None], bp[at], params[at])
            nxt[at] = perturb(base, list(redo))
        # converged: the restart sweep around the best point
        sweep = np.flatnonzero(act & valid_h & conv_h)
        if len(sweep):
            at = torch.as_tensor(sweep, device=dev)
            bl_s, bp_s = bl[at], bp[at]
            improved = torch.zeros(len(sweep), dtype=torch.bool, device=dev)
            for _ in range(restart_attempts):
                cand = perturb(bp_s, list(sweep))
                _, cll, cvalid = e_step(cand, list(sweep))
                better = cvalid & (cll > bl_s)
                bl_s = torch.where(better, cll, bl_s)
                bp_s = torch.where(better[:, None], cand, bp_s)
                improved = improved | better
            bl[at], bp[at], nxt[at] = bl_s, bp_s, bp_s
            finished[at] = ~improved
        # invalid E-steps neither stall nor reset the counter
        no_imp = torch.where(act_d, torch.where(
            bl > best_ll, 0, torch.where(valid, no_imp + 1, no_imp)), no_imp)
        done = done | (act_d & (finished | (no_imp >= _STALL_LIMIT)))
        params, best_ll, best_p = nxt, bl, bp
    best_p, best_ll = best_p.cpu().numpy(), best_ll.cpu().numpy()
    return [UkfFit(float(best_p[i, 0]), float(best_p[i, 1]),
                   float(best_p[i, 2]), float(best_ll[i])) for i in range(A)]
