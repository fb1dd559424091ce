"""Plain reference of an MSM book under a Student-t copula, at any asset
count: the VaR series that a backtest's three-stage solve gives, worked
again from the returns CSV and the artifacts' fitted parameters and
integration inputs.

It imports nothing of the program under test and takes nothing the
program made. It is plain PyTorch in float64 on the device it is given
(scipy supplies the Student-t quantile), and follows the published
semantics of the solve as the reference repository states them:

* the marginal CDF columns u[t, d] = sum_s f[t, d, s] Phi(x / vol[d, s]),
  the copula's z = t_ppf(u, nu) (0 where not finite) and the log
  univariate-t density;
* the copula density on the n^dim grid, NaN where a column is not
  finite; grid axis d holds asset d's column and is weighted with
  densities[(d - 1) mod dim] * dx (the reference's rotated rows);
* a sweep over bounds (lower, upper]: the half-space cut is resolved on
  the inner grid axis, paired with weights[0], with the outer axes paired
  with weights[1:] in order, the lower cut clamped to the box; masked
  cells count nothing, the rest are contracted with the state weights
  and summed against the day's state combinations;
* the solve: the stage-1 sweep over [-100, first_guess], the stage-2
  bracket, and the whole-array bisection that halves every bracket until
  the widest is within tolerance, where a row whose results are all
  exactly zero stops (the reference's early break); the root is the
  bracket's midpoint, NaN on days whose stage-2 result is NaN, plus the
  portfolio's in-sample mean.
"""

from __future__ import annotations

import csv
import json
import math

import numpy as np
import scipy.special
import torch

F64 = torch.float64
# calc_var's defaults: first_guess, second_guess, min_var_value,
# max_var_value, tolerance
FIRST_GUESS = -3.0
SECOND_GUESS = (-3.5, -2.0)
MIN_VAR, MAX_VAR = -7.5, 0.0
TOLERANCE = 1e-6
STAGE1_LOWER = -100.0
# cells of the masked grid formed at once (a float64 transient of 1 GiB)
CHUNK_CELLS = 1 << 27


def read_returns(path):
    """(M, dim) daily log-returns x 100 from a CSV of adjusted closes
    whose first column is the date; rows with a missing price dropped."""
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh)][1:]
    prices = np.array([[float(v) if v.strip() else math.nan for v in r[1:]]
                       for r in rows if r], dtype=np.float64)
    prices = prices[~np.isnan(prices).any(axis=1)]
    return np.log(prices[1:] / prices[:-1]) * 100.0


class Book:
    """A fitted MSM / Student-t book: the CSV's in-sample means and the
    artifacts' copula parameters and integration inputs, with the copula
    density of every out-of-sample day built once on `device`."""

    def __init__(self, csv_path, n_insample, artifacts_path, device="cpu",
                 days=None):
        self.device = torch.device(device)
        returns = read_returns(csv_path)
        self.in_sample_mean = returns[:n_insample].mean(axis=0)
        with np.load(artifacts_path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {k: np.asarray(z[k]) for k in z.files if k != "meta"}
        if meta["adapter"] != "msm" or meta["copula"] != "student":
            raise ValueError(f"{artifacts_path}: not an MSM / Student-t book")
        self.box_min = float(meta["box"][0])
        day = slice(None) if days is None else days

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=F64,
                                   device=self.device)

        self.x = dev(arrays["ii_x"])
        dx = dev(arrays["ii_dx"])
        densities = dev(arrays["ii_densities"])  # (dim, q, n)
        self.combos = dev(arrays["ii_forecast_combos"][day])  # (T, q^dim)
        fbs = arrays["ii_forecasts_by_states"][day]  # (T, dim, q)
        vols = arrays["ii_unique_vols"]  # (dim, q)
        self.dim, self.n = densities.shape[0], self.x.shape[0]
        self.T = fbs.shape[0]
        self.q = densities.shape[1]
        # grid axis d is weighted with densities[(d - 1) mod dim] * dx
        self.w_axes = [densities[(d - 1) % self.dim] * dx[None, :]
                       for d in range(self.dim)]
        nu = float(meta["copula_fit"]["nu"])
        corr = np.asarray(meta["copula_fit"]["corr_matrix"], dtype=np.float64)
        self.C = self._density(fbs, vols, nu, corr)

    def _density(self, fbs, vols, nu, corr):
        """(T, n, ..., n) Student-t copula density of every day."""
        x = self.x.cpu().numpy()
        cdf = scipy.special.ndtr(x[None, None, :] / vols[:, :, None])
        u = np.einsum("tds,dsn->tdn", fbs, cdf)  # (T, dim, n)
        z_raw = scipy.special.stdtrit(nu, u)
        fin = np.isfinite(z_raw)
        z = np.where(fin, z_raw, 0.0)
        log_uni = (math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0)
                   - 0.5 * math.log(nu * math.pi)
                   - (nu + 1.0) / 2.0 * np.log1p(z * z / nu))
        sigma_inv = np.linalg.inv(corr)
        logdet = float(np.linalg.slogdet(corr)[1])
        dim = self.dim
        log_norm = (math.lgamma((nu + dim) / 2.0) - math.lgamma(nu / 2.0)
                    - dim / 2.0 * math.log(nu * math.pi) - 0.5 * logdet)
        z, fin, log_uni = (torch.as_tensor(a, device=self.device)
                           for a in (z, fin, log_uni))
        C = torch.empty((self.T,) + (self.n,) * dim, dtype=F64,
                        device=self.device)
        step = max(1, CHUNK_CELLS // self.n ** dim)
        for s in range(0, self.T, step):
            d = slice(s, min(self.T, s + step))
            quad = 0.0
            uni = 0.0
            ok = True
            for a in range(dim):
                za = _axis(z[d, a], a, dim)
                uni = uni + _axis(log_uni[d, a], a, dim)
                ok = ok & _axis(fin[d, a], a, dim)
                for b in range(dim):
                    quad = quad + sigma_inv[a, b] * za * _axis(z[d, b], b,
                                                               dim)
            log_mvt = log_norm - (nu + dim) / 2.0 * torch.log1p(quad / nu)
            C[d] = torch.where(ok, torch.exp(log_mvt - uni),
                               torch.tensor(math.nan, dtype=F64,
                                            device=self.device))
        return C

    def ptf_means(self, weights):
        """(L,) in-sample portfolio means of weight rows (L, dim)."""
        return np.asarray(weights, dtype=np.float64) @ self.in_sample_mean

    def inner_bounds(self, bounds, weights):
        """The inner axis's cut (lo, up], each (L, T, n, ..., n) over the
        outer axes, of bounds (L, T, 2) and weights (L, dim)."""
        L, dim = weights.shape
        prev = torch.zeros((L,) + (1,) * (dim - 1), dtype=F64,
                           device=self.device)
        for a in range(dim - 1):
            w = weights[:, 1 + a].reshape((L,) + (1,) * (dim - 1))
            prev = prev + _axis(self.x, a, dim - 1) * w
        prev = prev[:, None]  # (L, 1, n, ..., n)
        lead = (slice(None), slice(None)) + (None,) * (dim - 1)
        w0 = weights[:, 0].reshape((L, 1) + (1,) * (dim - 1))
        up = (bounds[..., 1][lead] - prev) / w0
        lo = torch.clamp_min((bounds[..., 0][lead] - prev) / w0,
                             self.box_min)
        return lo, up

    def sweep(self, bounds, weights):
        """(L, T) integrals of the density over the slabs bounds (L, T, 2),
        row l under weights[l] (L, dim)."""
        L = bounds.shape[0]
        cells = self.n ** self.dim
        out = torch.empty((L, self.T), dtype=F64, device=self.device)
        rows = max(1, min(L, CHUNK_CELLS // (cells * self.T)))
        days = self.T if rows > 1 else max(1, min(self.T,
                                                  CHUNK_CELLS // cells))
        zero = torch.zeros((), dtype=F64, device=self.device)
        for r in range(0, L, rows):
            rr = slice(r, min(L, r + rows))
            for s in range(0, self.T, days):
                d = slice(s, min(self.T, s + days))
                lo, up = self.inner_bounds(bounds[rr, d], weights[rr])
                mask = (self.x > lo[..., None]) & (self.x <= up[..., None])
                V = torch.where(mask, self.C[d][None], zero)
                out[rr, d] = self._contract(V, d)
        return out

    def _contract(self, V, d):
        """Contract the grid axes of V (L, t, n, ..., n) with the state
        weights, axis 0 first, and sum against the days' combinations."""
        dim = self.dim
        for a in range(dim):
            V = torch.movedim(
                torch.tensordot(V, self.w_axes[a], dims=([2 + a], [1])),
                -1, 2 + a)
        return torch.sum(V.flatten(2) * self.combos[d][None], dim=-1)


def _axis(v, a, dim):
    """(..., n) -> (..., 1, .., n, .., 1) with n at grid axis a of dim."""
    return v.reshape(v.shape[:-1] + (1,) * a + (v.shape[-1],)
                     + (1,) * (dim - 1 - a))


def solve(book, weights, levels, on_sweep=None):
    """(L, T) VaR series of L rows, row l under weights[l] (L, dim) at
    level levels[l], and the number of halvings the bisection made.
    `on_sweep(bounds, weights)`, when given, sees the bounds of every
    sweep, in order."""
    dev = book.device
    w = torch.as_tensor(np.asarray(weights, dtype=np.float64), device=dev)
    obj = torch.as_tensor(np.asarray(levels, dtype=np.float64),
                          device=dev)[:, None]
    L, T = w.shape[0], book.T

    def sweep(b):
        if on_sweep is not None:
            on_sweep(b, w)
        return book.sweep(b, w)

    def c(v):
        return torch.full((L, T), v, dtype=F64, device=dev)

    fg, (sg0, sg1) = FIRST_GUESS, SECOND_GUESS
    F1 = sweep(torch.stack([c(STAGE1_LOWER), c(fg)], dim=-1))
    # stage 2: one refinement slab
    new_lower = torch.where(F1 >= obj, c(sg0), c(fg))
    new_upper = torch.where(F1 < obj, c(sg1), c(fg))
    I2 = sweep(torch.stack([new_lower, new_upper], dim=-1))
    res = torch.where(new_lower == fg, F1 + I2, F1 - I2)
    prev_up = torch.where(new_lower == sg0, c(sg0), c(sg1))
    lo, hi = c(MIN_VAR), c(MAX_VAR)
    for m, a, b in ((res > obj, MIN_VAR, sg0),
                    ((res < obj) & (new_upper == fg), sg0, fg),
                    ((res < obj) & (new_upper == sg1), sg1, MAX_VAR),
                    ((res > obj) & (new_upper == sg1), fg, sg1)):
        lo = torch.where(m, c(a), lo)
        hi = torch.where(m, c(b), hi)
    ustack = ~((hi == sg0) | (hi == sg1))
    nan_days = torch.isnan(res)
    # bisection: every row halves until the widest bracket is within
    # tolerance; a row whose results are all exactly zero stops
    stopped = torch.zeros((L, 1), dtype=torch.bool, device=dev)
    halvings = 0
    while bool(((hi - lo > TOLERANCE) & ~stopped).any()):
        mid = (lo + hi) / 2.0
        b_lo = torch.where(ustack, lo, mid)
        b_up = torch.where(ustack, mid, hi)
        slab = sweep(torch.stack([b_lo, b_up], dim=-1))
        result = torch.where(b_lo == prev_up, res + slab, res - slab)
        zero = torch.all(result == 0.0, dim=1, keepdim=True)
        below = result < obj
        frozen = zero | stopped
        lo = torch.where(frozen | ~below, lo, mid)
        hi = torch.where(frozen | below, hi, mid)
        res = torch.where(frozen, res, result)
        prev_up = torch.where(frozen, prev_up, mid)
        ustack = torch.where(frozen, ustack, below)
        stopped = frozen
        halvings += 1
    roots = torch.where(nan_days, torch.full_like(lo, math.nan),
                        (lo + hi) / 2.0)
    out = roots.cpu().numpy() + book.ptf_means(weights)[:, None]
    return out, halvings
