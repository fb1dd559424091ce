"""Plain reference of a GARCH book under a Student-t copula: the VaR
series that a backtest's three-stage solve gives on the reference
repository's copula-GARCH calculator, worked again from the returns CSV
and the artifacts' fitted parameters and integration inputs.

It imports nothing of the program under test and takes nothing the
program made. It is plain PyTorch in float64 on the device it is given
(scipy supplies the Student-t quantile). The sweep's half-space cut, the
solve and the CSV's reading are `msm_student`'s, taken by import. The
integrand follows `garch_integration_function.py:31-51`, and departs from
`msm_student` in these points:

* one forecast volatility sigma[t, d] per asset and day (q = 1): no state
  mixture in the marginal, no state weights and no day combinations;
* the marginal CDF columns u[t, d] = Phi(x / sigma[t, d]) and the pdf
  columns p[t, d] = phi(x / sigma[t, d]) / sigma[t, d];
* the day's density is the Student-t copula density on the n^dim grid
  (NaN where a column is not finite, as in `msm_student`) times the
  explicit pdf product prod_d p[t, d], then nan_to_num: NaN counts 0 and
  +-inf the largest finite float64, as numpy's, so a cell whose u is
  exactly 0 or 1 counts nothing where `msm_student` keeps NaN;
* a sweep sums the masked density against dx (x) ... (x) dx, the step
  sizes alone on every axis;
* the grid is the GARCH split of the book's artifacts (`ii_x`, `ii_dx`:
  eighths outer, fifths middle, `garch_estimation.py:167-169`).
"""

from __future__ import annotations

import json
import math

import numpy as np
import scipy.special
import torch

from varbench.reference import msm_student
from varbench.reference.msm_student import (  # noqa: F401
    CHUNK_CELLS, F64, _axis, read_returns, solve)


class Book(msm_student.Book):
    """A fitted GARCH / Student-t book: the CSV's in-sample means and the
    artifacts' copula parameters and integration inputs, with the
    integrand of every out-of-sample day built once on `device`."""

    def __init__(self, csv_path, n_insample, artifacts_path, device="cpu",
                 days=None):
        self.device = torch.device(device)
        returns = read_returns(csv_path)
        self.in_sample_mean = returns[:n_insample].mean(axis=0)
        with np.load(artifacts_path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {k: np.asarray(z[k]) for k in z.files if k != "meta"}
        if meta["adapter"] != "garch" or meta["copula"] != "student":
            raise ValueError(f"{artifacts_path}: not a GARCH / Student-t "
                             "book")
        self.box_min = float(meta["box"][0])
        day = slice(None) if days is None else days
        self.x = torch.as_tensor(np.ascontiguousarray(arrays["ii_x"]),
                                 dtype=F64, device=self.device)
        self.dx = torch.as_tensor(np.ascontiguousarray(arrays["ii_dx"]),
                                  dtype=F64, device=self.device)
        sigma = np.asarray(arrays["ii_forecast_vols"][day], np.float64)
        self.T, self.dim = sigma.shape
        self.n = self.x.shape[0]
        nu = float(meta["copula_fit"]["nu"])
        corr = np.asarray(meta["copula_fit"]["corr_matrix"], dtype=np.float64)
        self.C = self._integrand(sigma, nu, corr)

    def _integrand(self, sigma, nu, corr):
        """(T, n, ..., n) nan_to_num(copula density x pdf product) of
        every day."""
        x = self.x.cpu().numpy()
        s = x[None, None, :] / sigma[:, :, None]  # (T, dim, n)
        u = scipy.special.ndtr(s)
        p = np.exp(-0.5 * s * s) / math.sqrt(2.0 * math.pi) / sigma[:, :, None]
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
        z, fin, log_uni, p = (torch.as_tensor(a, device=self.device)
                              for a in (z, fin, log_uni, p))
        V = torch.empty((self.T,) + (self.n,) * dim, dtype=F64,
                        device=self.device)
        nan = torch.tensor(math.nan, dtype=F64, device=self.device)
        step = max(1, CHUNK_CELLS // self.n ** dim)
        for s0 in range(0, self.T, step):
            d = slice(s0, min(self.T, s0 + step))
            quad = 0.0
            uni = 0.0
            pdf = 1.0
            ok = True
            for a in range(dim):
                za = _axis(z[d, a], a, dim)
                uni = uni + _axis(log_uni[d, a], a, dim)
                pdf = pdf * _axis(p[d, a], a, dim)
                ok = ok & _axis(fin[d, a], a, dim)
                for b in range(dim):
                    quad = quad + sigma_inv[a, b] * za * _axis(z[d, b], b,
                                                               dim)
            log_mvt = log_norm - (nu + dim) / 2.0 * torch.log1p(quad / nu)
            copula = torch.where(ok, torch.exp(log_mvt - uni), nan)
            V[d] = torch.nan_to_num(copula * pdf)
        return V

    def _contract(self, V, d):
        """Sum V (L, t, n, ..., n) over its grid axes against the step
        sizes, axis 0 first."""
        for _ in range(self.dim):
            V = torch.tensordot(V, self.dx, dims=([2], [0]))
        return V
