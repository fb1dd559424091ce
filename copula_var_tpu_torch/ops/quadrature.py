"""Masked dense tensor-product quadrature, dim-2 cached path
(counterpart of `copula_var_tpu/ops/quadrature.py`).

Per out-of-sample day the copula density on the full n x n grid is
bounds-invariant, so it is built once (`msm_day_tensors`,
`garch_day_tensors`) and every VaR sweep is a half-space mask plus the
state-weight sandwich W0 (V .* M) W1^T (`msm_integrals_cached`,
`garch_integrals_cached`). Those two sweeps are the plain PyTorch twin of
the CUDA sweep kernel (`ops/cuda_quadrature.py`).

The JAX module's parity quirks are kept:
  * grid dim d weights with `densities[(d - 1) mod dim]` (rotated rows);
  * the inner cut is strict-lower / inclusive-upper, the lower bound
    clamped to the box and the upper bound not;
  * the GARCH family applies nan_to_num to copula * pdf-product before
    the mask; the MSM family applies no NaN handling.

Days are a leading batch dimension written out in every function (the
JAX module vmaps a one-day function instead). Dim >= 3 is later work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from copula_var_tpu_torch.ops.special import norm_cdf, norm_pdf, norm_ppf, t_ppf

BOX_MIN = -5.0


class CopulaSpec(NamedTuple):
    """Copula selector + parameters. kind: 'gaussian' | 'student' |
    'plackett'. gaussian: (corr,); student: (nu, corr); plackett:
    (theta,). corr is a (dim, dim) float64 tensor on the work device."""

    kind: str
    params: tuple


def _require_dim2(dim: int) -> None:
    if dim != 2:
        raise ValueError(
            f"the port's quadrature covers dim == 2 only (got dim={dim}); "
            "dim >= 3 is queued in ROADMAP.md (queue 1, off the main path)"
        )


def halfspace_mask(x, lower, upper, weights, box_min=BOX_MIN):
    """(..., n, n) bool mask of the portfolio cut {lower < w.x <= upper}
    resolved on the inner (last) grid axis, for bounds of any leading
    shape (...). weights (2,): weights[0] pairs the inner axis, weights[1]
    the outer one. Inner cut: x_j > max(dyn_lower, box_min) and
    x_j <= dyn_upper, with dyn = (bound - x_i * weights[1]) / weights[0]."""
    _require_dim2(weights.shape[0])
    prev = x * weights[1]  # (n,) outer coordinate times its weight
    dyn_upper = (upper[..., None] - prev) / weights[0]
    dyn_lower = torch.maximum(
        (lower[..., None] - prev) / weights[0], dyn_upper.new_tensor(box_min)
    )
    return (x > dyn_lower[..., None]) & (x <= dyn_upper[..., None])


def _all_pairs_quad(z0, z1, sigma_inv):
    """z^T Sigma^-1 z over the grid from per-axis coordinates z0, z1
    (..., n) -> (..., n, n), in the JAX module's summation order."""
    a, b = z0[..., :, None], z1[..., None, :]
    out = sigma_inv[0, 0] * a**2
    out = out + (2.0 * sigma_inv[0, 1]) * (a * b)
    return out + sigma_inv[1, 1] * b**2


def _chol_inv_logdet(corr):
    L = torch.linalg.cholesky(corr)
    eye = torch.eye(corr.shape[-1], dtype=corr.dtype, device=corr.device)
    inv_L = torch.linalg.solve_triangular(L, eye, upper=False)
    sigma_inv = inv_L.T @ inv_L
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return sigma_inv, logdet


def transform_u_columns(u_cols, spec: CopulaSpec):
    """Per-coordinate copula pre-transforms of (..., dim, n) marginal-CDF
    columns: plackett -> (u,); gaussian -> (norm_ppf(u),); student ->
    (z, finite, log_uni) with z = t_ppf(u) where finite, else 0, and
    log_uni the log univariate-t pdf at z. All ppf work happens here, on
    dim * n values per day."""
    if spec.kind == "plackett":
        return (u_cols,)
    if spec.kind == "gaussian":
        return (norm_ppf(u_cols),)
    if spec.kind == "student":
        nu = float(spec.params[0])
        z_raw = t_ppf(u_cols, nu)
        fin = torch.isfinite(z_raw)
        z = torch.where(fin, z_raw, torch.zeros_like(z_raw))
        log_uni = (
            math.lgamma((nu + 1.0) / 2.0)
            - math.lgamma(nu / 2.0)
            - 0.5 * math.log(nu * math.pi)
            - ((nu + 1.0) / 2.0) * torch.log1p(z * z / nu)
        )
        return (z, fin, log_uni)
    raise ValueError(f"unknown copula kind: {spec.kind}")


def copula_density_cols(cols, spec: CopulaSpec):
    """Copula density over the (n, n) grid from transformed columns
    (output of `transform_u_columns`, each leaf (..., 2, n)) ->
    (..., n, n)."""
    _require_dim2(cols[0].shape[-2])
    if spec.kind == "plackett":
        (theta,) = spec.params
        u = cols[0]
        a, b = u[..., 0, :, None], u[..., 1, None, :]
        tm1 = theta - 1.0
        num = theta * (1.0 + tm1 * (a + b - 2.0 * a * b))
        den = ((1.0 + tm1 * (a + b)) * (1.0 + tm1 * (1.0 - a - b))) ** 2
        return num / den
    if spec.kind == "gaussian":
        (corr,) = spec.params
        z = cols[0]
        z0, z1 = z[..., 0, :], z[..., 1, :]
        sigma_inv, logdet = _chol_inv_logdet(corr)
        quad = _all_pairs_quad(z0, z1, sigma_inv)
        sum_z2 = (z0**2)[..., :, None] + (z1**2)[..., None, :]
        return torch.exp(-0.5 * (logdet + quad - sum_z2))
    if spec.kind == "student":
        nu, corr = spec.params
        nu = float(nu)
        z, fin, log_uni = cols
        sigma_inv, logdet = _chol_inv_logdet(corr)
        quad = _all_pairs_quad(z[..., 0, :], z[..., 1, :], sigma_inv)
        dim = 2
        log_mvt = (
            math.lgamma((nu + dim) / 2.0)
            - math.lgamma(nu / 2.0)
            - (dim / 2.0) * math.log(nu * math.pi)
            - 0.5 * logdet
            - ((nu + dim) / 2.0) * torch.log1p(quad / nu)
        )
        log_uni_sum = log_uni[..., 0, :, None] + log_uni[..., 1, None, :]
        finite = fin[..., 0, :, None] & fin[..., 1, None, :]
        ratio = torch.exp(log_mvt - log_uni_sum)
        return torch.where(finite, ratio, torch.full_like(ratio, math.nan))
    raise ValueError(f"unknown copula kind: {spec.kind}")


def grid_copula_density(u_cols, spec: CopulaSpec):
    """(..., n, n) copula density from (..., 2, n) marginal-CDF columns."""
    return copula_density_cols(transform_u_columns(u_cols, spec), spec)


def state_weight_matrices(densities, dx):
    """[W0, W1], each (q, n): grid dim d weights with
    `densities[(d - 1) mod dim] * dx` (the reference's rotated rows)."""
    dim = densities.shape[0]
    return [densities[(d - 1) % dim] * dx[None, :] for d in range(dim)]


# ---------------------------------------------------------------------------
# Bounds-invariant day tensors
# ---------------------------------------------------------------------------


def msm_day_tensors(forecasts_by_states, x, unique_vols, spec: CopulaSpec):
    """(T, n, n) copula-density grids, one per day. forecasts_by_states
    (T, 2, q); x (n,); unique_vols (2, q). Each day's marginal is the
    state mixture sum_s f[t, d, s] Phi(x / vol[d, s])."""
    _require_dim2(unique_vols.shape[0])
    cdf = norm_cdf(x[None, None, :] / unique_vols[:, :, None])  # (2, q, n)
    u_cols = torch.sum(forecasts_by_states[:, :, :, None] * cdf, dim=2)
    return grid_copula_density(u_cols, spec)


def garch_day_tensors(forecast_vols, x, spec: CopulaSpec):
    """(T, n, n) nan_to_num(copula * pdf-product) grids per day.
    forecast_vols (T, 2)."""
    _require_dim2(forecast_vols.shape[1])
    fv = forecast_vols[:, :, None]
    u_cols = norm_cdf(x / fv)  # (T, 2, n)
    p_cols = norm_pdf(x / fv) / fv
    C = grid_copula_density(u_cols, spec)
    pdf_prod = p_cols[:, 0, :, None] * p_cols[:, 1, None, :]
    return torch.nan_to_num(C * pdf_prod)


# ---------------------------------------------------------------------------
# Cached sweeps: the plain twin of the sweep kernel
# ---------------------------------------------------------------------------


def msm_integrals_cached(bounds, C, forecast_combos, x, dx, densities,
                         weights, box_min=BOX_MIN):
    """(T,) integrals from day tensors C (T, n, n). bounds (T, 2);
    forecast_combos (T, q*q) in ij order; densities (2, q, n);
    weights (2,). Masked-out cells contribute nothing (a NaN cell only
    poisons slabs that include it)."""
    w0, w1 = state_weight_matrices(densities, dx)
    M = halfspace_mask(x, bounds[:, 0], bounds[:, 1], weights, box_min)
    V = torch.where(M, C, torch.zeros((), dtype=C.dtype, device=C.device))
    per_combo = (w0 @ V @ w1.T).reshape(C.shape[0], -1)  # (T, q*q)
    return torch.sum(per_combo * forecast_combos, dim=-1)


def garch_integrals_cached(bounds, V, x, dx, weights, box_min=BOX_MIN):
    """(T,) integrals from GARCH-family day tensors V (T, n, n):
    dx^T (V .* M) dx per day."""
    M = halfspace_mask(x, bounds[:, 0], bounds[:, 1], weights, box_min)
    vm = torch.where(M, V, torch.zeros((), dtype=V.dtype, device=V.device))
    return (dx @ vm) @ dx
