"""Masked dense tensor-product quadrature (counterpart of
`copula_var_tpu/ops/quadrature.py`).

Two bounds-invariant caches feed the VaR sweeps (a third route rebuilds
everything on every call, for a plugin adapter with JAX's minimal
contract: `msm_integrals`, `garch_integrals`, their one-day forms and
the ragged-column helpers `copula_density_from_transformed`,
`halfspace_mask_cols`, `halfspace_frac_cols`):

  * dim 2, day tensors: the copula density on the full n x n grid is
    built once per day (`msm_day_tensors`, `garch_day_tensors`) and every
    sweep is a half-space mask plus the state-weight sandwich
    W0 (V .* M) W1^T (`msm_integrals_cached`, `garch_integrals_cached`),
    the plain twin of the CUDA sweep kernel (`ops/cuda_quadrature.py`);
  * any dim, transform columns: the (T, n^dim) densities would not fit
    (4 GB at n = 100, dim = 3, T = 500), so only the per-day per-coordinate
    copula pre-transforms are cached (`msm_day_columns`,
    `garch_day_columns`) and every sweep rebuilds the density in day
    chunks, masks and contracts it (`msm_integrals_tcached`,
    `garch_integrals_tcached`; `tcached_integrals` for L bound rows on
    one density per chunk), the plain twin of the dim-3 CUDA kernel
    (`ops/cuda_quadrature3.py`) and the dim >= 4 path (`ops/tcached.py`).

Grid sharding (`parallel/`): the sums over the outer grid axis 0 are
linear, so every sweep, trap sweep and density function here takes
`rows`, a slice of axis 0's n points (None: all of them), and returns
those rows' share: the density on (rows, n, ..., n), axis 0 masked at
x[rows] and contracted with its weight rows cut to `rows`. The shares of
ranks that split the n rows add up to the whole sweep; at rows = all of
them every value is the one-device value, bit for bit.

The JAX module's parity quirks are kept:
  * grid dim d weights with `densities[(d - 1) mod dim]` (rotated rows);
  * the half-space cut is resolved on the innermost grid axis, paired with
    `weights[0]`; the outer axes pair `weights[1:]` in order. The inner cut
    is strict-lower / inclusive-upper, the lower bound clamped to the box
    and the upper bound not;
  * the GARCH family applies nan_to_num to copula * pdf-product before
    the mask; the MSM family applies no NaN handling.

Days are a leading batch dimension written out in every function (the
JAX module vmaps, or `lax.map`s, a one-day function instead). The f32
desaturation of the JAX module (`desaturate_f32`) is not ported: the f64
`xla` engine leaves u unclamped, and so does the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from copula_var_tpu_torch.ops.special import norm_cdf, norm_pdf, norm_ppf, t_ppf
from copula_var_tpu_torch.utils.profiling import span

BOX_MIN = -5.0
BOX_MAX = 5.0


class CopulaSpec(NamedTuple):
    """Copula selector + parameters. kind: 'gaussian' | 'student' |
    'plackett'. gaussian: (corr,); student: (nu, corr); plackett:
    (theta,). corr is a (dim, dim) float64 tensor on the work device."""

    kind: str
    params: tuple


def _expand(v, d, dim):
    """(..., n) -> (..., 1, .., n, .., 1) with n at grid axis d of dim."""
    return v.reshape(v.shape[:-1] + (1,) * d + (v.shape[-1],)
                     + (1,) * (dim - 1 - d))


def _cols_bounds(x_cols, lower, upper, weights, box_min):
    """The inner axis's dynamic bounds (..., n_0, ..., n_{dim-2}, 1) of the
    cut {lower < w.x <= upper} for per-axis coordinates x_cols[d] (n_d,)
    and bounds of any leading shape (...): (max(dyn_lower, box_min),
    dyn_upper), dyn = (bound - prev) / weights[0] and prev = sum_d x_d *
    weights[1 + d] summed in grid-axis order, as the JAX module forms
    it."""
    dim = weights.shape[0]
    if dim == 1:
        prev = torch.zeros((), dtype=weights.dtype, device=weights.device)
    else:
        prev = _expand(x_cols[0], 0, dim - 1) * weights[1]
        for d in range(1, dim - 1):
            prev = prev + _expand(x_cols[d], d, dim - 1) * weights[1 + d]
    lower, upper = (torch.as_tensor(b, dtype=prev.dtype, device=prev.device)
                    for b in (lower, upper))
    lead = (...,) + (None,) * (dim - 1)
    dyn_upper = (upper[lead] - prev) / weights[0]
    dyn_lower = torch.maximum(
        (lower[lead] - prev) / weights[0], dyn_upper.new_tensor(box_min)
    )
    return dyn_lower[..., None], dyn_upper[..., None]


def _grid_cols(x, dim, x0=None):
    """The per-axis coordinates of the (n,) * dim grid, outer axis 0 cut
    to `x0` (a range of x's rows) when given."""
    return [x if x0 is None else x0] + [x] * (dim - 1)


def halfspace_mask_cols(x_cols, lower, upper, weights, box_min=BOX_MIN):
    """(..., n_0, ..., n_{dim-1}) bool mask of the portfolio cut {lower <
    w.x <= upper} over per-axis coordinate vectors x_cols[d] (n_d,),
    resolved on the inner (last) axis, for bounds of any leading shape
    (...) (JAX's helper takes one scalar pair). weights (dim,): weights[0]
    pairs the inner axis, weights[1:] the outer axes in order. Inner cut:
    x_in > max(dyn_lower, box_min) and x_in <= dyn_upper."""
    dyn_lower, dyn_upper = _cols_bounds(x_cols, lower, upper, weights,
                                        box_min)
    return (x_cols[-1] > dyn_lower) & (x_cols[-1] <= dyn_upper)


def halfspace_mask(x, lower, upper, weights, box_min=BOX_MIN, x0=None):
    """`halfspace_mask_cols` on the (n,) * dim grid -> (..., n, ..., n);
    `x0` (a range of x's rows) replaces the points of outer axis 0."""
    return halfspace_mask_cols(_grid_cols(x, weights.shape[0], x0), lower,
                               upper, weights, box_min)


def halfspace_frac_cols(x_cols, tw_inner, lower, upper, weights,
                        box_min=BOX_MIN):
    """Fractional-cell analog of `halfspace_mask_cols`: the share of each
    inner-axis node's cell [x - tw / 2, x + tw / 2] (tw_inner (n_last,))
    inside {lower < w.x <= upper} -> (..., n_0, ..., n_{dim-1}) float,
    continuous in the bounds."""
    dyn_lower, dyn_upper = _cols_bounds(x_cols, lower, upper, weights,
                                        box_min)
    cell_lo = x_cols[-1] - tw_inner / 2.0
    a_up = torch.clamp((dyn_upper - cell_lo) / tw_inner, 0.0, 1.0)
    a_lo = torch.clamp((dyn_lower - cell_lo) / tw_inner, 0.0, 1.0)
    return torch.clamp_min(a_up - a_lo, 0.0)


def _all_pairs_quad(z_cols, sigma_inv):
    """z^T Sigma^-1 z over the grid from per-axis coordinates z_cols[d]
    (..., n) -> (..., n, ..., n), in the JAX module's summation order."""
    dim = len(z_cols)
    out = None
    for d in range(dim):
        term = sigma_inv[d, d] * _expand(z_cols[d] ** 2, d, dim)
        out = term if out is None else out + term
        for e in range(d + 1, dim):
            out = out + (2.0 * sigma_inv[d, e]) * (
                _expand(z_cols[d], d, dim) * _expand(z_cols[e], e, dim))
    return out


def _chol_inv_logdet(corr):
    L = torch.linalg.cholesky(corr)
    eye = torch.eye(corr.shape[-1], dtype=corr.dtype, device=corr.device)
    inv_L = torch.linalg.solve_triangular(L, eye, upper=False)
    sigma_inv = inv_L.T @ inv_L
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return sigma_inv, logdet


def student_log_norm(nu: float, logdet, dim: int):
    """The log multivariate-t normalizer incl. -0.5 logdet, formed in the
    order `copula_density_cols` forms it."""
    return (math.lgamma((nu + dim) / 2.0) - math.lgamma(nu / 2.0)
            - (dim / 2.0) * math.log(nu * math.pi) - 0.5 * logdet)


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


def copula_density_cols(cols, spec: CopulaSpec, rows=None):
    """Copula density over the (n,) * dim grid from transformed columns
    (output of `transform_u_columns`, each leaf (..., dim, n)) ->
    (..., n, ..., n), or with `rows` (a slice of grid axis 0) over
    (rows, n, ..., n). Gaussian and Student take any dim; Plackett is
    dim 2 only."""
    dim = cols[0].shape[-2]
    axis = [[leaf[..., d, :] for leaf in cols] for d in range(dim)]
    if rows is not None:
        axis[0] = [a[..., rows] for a in axis[0]]
    if spec.kind == "plackett":
        if dim != 2:
            raise ValueError("Plackett copula requires dim == 2")
        (theta,) = spec.params
        a, b = axis[0][0][..., :, None], axis[1][0][..., None, :]
        tm1 = theta - 1.0
        num = theta * (1.0 + tm1 * (a + b - 2.0 * a * b))
        den = ((1.0 + tm1 * (a + b)) * (1.0 + tm1 * (1.0 - a - b))) ** 2
        return num / den
    if spec.kind == "gaussian":
        (corr,) = spec.params
        z_cols = [c[0] for c in axis]
        sigma_inv, logdet = _chol_inv_logdet(corr)
        quad = _all_pairs_quad(z_cols, sigma_inv)
        sum_z2 = _expand(z_cols[0] ** 2, 0, dim)
        for d in range(1, dim):
            sum_z2 = sum_z2 + _expand(z_cols[d] ** 2, d, dim)
        return torch.exp(-0.5 * (logdet + quad - sum_z2))
    if spec.kind == "student":
        nu, corr = spec.params
        nu = float(nu)
        sigma_inv, logdet = _chol_inv_logdet(corr)
        quad = _all_pairs_quad([c[0] for c in axis], sigma_inv)
        log_mvt = (student_log_norm(nu, logdet, dim)
                   - ((nu + dim) / 2.0) * torch.log1p(quad / nu))
        log_uni_sum = _expand(axis[0][2], 0, dim)
        finite = _expand(axis[0][1], 0, dim)
        for d in range(1, dim):
            log_uni_sum = log_uni_sum + _expand(axis[d][2], d, dim)
            finite = finite & _expand(axis[d][1], d, dim)
        ratio = torch.exp(log_mvt - log_uni_sum)
        return torch.where(finite, ratio, torch.full_like(ratio, math.nan))
    raise ValueError(f"unknown copula kind: {spec.kind}")


def copula_density_from_transformed(cols, spec: CopulaSpec):
    """JAX's name for the density over the full grid from pre-transformed
    columns (leaves (dim, n), or (..., dim, n)) -> (n,) * dim: the same
    formulas as `copula_density_cols`, which it calls."""
    return copula_density_cols(cols, spec)


def grid_copula_density(u_cols, spec: CopulaSpec):
    """(..., n, ..., n) copula density from (..., dim, n) marginal-CDF
    columns."""
    return copula_density_cols(transform_u_columns(u_cols, spec), spec)


def state_weight_matrices(densities, dx):
    """[W0, ..., W_{dim-1}], each (q, n): grid dim d weights with
    `densities[(d - 1) mod dim] * dx` (the reference's rotated rows)."""
    dim = densities.shape[0]
    return [densities[(d - 1) % dim] * dx[None, :] for d in range(dim)]


def _contract_states(V, w_cols):
    """Contract the grid axes of V (..., n, ..., n) against per-axis
    state-weight matrices w_cols[d] (q_d, n) -> (..., q_0, ..., q_{dim-1}).
    dim 2 is the sandwich W0 V W1^T; above it, grid axis 0 first, then
    1, ..., as the JAX module's tensordot loop."""
    dim = len(w_cols)
    if dim == 2:
        return w_cols[0] @ V @ w_cols[1].T
    out = V
    for d, w in enumerate(w_cols):
        ax = out.dim() - dim + d
        out = torch.movedim(torch.tensordot(out, w, dims=([ax], [1])), -1, ax)
    return out


def _pdf_product(p_cols, rows=None):
    """prod_d p_cols[..., d, :] over the grid -> (..., n, ..., n), axis 0
    cut to `rows` when given."""
    dim = p_cols.shape[-2]
    out = _expand(p_cols[..., 0, :] if rows is None else p_cols[..., 0, rows],
                  0, dim)
    for d in range(1, dim):
        out = out * _expand(p_cols[..., d, :], d, dim)
    return out


# ---------------------------------------------------------------------------
# dim-2 bounds-invariant day tensors
# ---------------------------------------------------------------------------


def msm_u_columns(forecasts_by_states, x, unique_vols):
    """(T, dim, n) per-day marginal CDF columns: the state mixture
    sum_s f[t, d, s] Phi(x / vol[d, s])."""
    with span("prep.columns"):
        # (dim, q, n)
        cdf = norm_cdf(x[None, None, :] / unique_vols[:, :, None])
        return torch.sum(forecasts_by_states[:, :, :, None] * cdf, dim=2)


def _garch_u_p_columns(forecast_vols, x):
    """(T, dim, n) per-day marginal CDF and pdf columns, Phi(x / vol) and
    phi(x / vol) / vol."""
    with span("prep.columns"):
        fv = forecast_vols[:, :, None]
        return norm_cdf(x / fv), norm_pdf(x / fv) / fv


def _require_dim2(dim: int) -> None:
    if dim != 2:
        raise ValueError(
            f"day tensors are the dim == 2 cache (got dim={dim}); dim 3 "
            "serves from transform columns (msm_day_columns, "
            "garch_day_columns)"
        )


def msm_day_tensors(forecasts_by_states, x, unique_vols, spec: CopulaSpec):
    """(T, n, n) copula-density grids, one per day. forecasts_by_states
    (T, 2, q); x (n,); unique_vols (2, q)."""
    _require_dim2(unique_vols.shape[0])
    return grid_copula_density(
        msm_u_columns(forecasts_by_states, x, unique_vols), spec)


def garch_day_tensors(forecast_vols, x, spec: CopulaSpec):
    """(T, n, n) nan_to_num(copula * pdf-product) grids per day.
    forecast_vols (T, 2)."""
    _require_dim2(forecast_vols.shape[1])
    u_cols, p_cols = _garch_u_p_columns(forecast_vols, x)
    C = grid_copula_density(u_cols, spec)
    with span("prep.pdf_product"):
        return torch.nan_to_num(C * _pdf_product(p_cols))


# ---------------------------------------------------------------------------
# dim-2 cached sweeps: the plain twin of the sweep kernel
# ---------------------------------------------------------------------------


def outer_slice(rows):
    """The slice of outer grid rows that an operands' `rows` ((i0, i1),
    or None for all) names, or None."""
    return None if rows is None else slice(*rows)


def row_range(rows, n: int):
    """(i0, i1) as ints, checked to lie in [0, n) and hold a row."""
    i0, i1 = (int(r) for r in rows)
    if not 0 <= i0 < i1 <= n:
        raise ValueError(f"rows ({i0}, {i1}): not a range of the {n} outer "
                         "grid rows")
    return i0, i1


def _outer(x, w0, rows):
    """(points, weight rows) of outer axis 0: whole, or cut to `rows`."""
    if rows is None:
        return None, w0
    return x[rows], w0[..., rows]


def msm_integrals_cached(bounds, C, forecast_combos, x, dx, densities,
                         weights, box_min=BOX_MIN, rows=None):
    """(T,) integrals from day tensors C (T, n, n), or the share of outer
    rows `rows` from C (T, rows, n). bounds (T, 2); forecast_combos
    (T, q*q) in ij order; densities (2, q, n); weights (2,). Masked-out
    cells contribute nothing (a NaN cell only poisons slabs that include
    it)."""
    w0, w1 = state_weight_matrices(densities, dx)
    x0, w0 = _outer(x, w0, rows)
    M = halfspace_mask(x, bounds[:, 0], bounds[:, 1], weights, box_min, x0)
    V = torch.where(M, C, torch.zeros((), dtype=C.dtype, device=C.device))
    per_combo = (w0 @ V @ w1.T).flatten(1)  # (T, q*q)
    return torch.sum(per_combo * forecast_combos, dim=-1)


def garch_integrals_cached(bounds, V, x, dx, weights, box_min=BOX_MIN,
                           rows=None):
    """(T,) integrals from GARCH-family day tensors V (T, n, n):
    dx^T (V .* M) dx per day; or the share of outer rows `rows` from V
    (T, rows, n)."""
    x0, d0 = _outer(x, dx, rows)
    M = halfspace_mask(x, bounds[:, 0], bounds[:, 1], weights, box_min, x0)
    vm = torch.where(M, V, torch.zeros((), dtype=V.dtype, device=V.device))
    return (d0 @ vm) @ dx


# ---------------------------------------------------------------------------
# Transform-cached sweeps (any dim): the plain twin of the dim-3 kernel
# ---------------------------------------------------------------------------

# One day's density grid may transiently materialize n^dim float64
# elements; beyond this even a one-day chunk is an out-of-memory hazard,
# so the sweep refuses it (the JAX module's budget and message).
MAX_GRID_ELEMENTS_PER_DAY = 1 << 26


def _day_batch(n: int, dim: int, T: int) -> int:
    """Chunk size bounding transient density-grid memory to ~2^21 f64
    elements (16 MB) per chunk; raises if even one day exceeds the
    per-day transient budget."""
    if n**dim > MAX_GRID_ELEMENTS_PER_DAY:
        raise ValueError(
            f"quadrature grid of num_points={n}^dim={dim} = {n**dim:.2e} "
            f"points per day exceeds the "
            f"{MAX_GRID_ELEMENTS_PER_DAY:.2e}-element transient budget "
            f"(~{MAX_GRID_ELEMENTS_PER_DAY * 8 >> 20} MB f64). Reduce "
            f"num_points (e.g. <= {int(MAX_GRID_ELEMENTS_PER_DAY ** (1 / dim))} "
            f"at dim={dim}) or the portfolio dimension."
        )
    return _days_per_chunk(n, dim, T, "cpu")


def _device_day_batch(n: int, dim: int, T: int, device) -> int:
    """`_day_batch` on the CPU (a host budget). On a GPU the chunk holds
    up to MAX_GRID_ELEMENTS_PER_DAY cells (512 MB per f64 transient, a few
    GB per sweep at n = 100, dim = 3), so a full-width plain solve takes
    a handful of chunks per sweep and fits in the card's memory."""
    _day_batch(n, dim, T)
    return _days_per_chunk(n, dim, T, device)


def _days_per_chunk(n: int, dim: int, T: int, device) -> int:
    """Days per chunk, unchecked: ~2^21 f64 cells on the CPU, up to
    MAX_GRID_ELEMENTS_PER_DAY on a GPU."""
    batch = max(1, min(T, (1 << 21) // max(1, n**dim)))
    if torch.device(device).type == "cpu":
        return batch
    return max(batch, min(T, MAX_GRID_ELEMENTS_PER_DAY // n**dim))


def check_grid_slab(n: int, dim: int, rows: int) -> None:
    """Raise, with the JAX grid engine's message, when one day's slab of
    `rows` outer grid rows, rows * n^(dim - 1) cells, exceeds the per-day
    transient budget (grid sharding exists to push n past one device's
    budget, so the budget holds per device)."""
    per_dev = rows * n ** (dim - 1)
    if per_dev > MAX_GRID_ELEMENTS_PER_DAY:
        raise ValueError(
            f"per-device grid slab {per_dev:.2e} elements exceeds the "
            f"{MAX_GRID_ELEMENTS_PER_DAY:.2e}-element transient "
            "budget; reduce num_points or widen the grid axis"
        )


def msm_day_columns(forecasts_by_states, x, unique_vols, spec: CopulaSpec):
    """Per-day copula pre-transform columns, each leaf (T, dim, n)."""
    return transform_u_columns(
        msm_u_columns(forecasts_by_states, x, unique_vols), spec)


def garch_day_columns(forecast_vols, x, spec: CopulaSpec):
    """(transform columns, pdf columns (T, dim, n)) for the GARCH family."""
    u_cols, p_cols = _garch_u_p_columns(forecast_vols, x)
    return transform_u_columns(u_cols, spec), p_cols


# ---------------------------------------------------------------------------
# Uncached integrands (a plugin adapter's `integrals`, JAX's minimal
# contract): every call rebuilds the columns and the density
# ---------------------------------------------------------------------------


def msm_integrals(bounds, forecasts_by_states, forecast_combos, x, dx,
                  densities, unique_vols, weights, spec: CopulaSpec,
                  box_min=BOX_MIN):
    """(T,) MSM-family integrals straight from the integration inputs
    (JAX `msm_integrals`): the per-day transform columns, then the
    transform-cached sweep, both on every call. bounds (T, 2);
    forecasts_by_states (T, dim, q); forecast_combos (T, q^dim);
    densities (dim, q, n); unique_vols (dim, q); weights (dim,)."""
    cols = msm_day_columns(forecasts_by_states, x, unique_vols, spec)
    return msm_integrals_tcached(bounds, cols, forecast_combos, x, dx,
                                 densities, weights, spec, box_min)


def garch_integrals(bounds, forecast_vols, x, dx, weights, spec: CopulaSpec,
                    box_min=BOX_MIN):
    """(T,) GARCH / mean-reverting integrals straight from the forecast
    vols (T, dim) (JAX `garch_integrals`): nan_to_num(copula * pdf
    product), masked, contracted with dx on every axis."""
    cols, p_cols = garch_day_columns(forecast_vols, x, spec)
    return garch_integrals_tcached(bounds, cols, p_cols, x, dx, weights,
                                   spec, box_min)


def msm_integral_day(bounds, forecasts_by_states, forecast_combos, x, dx,
                     densities, unique_vols, weights, spec: CopulaSpec,
                     box_min=BOX_MIN):
    """One day's MSM integral (JAX `msm_integral_day`): bounds (2,),
    forecasts_by_states (dim, q), forecast_combos (q^dim,)."""
    return msm_integrals(bounds[None], forecasts_by_states[None],
                         forecast_combos[None], x, dx, densities,
                         unique_vols, weights, spec, box_min)[0]


def garch_integral_day(bounds, forecast_vols, x, dx, weights,
                       spec: CopulaSpec, box_min=BOX_MIN):
    """One day's GARCH-family integral (JAX `garch_integral_day`): bounds
    (2,), forecast_vols (dim,)."""
    return garch_integrals(bounds[None], forecast_vols[None], x, dx,
                           weights, spec, box_min)[0]


def _chunks(T, n, dim, device, day_batch, rows=None):
    """Day chunks of `day_batch` days, or of the device's count. A range
    of outer rows takes the whole grid's days per chunk, so its chunks
    hold rows / n of the cells."""
    if day_batch:
        step = day_batch
    elif rows is None:
        step = _device_day_batch(n, dim, T, device)
    else:
        check_grid_slab(n, dim, len(range(n)[rows]))
        step = _days_per_chunk(n, dim, T, device)
    return [slice(s, min(T, s + step)) for s in range(0, T, step)]


def msm_integrals_tcached(bounds, cols, forecast_combos, x, dx, densities,
                          weights, spec: CopulaSpec, box_min=BOX_MIN,
                          day_batch=None):
    """(T,) MSM-family integrals from cached transform columns (any dim).
    bounds (T, 2); cols leaves (T, dim, n); forecast_combos (T, q^dim) in
    ij order; densities (dim, q, n); weights (dim,). Days run in chunks
    of `day_batch` (default `_device_day_batch`)."""
    return tcached_integrals(bounds[None], weights[None], cols, x, dx, spec,
                             box_min, day_batch, densities=densities,
                             forecast_combos=forecast_combos)[0]


def garch_integrals_tcached(bounds, cols, p_cols, x, dx, weights,
                            spec: CopulaSpec, box_min=BOX_MIN,
                            day_batch=None):
    """(T,) GARCH-family integrals from cached transform columns and pdf
    columns p_cols (T, dim, n) (any dim): nan_to_num(C * pdf-product),
    masked, contracted with dx on every axis."""
    return tcached_integrals(bounds[None], weights[None], cols, x, dx, spec,
                             box_min, day_batch, p_cols=p_cols)[0]


def tcached_integrals(bounds, weights, cols, x, dx, spec: CopulaSpec,
                      box_min=BOX_MIN, day_batch=None, p_cols=None,
                      densities=None, forecast_combos=None, trap=False,
                      rows=None):
    """(L, T) transform-cached integrals of L bound rows (L, T, 2), row l
    with its own weights[l] (L, dim): the MSM family (densities,
    forecast_combos) or the GARCH family (p_cols). Each day chunk's
    density (at GARCH nan_to_num(C * pdf-product)) is built once and
    shared by the rows; per row it is masked (`halfspace_mask`) and
    contracted with dx, or with `trap=True` cut fractionally
    (`halfspace_frac`) and contracted with the trapezoid weights, every
    row's arithmetic that of the one-row sweeps above and below. With
    `rows` (a slice of outer grid axis 0) the share of those rows."""
    dim, n = cols[0].shape[-2], x.shape[0]
    tw = trap_weights(x) if trap else None
    step = dx if tw is None else tw
    w_cols = ([step[None, :]] * dim if densities is None
              else state_weight_matrices(densities, step))
    x0, w_first = _outer(x, w_cols[0], rows)
    w_cols = [w_first] + list(w_cols[1:])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.empty(bounds.shape[:2], dtype=x.dtype, device=x.device)
    for s in _chunks(bounds.shape[1], n, dim, x.device, day_batch, rows):
        C = copula_density_cols(tuple(c[s] for c in cols), spec, rows)
        if p_cols is not None:
            C = torch.nan_to_num(C * _pdf_product(p_cols[s], rows))
        for row, (b, w) in enumerate(zip(bounds, weights)):
            if tw is None:
                V = torch.where(halfspace_mask(x, b[s, 0], b[s, 1], w,
                                               box_min, x0), C, zero)
            else:
                A = halfspace_frac(x, tw, b[s, 0], b[s, 1], w, box_min, x0)
                V = C * A if p_cols is not None else _inside(C, A)
            per_combo = _contract_states(V, w_cols).flatten(1)
            out[row, s] = (per_combo[:, 0] if forecast_combos is None else
                           torch.sum(per_combo * forecast_combos[s], dim=-1))
    return out


# ---------------------------------------------------------------------------
# Trapezoid refinement sweeps (refine_root)
# ---------------------------------------------------------------------------
#
# The masked sweeps above are the reference's right-rectangle rule with a
# hard inner cut: the CDF is a staircase in the VaR bound and the solved
# root carries an O(cell) bias. The refinement re-solves in a +-h window
# against a second-order estimate of the same integrand: trapezoid node
# weights (node k owns [x_k - tw_k / 2, x_k + tw_k / 2]) and the inner
# axis's boundary cell included in proportion to its share inside the
# slab, which makes F continuous and piecewise linear in the bound. No
# TPU kernel computes these: the JAX package runs them in XLA, and the
# port in plain PyTorch on the work device.


def trap_weights(x):
    """(n,) trapezoid node weights of the grid: interior node k owns
    (x_{k+1} - x_{k-1}) / 2, each end node one full adjacent step."""
    return torch.cat([(x[1] - x[0])[None], (x[2:] - x[:-2]) / 2.0,
                      (x[-1] - x[-2])[None]])


def halfspace_frac(x, tw, lower, upper, weights, box_min=BOX_MIN, x0=None):
    """`halfspace_frac_cols` on the (n,) * dim grid -> (..., n, ..., n)
    float, for bounds of any leading shape (...); the same pairing and
    dynamic bounds as `halfspace_mask` (and its `x0`)."""
    return halfspace_frac_cols(_grid_cols(x, weights.shape[0], x0), tw,
                               lower, upper, weights, box_min)


def _inside(C, A):
    """C .* A with C's cells outside the slab (A == 0) zeroed first, so a
    NaN cell outside the slab contributes 0 as under the staircase's
    mask, and a NaN cell inside it surfaces."""
    return torch.where(A > 0.0, C, torch.zeros((), dtype=C.dtype,
                                               device=C.device)) * A


def msm_integrals_trap(bounds, C, forecast_combos, x, densities, weights,
                       box_min=BOX_MIN, day_batch=None, rows=None):
    """(T,) trapezoid integrals from the dim-2 MSM day tensors C
    (T, n, n) (twin of `msm_integrals_cached`), or the share of outer
    rows `rows` from C (T, rows, n). Days run in chunks of `day_batch`
    (default `_device_day_batch`)."""
    tw = trap_weights(x)
    w0, w1 = state_weight_matrices(densities, tw)
    x0, w0 = _outer(x, w0, rows)
    out = []
    for s in _chunks(C.shape[0], x.shape[0], 2, x.device, day_batch):
        A = halfspace_frac(x, tw, bounds[s, 0], bounds[s, 1], weights,
                           box_min, x0)
        per_combo = (w0 @ _inside(C[s], A) @ w1.T).flatten(1)
        out.append(torch.sum(per_combo * forecast_combos[s], dim=-1))
    return torch.cat(out)


def garch_integrals_trap(bounds, V, x, weights, box_min=BOX_MIN,
                         day_batch=None, rows=None):
    """(T,) trapezoid integrals from the dim-2 GARCH-family day tensors V
    (T, n, n) (twin of `garch_integrals_cached`): tw^T (V .* A) tw; or
    the share of outer rows `rows` from V (T, rows, n)."""
    tw = trap_weights(x)
    x0, t0 = _outer(x, tw, rows)
    out = []
    for s in _chunks(V.shape[0], x.shape[0], 2, x.device, day_batch):
        A = halfspace_frac(x, tw, bounds[s, 0], bounds[s, 1], weights,
                           box_min, x0)
        out.append((t0 @ _inside(V[s], A)) @ tw)
    return torch.cat(out)


def msm_tcached_trap(bounds, cols, forecast_combos, x, densities, weights,
                     spec: CopulaSpec, box_min=BOX_MIN, day_batch=None):
    """(T,) trapezoid integrals from cached transform columns, MSM family,
    any dim (twin of `msm_integrals_tcached`)."""
    return tcached_integrals(bounds[None], weights[None], cols, x, None,
                             spec, box_min, day_batch, densities=densities,
                             forecast_combos=forecast_combos, trap=True)[0]


def garch_tcached_trap(bounds, cols, p_cols, x, weights, spec: CopulaSpec,
                       box_min=BOX_MIN, day_batch=None):
    """(T,) trapezoid integrals from cached transform columns and pdf
    columns, GARCH family, any dim (twin of `garch_integrals_tcached`):
    nan_to_num(C * pdf-product) .* A, with no mask before the product."""
    return tcached_integrals(bounds[None], weights[None], cols, x, None,
                             spec, box_min, day_batch, p_cols=p_cols,
                             trap=True)[0]
