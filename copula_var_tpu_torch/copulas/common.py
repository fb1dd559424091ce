"""Shared copula utilities: correlation-matrix packing and the PD probe
(counterpart of `copula_var_tpu/copulas/common.py`).

The packed vector is the strict lower triangle, row-major over (i, j<i):
the reference's fill order (`gaussian/opti.py:58-78`). Every function
takes a leading batch of parameter rows.
"""

from __future__ import annotations

import torch

PENALTY = 1e10  # reference infeasible-parameter penalty


def corr_matrix_from_params(params, dim: int):
    """(..., n_par) strict-lower-triangle rows -> (..., dim, dim)
    correlation matrices."""
    params = torch.as_tensor(params, dtype=torch.float64)
    i, j = torch.tril_indices(dim, dim, offset=-1, device=params.device)
    mat = torch.eye(dim, dtype=params.dtype, device=params.device).expand(
        params.shape[:-1] + (dim, dim)).clone()
    mat[..., i, j] = params
    mat[..., j, i] = params
    return mat


def params_from_corr_matrix(corr):
    """Inverse of `corr_matrix_from_params`: (..., dim, dim) ->
    (..., n_par), the same row-major lower-triangle order."""
    corr = torch.as_tensor(corr, dtype=torch.float64)
    dim = corr.shape[-1]
    i, j = torch.tril_indices(dim, dim, offset=-1, device=corr.device)
    return corr[..., i, j]


def dim_from_n_params(n_params: int) -> int:
    """Matrix size from a packed strict-triangle length:
    n = (1 + sqrt(1 + 8 len)) / 2 (`student_estimation.py:47-50`)."""
    dim = int((1 + (1 + 8 * n_params) ** 0.5) / 2)
    if dim * (dim - 1) // 2 != n_params:
        raise ValueError(f"{n_params} is not a triangular number")
    return dim


def is_positive_definite(corr):
    """(..., dim, dim) -> (...) bool: the Cholesky factorization
    succeeds."""
    return torch.linalg.cholesky_ex(corr)[1] == 0


def safe_corr(corr):
    """(ok (...), corr with the identity wherever it is not a finite PD
    matrix): the losses' guard, applied before any factorization."""
    ok = torch.isfinite(corr).all(-1).all(-1)
    eye = torch.eye(corr.shape[-1], dtype=corr.dtype, device=corr.device)
    ok = ok & is_positive_definite(torch.where(ok[..., None, None], corr, eye))
    return ok, torch.where(ok[..., None, None], corr, eye)


def chol_quad_logdet(corr, z):
    """(z^T corr^-1 z for every row of z (..., N, d) -> (..., N),
    log det corr (...)) through the Cholesky factor, as the JAX modules
    form them."""
    L = torch.linalg.cholesky(corr)
    y = torch.linalg.solve_triangular(L, z.transpose(-1, -2), upper=False)
    quad = torch.sum(y * y, -2)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             -1)
    return quad, logdet
