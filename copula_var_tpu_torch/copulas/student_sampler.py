"""Student-t copula test-data generator (counterpart of
`copula_var_tpu/copulas/student_sampler.py`, the reference's
`copulas/student/generate.py`).

The seeded fixture pipeline, vectorized:

  1. n uniform pairs from the legacy NumPy global RNG, seed 42
     (`np.random.seed(42)`; `np.random.rand(n, 2)`);
  2. a "copula value" per pair through the reference's APPROXIMATE
     t-cdf (`approx_t_cdf`: exact only for nu = 1, else a pdf-based
     `0.5 + x a b`), kept because the selected pairs depend on it;
  3. the bisection inverse of that cdf on [-1000, 1000] to tol 1e-6,
     with the reference's return-0 branch when the bracket does not
     change sign;
  4. the top `top_n` pairs by copula value (argsort order); marginals =
     the pairs, densities = phi(Phi^-1(T_nu_cdf(pairs))) with the EXACT
     t cdf.

Steps 1-3 are numpy on the host, as in the JAX package. Step 4 runs on
`device` through the port's `ops/special.py` (the card unless the caller
asks for "cpu"; `fixture_densities`).

At the defaults (nu = 5) the approximate cdf spans only 0.5 +- 5e-14 on
[-1000, 1000], so the inverse takes its return-0 branch for every u and
every copula value is exactly 1: the top `top_n` are the rows that
`np.argsort` leaves last among equal keys, which depends on the numpy
build's sort (its SIMD path), here as in the JAX package. On one machine
both packages pick the same rows.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from copula_var_tpu_torch.device import resolve_device
from copula_var_tpu_torch.ops.special import norm_pdf, norm_ppf, t_cdf


def approx_t_cdf(x, nu):
    """The reference's approximate t-cdf (`generate.py:6-20`), vectorized.
    Exact only for nu == 1; otherwise 0.5 + x * pdf-ish term."""
    x = np.asarray(x, dtype=float)
    if nu <= 0:
        raise ValueError("Degrees of freedom must be positive")
    if nu == 1:
        return 0.5 + np.arctan(x) / math.pi
    a = math.gamma((nu + 1) / 2) / (math.sqrt(nu * math.pi)
                                    * math.gamma(nu / 2))
    b = (1 + (x**2) / nu) ** (-(nu + 1) / 2)
    return 0.5 + x * a * b


def inverse_approx_t_cdf(u, nu, tol=1e-6, max_iter=100):
    """Vectorized bisection inverse of `approx_t_cdf` on [-1000, 1000]
    (`generate.py:22-48`), with the reference's return-0 branch when the
    initial bracket does not change sign."""
    u = np.asarray(u, dtype=float)
    a = np.full_like(u, -1000.0)
    b = np.full_like(u, 1000.0)
    fa = approx_t_cdf(a, nu) - u
    fb = approx_t_cdf(b, nu) - u
    invalid = fa * fb >= 0
    out = np.zeros_like(u)
    done = invalid.copy()
    for _ in range(max_iter):
        c = (a + b) / 2.0
        fc = approx_t_cdf(c, nu) - u
        conv = (np.abs(fc) < tol) | ((b - a) / 2.0 < tol)
        newly = conv & ~done
        out[newly] = c[newly]
        done |= conv
        go_left = fa * fc < 0
        b = np.where(go_left & ~done, c, b)
        fb = np.where(go_left & ~done, fc, fb)
        a = np.where(~go_left & ~done, c, a)
        fa = np.where(~go_left & ~done, fc, fa)
        if done.all():
            break
    return out


def t_copula_value(u1, u2, rho, nu):
    """The reference's bivariate t-copula kernel value (`t_copula`,
    `generate.py:50-64`), elementwise."""
    x1 = inverse_approx_t_cdf(np.asarray(u1), nu)
    x2 = inverse_approx_t_cdf(np.asarray(u2), nu)
    term2 = (x1**2 + x2**2 - 2 * rho * x1 * x2) / (nu * (1 - rho**2))
    return (1 + term2) ** (-(nu + 2) / 2)


def generate_student_t_copula_data(
    n: int = 100000, nu: float = 5, rho: float = 0.5, top_n: int = 1000,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's fixture data (`generate.py:66-90`): (marginals
    (top_n, 2), densities (top_n, 2)) as numpy float64, the densities
    computed on `device`."""
    dev = resolve_device(device)  # before any draw: a bad device raises
    np.random.seed(42)  # the reference's reproducibility seed (`:70`)
    random_couples = np.random.rand(n, 2)
    vals = t_copula_value(random_couples[:, 0], random_couples[:, 1], rho, nu)
    top = np.argsort(vals)[-top_n:]
    best = random_couples[top]
    return best, fixture_densities(best, nu, dev)


def fixture_densities(pairs, nu, device="cuda") -> np.ndarray:
    """phi(Phi^-1(T_nu_cdf(pairs))) of (m, 2) uniform pairs on `device`,
    with the exact t cdf (`generate.py:84-88`) -> numpy float64."""
    u = torch.as_tensor(np.asarray(pairs, dtype=np.float64),
                        device=resolve_device(device))
    return norm_pdf(norm_ppf(t_cdf(u, float(nu)))).cpu().numpy()
