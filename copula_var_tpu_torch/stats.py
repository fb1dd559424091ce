"""VaR backtest evaluation statistics (counterpart of
`copula_var_tpu/stats.py`, numpy and scipy only, carried over as it is):
exception series and rate, Kupiec (1995) proportion-of-failures, and the
Christoffersen (1998) independence and conditional-coverage tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.stats import chi2


class CoverageTest(NamedTuple):
    statistic: float
    p_value: float
    df: int


def exceptions(portfolio_returns, var_series) -> np.ndarray:
    """Boolean exception indicator: realized return below the VaR."""
    return np.asarray(portfolio_returns) < np.asarray(var_series)


def exception_rate(portfolio_returns, var_series) -> float:
    return float(np.mean(exceptions(portfolio_returns, var_series)))


def kupiec_pof(portfolio_returns, var_series, alpha: float) -> CoverageTest:
    """Kupiec proportion-of-failures LR test of H0: P(exception) = alpha."""
    exc = exceptions(portfolio_returns, var_series)
    n = len(exc)
    x = int(exc.sum())
    pi_hat = x / n if n else 0.0
    if x in (0, n):
        # degenerate MLE: LR reduces to the null term only
        ll_alt = 0.0
    else:
        ll_alt = x * np.log(pi_hat) + (n - x) * np.log(1 - pi_hat)
    ll_null = x * np.log(alpha) + (n - x) * np.log(1 - alpha)
    lr = -2.0 * (ll_null - ll_alt)
    return CoverageTest(float(lr), float(chi2.sf(lr, 1)), 1)


def christoffersen_independence(portfolio_returns, var_series) -> CoverageTest:
    """Christoffersen LR test of exception independence (first-order
    Markov alternative)."""
    exc = exceptions(portfolio_returns, var_series).astype(int)
    pairs = np.stack([exc[:-1], exc[1:]], axis=1)
    n00 = int(np.sum((pairs[:, 0] == 0) & (pairs[:, 1] == 0)))
    n01 = int(np.sum((pairs[:, 0] == 0) & (pairs[:, 1] == 1)))
    n10 = int(np.sum((pairs[:, 0] == 1) & (pairs[:, 1] == 0)))
    n11 = int(np.sum((pairs[:, 0] == 1) & (pairs[:, 1] == 1)))

    def _ll(p, k, n):
        if n == 0 or p in (0.0, 1.0):
            return 0.0
        return k * np.log(p) + (n - k) * np.log(1 - p)

    pi01 = n01 / (n00 + n01) if (n00 + n01) else 0.0
    pi11 = n11 / (n10 + n11) if (n10 + n11) else 0.0
    pi = (n01 + n11) / max(n00 + n01 + n10 + n11, 1)
    ll_alt = _ll(pi01, n01, n00 + n01) + _ll(pi11, n11, n10 + n11)
    ll_null = _ll(pi, n01 + n11, n00 + n01 + n10 + n11)
    lr = -2.0 * (ll_null - ll_alt)
    return CoverageTest(float(lr), float(chi2.sf(lr, 1)), 1)


def christoffersen_conditional_coverage(
    portfolio_returns, var_series, alpha: float
) -> CoverageTest:
    """Joint coverage + independence test (df = 2)."""
    pof = kupiec_pof(portfolio_returns, var_series, alpha)
    ind = christoffersen_independence(portfolio_returns, var_series)
    lr = pof.statistic + ind.statistic
    return CoverageTest(float(lr), float(chi2.sf(lr, 2)), 2)
