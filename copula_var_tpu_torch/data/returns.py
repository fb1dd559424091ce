"""Returns ingestion for the port (counterpart of
`copula_var_tpu/data/returns.py`, whose numpy code is carried over as it
is): log-returns x 100 from adjusted closes, the first-N in-sample split,
demeaning by in-sample means, and the portfolio mean
`ptf_mean = sum_i mean_i w_i` (`load_data.py:59-137`).

`from_csv` there reads through pandas; this one reads with the `csv`
module and gives byte-equal returns on the same file, so the port runs
where pandas is not installed. The yfinance and synthetic sources are not
ported yet.
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = ["ReturnsData", "from_csv", "from_prices", "from_returns"]


@dataclass(frozen=True)
class ReturnsData:
    """Aligned daily returns plus the in-sample/out-of-sample split.

    returns: (M, dim) float64 — demeaning NOT applied (raw log-returns x100)
    tickers: column labels
    n_insample: N, the in-sample length
    weights: (dim,) portfolio weights
    dates: optional (M,) array of labels (np.datetime64 or str)
    """

    returns: np.ndarray
    tickers: List[str]
    n_insample: int
    weights: np.ndarray
    dates: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.returns.ndim != 2:
            raise ValueError("returns must be (M, dim)")
        if self.returns.shape[1] != len(self.tickers):
            raise ValueError("tickers must match returns columns")
        if len(self.weights) != self.returns.shape[1]:
            raise ValueError("weights must match returns columns")
        if len(self.returns) < self.n_insample:
            raise ValueError(
                f"Not enough returns for in-sample estimation. "
                f"Required: {self.n_insample}, Available: {len(self.returns)}"
            )

    # -- reference `get_insample_data` equivalents -------------------------

    @property
    def dim(self) -> int:
        return self.returns.shape[1]

    @property
    def out_sample_n(self) -> int:
        """T: number of out-of-sample days (`load_data.py:127`)."""
        return len(self.returns) - self.n_insample

    @property
    def in_sample_mean(self) -> np.ndarray:
        """(dim,) in-sample means (`load_data.py:110`)."""
        return self.returns[: self.n_insample].mean(axis=0)

    @property
    def ptf_mean(self) -> float:
        """sum_i mean_i w_i (`load_data.py:113`)."""
        return float(np.sum(self.in_sample_mean * self.weights))

    @property
    def in_sample(self) -> np.ndarray:
        """(N, dim) demeaned in-sample returns (`load_data.py:116-118`)."""
        return self.returns[: self.n_insample] - self.in_sample_mean

    @property
    def out_sample(self) -> np.ndarray:
        """(T, dim) raw out-of-sample returns (`load_data.py:124`)."""
        return self.returns[self.n_insample :]

    def rolling_windows(self) -> np.ndarray:
        """(T, N, dim) demeaned rolling windows: window t covers returns
        [t, t + N) — window t's last row is out-of-sample day t's previous
        trading day (`load_data.py:130-137`). All windows are demeaned by
        the fixed in-sample mean, as in the reference."""
        T, N, d = self.out_sample_n, self.n_insample, self.dim
        idx = np.arange(N)[None, :] + np.arange(T)[:, None]
        return self.returns[idx] - self.in_sample_mean[None, None, :]

    def portfolio_out_sample(self) -> np.ndarray:
        """(T,) realized portfolio returns under `self.weights` — the
        series the solved VaR applies to. (The reference's comparison plot
        uses an unweighted mean across assets, `main.py:73`, which only
        matches its VaR for equal weights; using the actual weights here
        keeps exception statistics consistent for any weighting.)"""
        return self.out_sample @ self.weights


def from_returns(returns, tickers=None, n_insample=None, weights=None, dates=None) -> ReturnsData:
    """Build from an (M, dim) array of (already x100 log-)returns."""
    returns = np.asarray(returns, dtype=float)
    m, d = returns.shape
    if tickers is None:
        tickers = [f"asset_{i}" for i in range(d)]
    if n_insample is None:
        n_insample = m // 2
    if weights is None:
        weights = np.full(d, 1.0 / d)
    return ReturnsData(returns, list(tickers), int(n_insample),
                       np.asarray(weights, dtype=float), dates)


def from_prices(prices, tickers=None, n_insample=None, weights=None, dates=None) -> ReturnsData:
    """(M+1, dim) adjusted closes -> daily log-returns x 100
    (`load_data.py:59-66`)."""
    prices = np.asarray(prices, dtype=float)
    rets = np.log(prices[1:] / prices[:-1]) * 100.0
    if dates is not None:
        dates = np.asarray(dates)[1:]
    return from_returns(rets, tickers, n_insample, weights, dates)


def _parse(cell: str) -> float:
    """A CSV cell as pandas reads it: blank -> NaN, else a float (raises
    ValueError for text)."""
    cell = cell.strip()
    return math.nan if cell == "" else float(cell)


def _is_numeric(cells) -> bool:
    try:
        for c in cells:
            _parse(c)
    except ValueError:
        return False
    return True


def from_csv(path, n_insample, weights=None, date_column=None) -> ReturnsData:
    """CSV of adjusted closes (columns = tickers). The column named
    `date_column` (default: the first non-numeric one) becomes the date
    index; rows with any missing price are dropped, as
    `copula_var_tpu.data.from_csv` does. Unlike there, the dates of
    dropped rows are dropped too, so dates stay aligned with returns."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], [r for r in rows[1:] if r]
    cols = {name: [r[k] for r in body] for k, name in enumerate(header)}
    if date_column is None:
        date_column = next(
            (c for c in header if not _is_numeric(cols[c])), None
        )
    dates = None
    if date_column is not None:
        dates = np.asarray(cols[date_column], dtype=object)
    tickers = [c for c in header if c != date_column]
    # column-major, as pandas' DataFrame.to_numpy() hands it over: the
    # in-sample means then sum in the same order, bit for bit
    prices = np.array(
        [[_parse(v) for v in cols[c]] for c in tickers], dtype=np.float64
    ).reshape(len(tickers), len(body)).T
    keep = ~np.isnan(prices).any(axis=1)
    if dates is not None:
        dates = dates[keep]
    return from_prices(np.asfortranarray(prices[keep]), tickers, n_insample,
                       weights, dates)
