"""Fitted volatility-model records (counterpart of the result types in
`copula_var_tpu/models/fit.py`). Same names and fields, so the saved
artifacts' `meta` loads into them; the fitting itself is queued in
ROADMAP.md (queue 1, models and fits)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
