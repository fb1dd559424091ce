"""Fitted copula records (counterpart of the result types in
`copula_var_tpu/copulas/fit.py`). Same names and fields, so the saved
artifacts' `meta` loads into them; IFM fitting is queued in ROADMAP.md
(queue 1, copulas and fits)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class GaussianFit(NamedTuple):
    corr_matrix: np.ndarray
    nll: float
    packed_params: np.ndarray  # upper-triangle rho vector


class StudentFit(NamedTuple):
    nu: float
    corr_matrix: np.ndarray
    nll: float
    packed_params: np.ndarray  # [nu, rho...]


class PlackettFit(NamedTuple):
    theta: float
    nll: float
    packed_params: np.ndarray  # [theta]
