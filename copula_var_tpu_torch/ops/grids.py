"""Non-uniform 1-D quadrature grids (counterpart of
`copula_var_tpu/ops/grids.py`, carried over as it is: numpy only).

The reference builds a shared non-uniform x-grid with region-dependent point
budgets — one split for the MSM pipeline (`utils/model_estimation/model/
msm_estimation.py:302-319`: quarters outer, sevenths middle) and one for the
GARCH / mean-reverting pipelines (`garch_estimation.py:167-183`: eighths
outer, fifths middle). Both pack more points into [-1, 1] where the joint
density mass lives.

Grid construction is host-side; values are returned as numpy and moved
to the work device by the caller.
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np


class GridSpecKind(enum.Enum):
    MSM = "msm"
    GARCH = "garch"


def nonuniform_grid(
    num_points: int,
    outer_div: int,
    middle_div: int,
    x_min: float = -5.0,
    x_max: float = 5.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Piecewise-linspace grid over [x_min, x_max] with step-size weights.

    Regions (matching the reference layout):
      [x_min, -2.5) and [2.5, x_max] : num_points // outer_div points each
      [-2.5, -1)   and [1, 2.5)      : num_points // middle_div points each
      [-1, 1)                        : the remainder
    Only the final region includes its right endpoint. Step sizes are the
    backward differences with the first entry duplicated from the second
    (`step_size[0] = step_size[1]`, reference `msm_estimation.py:318-319`).

    Returns (x_values, step_sizes), both shape (num_points,) float64.
    """
    outer = num_points // outer_div
    middle = num_points // middle_div
    central = num_points - 2 * outer - 2 * middle
    if central <= 0:
        raise ValueError(
            f"num_points={num_points} too small for outer_div={outer_div}, "
            f"middle_div={middle_div}"
        )
    x = np.concatenate(
        [
            np.linspace(x_min, -2.5, outer, endpoint=False),
            np.linspace(-2.5, -1.0, middle, endpoint=False),
            np.linspace(-1.0, 1.0, central, endpoint=False),
            np.linspace(1.0, 2.5, middle, endpoint=False),
            np.linspace(2.5, x_max, outer, endpoint=True),
        ]
    )
    step = np.diff(x, prepend=x[0])
    step[0] = step[1]
    return x, step


def msm_grid(num_points: int, x_min: float = -5.0, x_max: float = 5.0):
    """MSM-pipeline grid split (outer // 4, middle // 7)."""
    return nonuniform_grid(num_points, 4, 7, x_min, x_max)


def garch_grid(num_points: int, x_min: float = -5.0, x_max: float = 5.0):
    """GARCH / mean-reverting pipeline grid split (outer // 8, middle // 5)."""
    return nonuniform_grid(num_points, 8, 5, x_min, x_max)


def grid_for(kind: GridSpecKind, num_points: int, x_min=-5.0, x_max=5.0):
    if kind == GridSpecKind.MSM:
        return msm_grid(num_points, x_min, x_max)
    return garch_grid(num_points, x_min, x_max)
