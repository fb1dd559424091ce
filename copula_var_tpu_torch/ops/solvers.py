"""Stage-2 bracketing of the VaR solve, the trapezoid re-solve of
`refine_root` and the batched golden-section scan of the IFM fits
(counterpart of `copula_var_tpu/ops/solvers.py`: `bracket_state_batched`,
`trap_bisect`, `golden_section_min`), and the f32 engine's halving count
and accuracy contract (the port's copies of `copula_var_tpu/ops/
pallas_solver.py::_full_iters` and `root_plateau_bound`)."""

from __future__ import annotations

import math

import numpy as np
import torch

_GR = 0.6180339887498949  # (sqrt(5) - 1) / 2


def golden_section_min(fn, lo, hi, iters: int = 90):
    """Batched golden-section minimization.

    fn maps (k*B,) -> (k*B,) for k in {1, 2}: both probes of an iteration
    are evaluated in ONE stacked call (fn sees the two probe vectors
    concatenated), so a closure carrying (B,)-shaped companion data must
    tile it to the input length. lo/hi: (B,) bracket endpoints, float64
    tensors. Returns (x (B,), fn(x) (B,)) with x the bracket midpoint after
    `iters` contractions. No host read happens inside the loop.
    """
    a, b = lo, hi
    B = a.shape[0]
    for _ in range(iters):
        m1 = b - _GR * (b - a)
        m2 = a + _GR * (b - a)
        f = fn(torch.cat([m1, m2]))
        keep_left = f[:B] < f[B:]
        a, b = torch.where(keep_left, a, m1), torch.where(keep_left, m2, b)
    x = 0.5 * (a + b)
    return x, fn(x)


def bracket_state_batched(F1, obj, sweep_batched, cfg, quirks):
    """Stage-2 refinement + bisection-state setup for L rows at once
    (`calc_var_class.py:125-155`, branch-free). F1 (L, T) stage-1 CDFs at
    first_guess; obj (L,); `sweep_batched((L, T, 2)) -> (L, T)`; cfg =
    (first_guess, sg0, sg1, min_v, max_v) as floats; quirks re-enables
    the reference's add-group anchor (first_guess instead of sg1).
    Returns (lo, hi, res, prev_upper, upper_stack, nan_mask), each
    (L, T)."""
    fg, sg0, sg1, min_v, max_v = (float(c) for c in cfg)
    c = lambda v: F1.new_tensor(v)  # noqa: E731  (0-dim, F1's dtype/device)
    objc = obj[:, None]
    new_lower = torch.where(F1 >= objc, c(sg0), c(fg))
    new_upper = torch.where(F1 < objc, c(sg1), c(fg))
    I2 = sweep_batched(torch.stack([new_lower, new_upper], dim=-1))
    res = torch.where(new_lower == fg, F1 + I2, F1 - I2)
    anchor = fg if quirks else sg1
    prev_upper = torch.where(new_lower == sg0, c(sg0), c(anchor))
    lo = torch.full_like(F1, min_v)
    hi = torch.full_like(F1, max_v)
    m = res > objc
    lo = torch.where(m, c(min_v), lo)
    hi = torch.where(m, c(sg0), hi)
    m = (res < objc) & (new_upper == fg)
    lo = torch.where(m, c(sg0), lo)
    hi = torch.where(m, c(fg), hi)
    m = (res < objc) & (new_upper == sg1)
    lo = torch.where(m, c(sg1), lo)
    hi = torch.where(m, c(max_v), hi)
    m = (res > objc) & (new_upper == sg1)
    lo = torch.where(m, c(fg), lo)
    hi = torch.where(m, c(sg1), hi)
    ustack = ~((hi == sg0) | (hi == sg1))
    return lo, hi, res, prev_upper, ustack, torch.isnan(res)


def trap_bisect(sweep_batched, roots, obj2, h2, iters: int = 12):
    """Re-solve in a +-h window around the staircase roots (L, T) against
    a second-order trap sweep `sweep_batched((L, T, 2)) -> (L, T)` of the
    CDF slab [-100, bound]: F_trap is continuous and monotone in the
    bound, so `iters` halvings pin the refined root to 2h / 2^iters. obj2
    (L, 1); h2 broadcastable to (L, T). A fixed count, no host read. A
    cell whose trap sweep ever turns non-finite keeps its staircase
    root."""
    lo, hi = roots - h2, roots + h2
    low_edge = torch.full_like(roots, -100.0)
    bad = torch.zeros(roots.shape, dtype=torch.bool, device=roots.device)
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        F = sweep_batched(torch.stack([low_edge, mid], dim=-1))
        bad = bad | ~torch.isfinite(F)
        below = F < obj2
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return torch.where(bad, roots, (lo + hi) / 2.0)


def full_iters(tolerance, min_var_value, max_var_value) -> int:
    """Halvings per level of the f32 engine's fused dim-2 solve
    (`pallas_solver.py::_full_iters`): ceil(log2(span / tolerance)) for
    the widest bracket the solve can hold, span = max_var - min_var (23
    at the defaults), so no bracket is read on the host."""
    span = max(float(max_var_value) - float(min_var_value), float(tolerance))
    return max(1, int(math.ceil(math.log2(span / float(tolerance)))))


def root_plateau_bound(dx, weights, n_cells=1) -> float:
    """The f32 engine's accuracy contract (`pallas_solver.py::
    root_plateau_bound`): the masked-grid CDF is a step function of the
    VaR bound, whose inner cut moves one grid cell when the bound moves
    cell width x |weights[0]|, so an f32 root may sit on another edge of
    the same or an adjacent plateau than the f64 root. Worst case:
    n_cells x max(dx) x |weights[0]|; `np.median(dx)` in place of dx gives
    the typical (sensitivity) bound."""
    dx, weights = (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                   for v in (dx, weights))
    return float(n_cells * np.max(dx) * abs(float(weights[0])))
