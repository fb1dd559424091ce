"""Stage-2 bracketing of the VaR solve (counterpart of
`copula_var_tpu/ops/solvers.py::bracket_state_batched`)."""

from __future__ import annotations

import torch


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
