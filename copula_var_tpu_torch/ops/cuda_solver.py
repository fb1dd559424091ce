"""The bisection kernel's wrapper and the full three-stage solve
(counterpart of `copula_var_tpu/ops/pallas_solver.py` and of the `xla`
engine's device programs in `copula_var_tpu/backtest.py`).

`bisect_levels` runs the incremental-CDF bisection for L rows (confidence
levels or portfolios). Tensors on a CUDA device launch the hand-written
kernel `bisect_levels_kernel` (csrc/quadrature.cu), which replaces the
Pallas kernel `_solve_kernel` (K1); tensors on the CPU run the plain twin
`bisect_levels_reference`, the `xla` engine's while-loop with its
per-level all-zeros break (`backtest.py:445-480`).

The while-loop halves every (row, day) bracket until the widest is within
tolerance, so all rows run one data-dependent global count. The kernel
gets that count from the host: one `.item()` of the widest bracket after
the bracketing stages, halved until it is within tolerance. The all-zeros
break is the one difference (see the kernel source).

`full_solve_levels` / `full_solve_portfolios` port
`_device_full_solve_levels_jit` / `_device_full_solve_portfolios_jit`:
stage-1 sweep over [-100, first_guess], stage-2 bracket, bisection. Their
`*_reference` forms run the same flow through the plain twins on any
device, so the two can be compared on the card.
"""

from __future__ import annotations

import torch

from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops.cuda_quadrature import (
    SweepOperands,
    _check_operand,
    check_day_operands,
    masked_sweep,
    masked_sweep_reference,
)
from copula_var_tpu_torch.ops.solvers import bracket_state_batched


def halvings(width: float, tolerance: float) -> int:
    """Iterations the while-loop bisection runs from a widest bracket of
    `width`: halve until the width is within `tolerance`."""
    k = 0
    while width > tolerance:
        width *= 0.5
        k += 1
    return k


def bisect_levels_reference(ops: SweepOperands, lower, upper, prev_res,
                            prev_up, ustack, obj, weights, tolerance,
                            box_min=-5.0):
    """Plain twin on any device: the `xla` engine's whole-array
    bisection over the (L, T) state. Rows whose results are all exactly
    zero freeze (the reference's early break). Returns (L, T) roots."""
    obj2 = obj[:, None]
    lo, up, pr, pu, us = lower, upper, prev_res, prev_up, ustack
    brk = torch.zeros(lo.shape[0], dtype=torch.bool, device=lo.device)
    while bool(((up - lo > tolerance) & ~brk[:, None]).any()):
        mid = (lo + up) / 2.0
        b_lo = torch.where(us, lo, mid)
        b_up = torch.where(us, mid, up)
        slab = masked_sweep_reference(
            ops, torch.stack((b_lo, b_up), dim=-1), weights, box_min
        )
        add = b_lo == pu
        result = torch.where(add, pr + slab, pr - slab)
        zero = torch.all(result == 0.0, dim=1)
        us_n = result < obj2
        lo_n = torch.where(~us_n, lo, mid)
        up_n = torch.where(us_n, up, mid)
        frozen = (zero | brk)[:, None]
        lo = torch.where(frozen, lo, lo_n)
        up = torch.where(frozen, up, up_n)
        pr = torch.where(frozen, pr, result)
        pu = torch.where(frozen, pu, mid)
        us = torch.where(frozen, us, us_n)
        brk = brk | zero
    return (lo + up) / 2.0


def bisect_levels(ops: SweepOperands, lower, upper, prev_res, prev_up,
                  ustack, obj, weights, tolerance, box_min=-5.0):
    """(L, T) bisection roots. State lower/upper/prev_res/prev_up (L, T)
    float64, ustack (L, T) bool, obj (L,), weights (L, 2). CPU tensors
    run the plain twin; CUDA tensors launch the kernel for the global
    iteration count; any other device raises."""
    dev = ops.V.device
    if dev.type == "cpu":
        return bisect_levels_reference(ops, lower, upper, prev_res, prev_up,
                                       ustack, obj, weights, tolerance,
                                       box_min)
    if dev.type != "cuda":
        raise ValueError(f"bisect_levels: unsupported device {dev}")
    T, n, q = check_day_operands(ops)
    L = lower.shape[0]
    for name, t in (("lower", lower), ("upper", upper),
                    ("prev_res", prev_res), ("prev_up", prev_up)):
        _check_operand(name, t, (L, T), dev)
    _check_operand("ustack", ustack, (L, T), dev, torch.bool)
    _check_operand("obj", obj, (L,), dev)
    _check_operand("weights", weights, (L, 2), dev)
    n_iters = halvings(float((upper - lower).max()), tolerance)
    roots = torch.empty((L, T), dtype=torch.float64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_bisect_levels(
            ops.V.data_ptr(), ops.wfc.data_ptr(), ops.w1.data_ptr(),
            ops.x.data_ptr(), lower.data_ptr(), upper.data_ptr(),
            prev_res.data_ptr(), prev_up.data_ptr(), ustack.data_ptr(),
            obj.data_ptr(), weights.data_ptr(), float(box_min), n_iters,
            roots.data_ptr(), T, n, q, L, stream,
        )
    _build.check(status, "bisect_levels")
    bisect_levels.launches += 1
    return roots


bisect_levels.launches = 0  # kernel launches (CUDA path only)


def _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min, sweep,
                bisect):
    """Stage-1 sweep + stage-2 bracket + bisection for L rows. weights is
    (2,) for one portfolio shared by every row (one stage-1 sweep serves
    them all) or (L, 2) for one portfolio per row. `sweep`/`bisect` are
    the dispatching wrappers or their plain twins. Returns
    (roots (L, T), nan_days (L, T))."""
    T, L = ops.V.shape[0], obj.shape[0]
    dev = ops.V.device
    stage1 = torch.stack(
        [torch.full((T,), -100.0, dtype=torch.float64, device=dev),
         torch.full((T,), float(cfg[0]), dtype=torch.float64, device=dev)],
        dim=-1,
    )
    if weights.dim() == 1:
        weights = weights.reshape(1, 2)
        F1 = sweep(ops, stage1[None], weights, box_min).expand(L, T)
        weights = weights.expand(L, 2).contiguous()
    else:
        F1 = sweep(ops, stage1.expand(L, T, 2).contiguous(), weights, box_min)
    lower, upper, prev_res, prev_up, ustack, nan_days = bracket_state_batched(
        F1, obj, lambda b: sweep(ops, b.contiguous(), weights, box_min), cfg,
        quirks,
    )
    roots = bisect(ops, lower.contiguous(), upper.contiguous(),
                   prev_res.contiguous(), prev_up.contiguous(),
                   ustack.contiguous(), obj, weights, tolerance, box_min)
    return roots, nan_days


def full_solve_levels(ops, obj, weights, cfg, tolerance=1e-6, quirks=False,
                      box_min=-5.0):
    """All L confidence levels `obj` (L,) of one portfolio `weights` (2,)
    -> (roots (L, T), nan_days (L, T)), through the kernels on a CUDA
    device and the plain twins on the CPU. cfg = (first_guess, sg0, sg1,
    min_var, max_var)."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       masked_sweep, bisect_levels)


def full_solve_levels_reference(ops, obj, weights, cfg, tolerance=1e-6,
                                quirks=False, box_min=-5.0):
    """`full_solve_levels` through the plain twins, on any device."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       masked_sweep_reference, bisect_levels_reference)


def full_solve_portfolios(ops, obj, weights, cfg, tolerance=1e-6,
                          quirks=False, box_min=-5.0):
    """L portfolio rows, row l with its own weights[l] (L, 2) and level
    obj[l] -> (roots (L, T), nan_days (L, T))."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       masked_sweep, bisect_levels)


def full_solve_portfolios_reference(ops, obj, weights, cfg, tolerance=1e-6,
                                    quirks=False, box_min=-5.0):
    """`full_solve_portfolios` through the plain twins, on any device."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       masked_sweep_reference, bisect_levels_reference)
