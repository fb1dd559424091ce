"""The sweep kernel's wrapper (counterpart of
`copula_var_tpu/ops/pallas_quadrature.py`).

`masked_sweep` evaluates L rows of (T,) slab integrals against one set of
bounds-invariant day operands. Tensors on a CUDA device launch the
hand-written kernel `masked_sweep_kernel` (csrc/quadrature.cu), which
replaces the Pallas kernels `_sweep_block_kernel` (K2) and `_day_kernel`
(K3); tensors on the CPU run the plain twin `masked_sweep_reference`,
i.e. the cached sweeps of `ops/quadrature.py`. There is no other route.

The GARCH family is the q = 1 case of the same sum (W0 = W1 = dx rows,
unit combination weight); it is not padded to q = 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops.quadrature import (
    garch_integrals_cached,
    msm_integrals_cached,
    state_weight_matrices,
)


class SweepOperands(NamedTuple):
    """Bounds-invariant operands of every sweep of one backtest.

    V (T, n, n) day tensors; x, dx (n,) grid and steps. MSM family:
    densities (2, q, n) and forecast_combos (T, q*q); GARCH family: both
    None. The kernel reads the hoisted contraction wfc (T, n, q) =
    W0^T FC_t and w1 (q, n), built once here (as `_solve_impl` hoists
    wfc out of the TPU kernel)."""

    V: torch.Tensor
    x: torch.Tensor
    dx: torch.Tensor
    densities: Optional[torch.Tensor]
    forecast_combos: Optional[torch.Tensor]
    wfc: torch.Tensor
    w1: torch.Tensor


def sweep_operands(V, x, dx, densities=None, forecast_combos=None):
    """SweepOperands for the MSM family (densities and forecast_combos
    given) or the GARCH family (both None)."""
    T = V.shape[0]
    if densities is None:
        w0 = w1 = dx[None, :]
        fc = torch.ones((T, 1, 1), dtype=V.dtype, device=V.device)
    else:
        w0, w1 = state_weight_matrices(densities, dx)
        q = w0.shape[0]
        fc = forecast_combos.reshape(T, q, q)
    wfc = torch.einsum("si,tsk->tik", w0, fc).contiguous()
    return SweepOperands(V, x, dx, densities, forecast_combos, wfc,
                         w1.contiguous())


def masked_sweep_reference(ops: SweepOperands, bounds, weights,
                           box_min=-5.0):
    """Plain PyTorch twin, on any device: row l is the cached sweep of
    `ops/quadrature.py` at bounds[l] (T, 2) and weights[l] (2,).
    Returns (L, T)."""
    rows = []
    for b, w in zip(bounds, weights):
        if ops.densities is None:
            rows.append(garch_integrals_cached(b, ops.V, ops.x, ops.dx, w,
                                               box_min))
        else:
            rows.append(msm_integrals_cached(
                b, ops.V, ops.forecast_combos, ops.x, ops.dx, ops.densities,
                w, box_min,
            ))
    return torch.stack(rows)


def _check_operand(name, t, shape, device, dtype=torch.float64):
    if t.device != device or t.dtype != dtype:
        raise ValueError(
            f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_day_operands(ops: SweepOperands):
    """Validate the per-day operands for a kernel launch; returns
    (T, n, q)."""
    T, n, _ = ops.V.shape
    q = ops.w1.shape[0]
    dev = ops.V.device
    _check_operand("V", ops.V, (T, n, n), dev)
    _check_operand("wfc", ops.wfc, (T, n, q), dev)
    _check_operand("w1", ops.w1, (q, n), dev)
    _check_operand("x", ops.x, (n,), dev)
    n_max = _build.load().cvt_max_grid_points()
    if n > n_max:
        raise ValueError(
            f"num_points={n} needs {n}x{n} float64 in one block's shared "
            f"memory; the kernels take n <= {n_max} (tiling is later work)"
        )
    return T, n, q


def masked_sweep(ops: SweepOperands, bounds, weights, box_min=-5.0):
    """(L, T) slab integrals for bounds (L, T, 2) and per-row portfolio
    weights (L, 2) ([inner, outer]). CPU tensors run the plain twin; CUDA
    tensors launch the kernel (one block per day, every row against the
    shared-memory-resident day); any other device raises."""
    dev = ops.V.device
    if dev.type == "cpu":
        return masked_sweep_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_sweep: unsupported device {dev}")
    T, n, q = check_day_operands(ops)
    L = bounds.shape[0]
    _check_operand("bounds", bounds, (L, T, 2), dev)
    _check_operand("weights", weights, (L, 2), dev)
    out = torch.empty((L, T), dtype=torch.float64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_masked_sweep(
            ops.V.data_ptr(), ops.wfc.data_ptr(), ops.w1.data_ptr(),
            ops.x.data_ptr(), bounds.data_ptr(), weights.data_ptr(),
            float(box_min), out.data_ptr(), T, n, q, L, stream,
        )
    _build.check(status, "masked_sweep")
    masked_sweep.launches += 1
    return out


masked_sweep.launches = 0  # kernel launches (CUDA path only)
