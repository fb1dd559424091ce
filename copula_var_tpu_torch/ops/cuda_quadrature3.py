"""The dim-3 sweep kernel's wrapper (counterpart of
`copula_var_tpu/ops/pallas_quadrature3.py`).

`masked_contract3` evaluates L rows of (T,) slab integrals of a
three-asset backtest from its bounds-invariant `Contract3Operands`.
Tensors on a CUDA device launch the hand-written kernel
`contract3_slab_kernel` (csrc/contract3.cu), which replaces the Pallas
kernel `_kernel3` (K4); tensors on the CPU run the plain twin
`masked_contract3_reference`, i.e. the transform-cached sweeps of
`ops/quadrature.py`, row by row. There is no other route.

The operands are the float64 counterparts of `build_msm_dim3_cache` /
`build_garch_dim3_cache`, without the TPU layout: no packed f32
constants or bounds, no one-hot reads, no f32 booleans, no unit pdf
columns for the MSM family. The state reduction is folded into
G[t, i0, b, c] = sum_a W0[a, i0] FC[t, a, b, c] (W0 = densities[2] dx,
the rotated rows); the GARCH family is the q = 1 case with G = dx.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops.cuda_quadrature import _check_operand
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    _chol_inv_logdet,
    garch_integrals_tcached,
    msm_integrals_tcached,
    state_weight_matrices,
    student_log_norm,
)


class Contract3Operands(NamedTuple):
    """Bounds-invariant operands of every dim-3 sweep of one backtest.

    Plain twin's inputs: spec; cols, the transform columns (leaves
    (T, 3, n)); p_cols (T, 3, n) for the GARCH family, else None; x, dx
    (n,); densities (3, q, n) and forecast_combos (T, q^3) for the MSM
    family, else None.
    Kernel's inputs: z, lu (T, 3, n) float64 and fin (T, 3, n) bool (for
    the Gaussian copula fin is all true and lu unused); w1, w2 (q, n) the
    weight rows of grid dims 1 and 2; G (T, n, q, q); sigma_inv (3, 3);
    the Student normalizer log_norm (incl. -logdet / 2), logdet and nu
    as floats."""

    spec: CopulaSpec
    cols: tuple
    p_cols: Optional[torch.Tensor]
    x: torch.Tensor
    dx: torch.Tensor
    densities: Optional[torch.Tensor]
    forecast_combos: Optional[torch.Tensor]
    z: torch.Tensor
    fin: torch.Tensor
    lu: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    G: torch.Tensor
    sigma_inv: torch.Tensor
    log_norm: float
    logdet: float
    nu: float

    @property
    def days(self) -> int:
        return self.z.shape[0]


def _require_kernel_copula(kind: str) -> None:
    if kind not in ("gaussian", "student"):
        raise ValueError(
            f"the dim-3 path takes the Gaussian or Student copula, not "
            f"{kind!r} (Plackett is bivariate; ROADMAP.md queue 1, item 10)"
        )


def contract3_operands(cols, x, dx, spec: CopulaSpec, densities=None,
                       forecast_combos=None, p_cols=None):
    """Contract3Operands for the MSM family (densities and
    forecast_combos given) or the GARCH family (p_cols given)."""
    _require_kernel_copula(spec.kind)
    if spec.kind == "student":
        nu, corr = spec.params
        z, fin, lu = cols
        nu = float(nu)
    else:
        (corr,) = spec.params
        (z,) = cols
        fin = torch.ones(z.shape, dtype=torch.bool, device=z.device)
        lu = torch.zeros_like(z)
        nu = 0.0
    T, dim, n = z.shape
    if dim != 3:
        raise ValueError(f"Contract3Operands: expected 3 assets, got {dim}")
    sigma_inv, logdet = _chol_inv_logdet(corr)
    log_norm = (float(student_log_norm(nu, logdet, 3))
                if spec.kind == "student" else 0.0)
    if densities is None:
        w1 = w2 = dx[None, :]
        G = dx[None, :, None, None].expand(T, n, 1, 1)
    else:
        w0, w1, w2 = state_weight_matrices(densities, dx)
        q = w0.shape[0]
        G = torch.einsum("ai,tabc->tibc", w0,
                         forecast_combos.reshape(T, q, q, q))
    return Contract3Operands(
        spec, tuple(cols), None if p_cols is None else p_cols.contiguous(),
        x, dx, densities, forecast_combos,
        z.contiguous(), fin.contiguous(), lu.contiguous(), w1.contiguous(),
        w2.contiguous(), G.contiguous(), sigma_inv.contiguous(), log_norm,
        float(logdet), nu,
    )


def masked_contract3_reference(ops: Contract3Operands, bounds, weights,
                               box_min=-5.0):
    """Plain PyTorch twin, on any device: row l is the transform-cached
    sweep of `ops/quadrature.py` at bounds[l] (T, 2) and weights[l] (3,).
    Returns (L, T)."""
    rows = []
    for b, w in zip(bounds, weights):
        if ops.p_cols is None:
            rows.append(msm_integrals_tcached(
                b, ops.cols, ops.forecast_combos, ops.x, ops.dx,
                ops.densities, w, ops.spec, box_min))
        else:
            rows.append(garch_integrals_tcached(
                b, ops.cols, ops.p_cols, ops.x, ops.dx, w, ops.spec,
                box_min))
    return torch.stack(rows)


def check_contract3_operands(ops: Contract3Operands):
    """Validate the operands for a kernel launch; returns (T, n, q)."""
    _require_kernel_copula(ops.spec.kind)
    T, _, n = ops.z.shape
    q = ops.w1.shape[0]
    dev = ops.z.device
    for name in ("z", "lu"):
        _check_operand(name, getattr(ops, name), (T, 3, n), dev)
    _check_operand("fin", ops.fin, (T, 3, n), dev, torch.bool)
    if ops.p_cols is not None:
        _check_operand("p_cols", ops.p_cols, (T, 3, n), dev)
    _check_operand("x", ops.x, (n,), dev)
    _check_operand("w1", ops.w1, (q, n), dev)
    _check_operand("w2", ops.w2, (q, n), dev)
    _check_operand("G", ops.G, (T, n, q, q), dev)
    _check_operand("sigma_inv", ops.sigma_inv, (3, 3), dev)
    n_max = _build.load().cvt_contract3_max_grid_points(q)
    if n > n_max:
        raise ValueError(
            f"num_points={n} needs an {n}x{n} float64 slab in one block's "
            f"shared memory; the dim-3 kernel takes n <= {n_max} at q={q} "
            "(tiling is later work)"
        )
    return T, n, q


def masked_contract3(ops: Contract3Operands, bounds, weights, box_min=-5.0):
    """(L, T) slab integrals for bounds (L, T, 2) and per-row portfolio
    weights (L, 3) ([inner, outer0, outer1]). CPU tensors run the plain
    twin; CUDA tensors launch the kernel (one block per (day, outer
    index) slab, every row against the shared-memory-resident slab, then
    a fixed-order sum over the outer index); any other device raises."""
    dev = ops.z.device
    if dev.type == "cpu":
        return masked_contract3_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_contract3: unsupported device {dev}")
    T, n, q = check_contract3_operands(ops)
    L = bounds.shape[0]
    _check_operand("bounds", bounds, (L, T, 2), dev)
    _check_operand("weights", weights, (L, 3), dev)
    partial = torch.empty((L, T, n), dtype=torch.float64, device=dev)
    out = torch.empty((L, T), dtype=torch.float64, device=dev)
    p = None if ops.p_cols is None else ops.p_cols.data_ptr()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_masked_contract3(
            ops.x.data_ptr(), ops.z.data_ptr(), ops.fin.data_ptr(),
            ops.lu.data_ptr(), p, ops.w1.data_ptr(), ops.w2.data_ptr(),
            ops.G.data_ptr(), ops.sigma_inv.data_ptr(),
            int(ops.spec.kind == "student"), ops.nu, ops.log_norm,
            ops.logdet, bounds.data_ptr(), weights.data_ptr(),
            float(box_min), partial.data_ptr(), out.data_ptr(), T, n, q, L,
            stream,
        )
    _build.check(status, "masked_contract3")
    masked_contract3.launches += 1
    return out


masked_contract3.launches = 0  # kernel launches (CUDA path only)
