"""The sweep kernels' wrappers (counterpart of
`copula_var_tpu/ops/pallas_quadrature.py`).

`masked_sweep` evaluates L rows of (T,) slab integrals against one set of
bounds-invariant day operands. Tensors on a CUDA device launch the
hand-written kernel `prefix_sweep_kernel` (csrc/quadrature.cu), which
replaces the Pallas kernels `_sweep_block_kernel` (K2) and `_day_kernel`
(K3); tensors on the CPU run the plain twin `masked_sweep_reference`,
i.e. the cached sweeps of `ops/quadrature.py`. There is no other route.

The kernel reads each row's masked sum off the prefix table P: U = V .*
(wfc W1), each row turned into its inclusive prefix sum, (T, n,
row_pitch(n)) float64 (40.4 MB at T = 500, n = 100), and one flag per
(day, row) for rows summed cell by cell (csrc/interval.cuh). On a CUDA
device `sweep_operands` builds P once per backtest with the kernel
`sweep_table_kernel` (`sweep_table`; plain twin `sweep_table_reference`);
on the CPU it builds none.

The GARCH family is the q = 1 case of the same sum (W0 = W1 = dx rows,
unit combination weight); it is not padded to q = 2.

The interval rule reads each row's mask off the grid by binary search,
so operands on a CUDA device need a strictly ascending grid;
`sweep_operands` checks it once.

Grid sharding (`parallel/`): operands built with `rows=(i0, i1)` hold
outer grid rows [i0, i1) of every day (V, wfc, P and flags cut to them;
the inner axis stays the whole grid), and both the kernel and the plain
twin return those rows' share of each sweep. The shares of ranks that
split the rows add up to the sweep (`parallel.mesh.GridMesh.grid_sum`).
Operands of all rows (rows (0, n) or None) give the one-card bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops.quadrature import (
    garch_integrals_cached,
    msm_integrals_cached,
    outer_slice,
    row_range,
    state_weight_matrices,
)

MAX_CELL = 1.0  # interval.cuh kMaxCell: a row with a larger cell is flagged


class SweepOperands(NamedTuple):
    """Bounds-invariant operands of every sweep of one backtest.

    V (T, r, n) day tensors of r outer grid rows (r = n but for a range
    of rows); x, dx (n,) grid and steps. MSM family: densities (2, q, n)
    and forecast_combos (T, q*q); GARCH family: both None. The kernels
    read the hoisted contraction wfc (T, r, q) = W0^T FC_t and w1 (q, n),
    built once here (as `_solve_impl` hoists wfc out of the TPU kernel).
    The sweep kernel reads P (T, r, row_pitch(n)) and flags (T, r) bool,
    the prefix table built from those on a CUDA device; both None on the
    CPU. rows: (i0, i1), the outer grid rows held, or None for all."""

    V: torch.Tensor
    x: torch.Tensor
    dx: torch.Tensor
    densities: Optional[torch.Tensor]
    forecast_combos: Optional[torch.Tensor]
    wfc: torch.Tensor
    w1: torch.Tensor
    P: Optional[torch.Tensor] = None
    flags: Optional[torch.Tensor] = None
    rows: Optional[Tuple[int, int]] = None

    @property
    def days(self) -> int:
        return self.V.shape[0]

    @property
    def row0(self) -> int:
        return 0 if self.rows is None else self.rows[0]



def row_pitch(n: int) -> int:
    """Float64 entries per row of a table: n rounded up to odd (one zero
    pad cell when n is even), so one thread per row scans shared memory
    without bank conflicts."""
    return n | 1


def require_ascending(x):
    """Raise unless the grid x is strictly ascending (one host read)."""
    if not bool((x[1:] > x[:-1]).all()):
        raise ValueError("the kernels' interval rule needs a strictly "
                         "ascending grid x")


def sweep_operands(V, x, dx, densities=None, forecast_combos=None,
                   rows=None):
    """SweepOperands for the MSM family (densities and forecast_combos
    given) or the GARCH family (both None); with `rows` (i0, i1) those of
    outer grid rows [i0, i1) (V the whole (T, n, n) day tensors, which
    are cut here, or already those rows). On a CUDA device the prefix
    table is built here, once."""
    T = V.shape[0]
    if rows is not None:
        rows = row_range(rows, x.shape[0])
        if V.shape[1] != rows[1] - rows[0]:
            V = V[:, rows[0]:rows[1]]
        V = V.contiguous()
    if densities is None:
        w0 = w1 = dx[None, :]
        fc = torch.ones((T, 1, 1), dtype=V.dtype, device=V.device)
    else:
        w0, w1 = state_weight_matrices(densities, dx)
        q = w0.shape[0]
        fc = forecast_combos.reshape(T, q, q)
    if rows is not None:
        w0 = w0[:, rows[0]:rows[1]]
    wfc = torch.einsum("si,tsk->tik", w0, fc).contiguous()
    ops = SweepOperands(V, x, dx, densities, forecast_combos, wfc,
                        w1.contiguous(), rows=rows)
    if V.device.type == "cuda":
        require_ascending(x)
        P, flags = sweep_table(ops)
        ops = ops._replace(P=P, flags=flags)
    return ops


def sweep_table_reference(ops: SweepOperands):
    """Plain twin of the prefix table, on any device: (P (T, r,
    row_pitch(n)), flags (T, r) bool) for the operands' r rows. A row of U = V .* (wfc W1) holding
    a cell outside [-MAX_CELL, MAX_CELL] (NaN included) is flagged and
    kept as its cells; every other row is its inclusive prefix sum. Pad
    cells are 0."""
    U = ops.V * (ops.wfc @ ops.w1)
    n = U.shape[-1]
    flags = ~(U.abs() <= MAX_CELL).all(dim=-1)
    P = U.new_zeros(U.shape[:2] + (row_pitch(n),))
    P[..., :n] = torch.where(flags[..., None], U, torch.cumsum(U, dim=-1))
    return P, flags


def sweep_table(ops: SweepOperands):
    """The prefix table (P, flags) on the operands' CUDA device: the build
    kernel (one block per day and 32 rows). Other devices raise: the CPU
    route sums the cells through the plain sweep and needs no table."""
    dev = ops.V.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_table: unsupported device {dev} (the "
                         "table is built on a CUDA device only)")
    T, n, q = check_day_operands(ops)
    r = ops.V.shape[1]
    P = torch.empty((T, r, row_pitch(n)), dtype=torch.float64, device=dev)
    flags = torch.empty((T, r), dtype=torch.bool, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_sweep_table(
            ops.V.data_ptr(), ops.wfc.data_ptr(), ops.w1.data_ptr(),
            P.data_ptr(), flags.data_ptr(), T, n, r, q, row_pitch(n), stream,
        )
    _build.check(status, "sweep_table")
    sweep_table.launches += 1
    return P, flags


sweep_table.launches = 0  # kernel launches (CUDA path only)


def masked_sweep_reference(ops: SweepOperands, bounds, weights,
                           box_min=-5.0):
    """Plain PyTorch twin, on any device: row l is the cached sweep of
    `ops/quadrature.py` at bounds[l] (T, 2) and weights[l] (2,), the
    share of the operands' outer rows (the local body of JAX's
    `grid_sharded_{msm,garch}_sweep`, without its `psum`). Returns
    (L, T)."""
    outer = outer_slice(ops.rows)
    out = []
    for b, w in zip(bounds, weights):
        if ops.densities is None:
            out.append(garch_integrals_cached(b, ops.V, ops.x, ops.dx, w,
                                              box_min, outer))
        else:
            out.append(msm_integrals_cached(
                b, ops.V, ops.forecast_combos, ops.x, ops.dx, ops.densities,
                w, box_min, outer,
            ))
    return torch.stack(out)


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
    """Validate the per-day operands for a table or sweep launch; returns
    (T, n, q)."""
    T, r, n = ops.V.shape
    q = ops.w1.shape[0]
    dev = ops.V.device
    i0, i1 = (0, n) if ops.rows is None else ops.rows
    if i1 - i0 != r or not 0 <= i0 < i1 <= n:
        raise ValueError(f"V holds {r} outer rows, the operands name rows "
                         f"{ops.rows} of {n}")
    _check_operand("V", ops.V, (T, r, n), dev)
    _check_operand("wfc", ops.wfc, (T, r, q), dev)
    _check_operand("w1", ops.w1, (q, n), dev)
    _check_operand("x", ops.x, (n,), dev)
    n_max = _build.load().cvt_sweep_max_grid_points()
    if n > n_max:
        raise ValueError(
            f"num_points={n}: the dim-2 table and sweep take n <= {n_max}, "
            "the interval rule's longest row (csrc/interval.cuh kMaxRow)"
        )
    return T, n, q


def masked_sweep(ops: SweepOperands, bounds, weights, box_min=-5.0):
    """(L, T) slab integrals for bounds (L, T, 2) and per-row portfolio
    weights (L, 2) ([inner, outer]), the share of the operands' outer
    rows. CPU tensors run the plain twin; CUDA tensors launch the kernel
    on the prefix table (one warp per bound row and day, a
    prefix-interval sum per grid row); any other device raises."""
    dev = ops.V.device
    if dev.type == "cpu":
        return masked_sweep_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_sweep: unsupported device {dev}")
    if ops.P is None or ops.flags is None:
        raise ValueError("masked_sweep: the operands carry no prefix table "
                         "P (build them with sweep_operands)")
    T, r, n = ops.V.shape
    _check_operand("P", ops.P, (T, r, row_pitch(n)), dev)
    _check_operand("flags", ops.flags, (T, r), dev, torch.bool)
    _check_operand("x", ops.x, (n,), dev)
    L = bounds.shape[0]
    _check_operand("bounds", bounds, (L, T, 2), dev)
    _check_operand("weights", weights, (L, 2), dev)
    out = torch.empty((L, T), dtype=torch.float64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.cvt_masked_sweep(
            ops.P.data_ptr(), ops.flags.data_ptr(), ops.x.data_ptr(),
            bounds.data_ptr(), weights.data_ptr(), float(box_min),
            out.data_ptr(), T, n, ops.row0, r, L, row_pitch(n), stream,
        )
    _build.check(status, "masked_sweep")
    masked_sweep.launches += 1
    return out


masked_sweep.launches = 0  # kernel launches (CUDA path only)
