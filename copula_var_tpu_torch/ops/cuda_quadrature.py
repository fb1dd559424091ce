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
`sweep_operands` checks it once. It takes rows of up to
SWEEP_MAX_GRID_POINTS = 1024 cells (`csrc/interval.cuh` kMaxRow), so the
table and the sweep serve every n up to 1024 whose P fits in the card's
free memory (P is 661 MB at n = 406, T = 500); past either limit
`sweep_operands` raises, naming it. The bisection kernel K1 holds a day
in shared memory and takes n <= `bisect_max_grid_points()` (169); wider
grids bisect by K2 sweeps (`ops/cuda_solver.py`).

The limits are `ops/_build.py`'s, which it compiles into the kernels, and
the routes are computed from them here, so a route can be chosen, and
tested, without the library; the launchers refuse what passes them.

The f32 engine (`engine="pallas"`, the JAX package's f32 Pallas kernels):
`sweep_operands(..., dtype=torch.float32)` casts the f64 day tensors,
grid and weight rows to float32 (wfc = W0^T FC formed in float32 from
them, as JAX's `_solve_impl` forms it) and builds an f32 P (20.2 MB at
the flagship size) with the float instantiation of the same kernel;
`masked_sweep` on f32 operands launches the f32 sweep. Its plain twins
are the same cached sweeps run on the float32 tensors. K1's day in
float takes half the shared memory: `bisect_max_grid_points(torch.
float32)` = 192, the short rows. Each wrapper counts its launches in
`utils.profiling.counters()`, as `launch.<wrapper>` (float64) and
`launch.<wrapper>.f32` (float32), and its host side, from the operand
checks to the launch's status, is the span `launch.<wrapper>`.

Grid sharding (`parallel/`): operands built with `rows=(i0, i1)` hold
outer grid rows [i0, i1) of every day (V, wfc, P and flags cut to them;
the inner axis stays the whole grid), and both the kernel and the plain
twin return those rows' share of each sweep. The shares of ranks that
split the rows add up to the sweep (`parallel.mesh.GridMesh.grid_sum`).
Operands of all rows (rows (0, n) or None) give the one-card bits.

Day sharding (`parallel/`): operands built with `days=` (a slice of the
T days) hold one rank's block, cut from the whole after every product is
formed over all T. A rank's block may be empty (T = 0 days); a wrapper
then returns its empty result and launches nothing.
"""

from __future__ import annotations

import functools
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
from copula_var_tpu_torch.utils.profiling import count, counters, span

F64, F32 = torch.float64, torch.float32
MAX_CELL = 1.0  # interval.cuh kMaxCell: a row with a larger cell is flagged
SWEEP_MAX_GRID_POINTS = 32 * _build.MAX_CHUNKS  # the rule's longest row
BISECT_MAX_ROW = 32 * _build.SHORT_CHUNKS  # the rows K1 is compiled for
MAX_SHARED_BYTES = _build.MAX_SHARED_BYTES


class SweepOperands(NamedTuple):
    """Bounds-invariant operands of every sweep of one backtest.

    V (T, r, n) day tensors of r outer grid rows (r = n but for a range
    of rows); x, dx (n,) grid and steps. MSM family: densities (2, q, n)
    and forecast_combos (T, q*q); GARCH family: both None. The kernels
    read the hoisted contraction wfc (T, r, q) = W0^T FC_t and w1 (q, n),
    built once here (as `_solve_impl` hoists wfc out of the TPU kernel).
    The sweep kernel reads P (T, r, row_pitch(n)) and flags (T, r) bool,
    the prefix table built from those on a CUDA device; both None on the
    CPU. rows: (i0, i1), the outer grid rows held, or None for all. The
    floating tensors are all float64 (the f64 engine) or all float32 (the
    f32 engine)."""

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

    @property
    def dtype(self) -> torch.dtype:
        return self.V.dtype


def itemsize(dtype) -> int:
    """Bytes of one entry of a kernel's working type (float64: 8,
    float32: 4); any other type raises."""
    if dtype not in (F64, F32):
        raise ValueError(f"the kernels take float64 or float32, not {dtype}")
    return 8 if dtype == F64 else 4


def count_launch(wrapper, dtype) -> None:
    """One more launch on `wrapper`'s counter of `dtype`:
    `launch.<wrapper>` (float64) or `launch.<wrapper>.f32` (float32)."""
    count(_launch_counter(wrapper, dtype))


def launch_count(wrapper, dtype=F64) -> int:
    """`wrapper`'s launches of `dtype` so far (its `count_launch`
    counter)."""
    return counters().get(_launch_counter(wrapper, dtype), 0)


def _launch_counter(wrapper, dtype) -> str:
    return f"launch.{wrapper.__name__}" + (".f32" if dtype == F32 else "")


def row_pitch(n: int) -> int:
    """Entries per row of a table: n rounded up to odd (one zero pad cell
    when n is even), so one thread per row scans shared memory without
    bank conflicts."""
    return n | 1


def bisect_shared_bytes(n: int, dtype=F64) -> int:
    """K1's shared memory for a day of n points: the (n, row_pitch(n))
    prefix rows and x of `dtype`, a flag byte per row."""
    return (n * row_pitch(n) + n) * itemsize(dtype) + n


@functools.lru_cache(maxsize=None)
def bisect_max_grid_points(dtype=F64) -> int:
    """The largest n whose day K1 holds in one block's shared memory (169
    in float64, 192 in float32), no longer than the short rows it is
    compiled for. Searched once per type: every dim-2 solve on a CUDA
    device reads it, and the search takes ~40 µs of host time."""
    n = 1
    while (n + 1 <= BISECT_MAX_ROW
           and bisect_shared_bytes(n + 1, dtype) <= MAX_SHARED_BYTES):
        n += 1
    return n


def prefix_table_bytes(T: int, n: int, rows: Optional[int] = None,
                       dtype=F64) -> int:
    """Bytes of P and its flags, (T, rows, row_pitch(n)) of `dtype` and
    (T, rows) bool (rows: the outer rows held, n by default)."""
    r = n if rows is None else rows
    return T * r * (row_pitch(n) * itemsize(dtype) + 1)


def require_prefix_table_fits(T: int, n: int, free_bytes: int,
                              rows: Optional[int] = None,
                              dtype=F64) -> None:
    """Raise unless P of `rows` outer rows (n by default) fits in
    `free_bytes` of device memory."""
    need = prefix_table_bytes(T, n, rows, dtype)
    if need > free_bytes:
        raise RuntimeError(
            f"the dim-2 prefix table P of T={T} days at num_points={n} "
            f"needs {need} bytes ({need / 2**30:.2f} GiB) of device memory, "
            f"but only {free_bytes} bytes are free (the dim-2 sweep reads "
            "P; shard the days or the grid over more cards)")


def free_device_bytes(dev: torch.device) -> int:
    """Bytes a new tensor on `dev` can take: the device's free memory
    (`cudaMemGetInfo`) plus the blocks PyTorch's caching allocator holds
    unused."""
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return torch.cuda.mem_get_info(dev)[0] + cached


def require_ascending(x):
    """Raise unless the grid x is strictly ascending (one host read)."""
    with span("sync.ascending"):
        ascending = bool((x[1:] > x[:-1]).all())
    if not ascending:
        raise ValueError("the kernels' interval rule needs a strictly "
                         "ascending grid x")


def require_full_f32_matmul(dev) -> None:
    """Raise if float32 products on `dev` would run in TF32: the f32
    engine forms wfc (and its plain twins their sandwiches) in full
    float32, as JAX's f32 engine does."""
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the f32 engine needs full-float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (TF32 keeps "
            "about three decimal digits)")


def cut_days(t, days):
    """`t`'s days `days` (a slice of its leading axis) as a tensor of its
    own, so the whole can be freed; `t` itself when `days` is None."""
    return t if days is None else t[days].clone()


def sweep_operands(V, x, dx, densities=None, forecast_combos=None,
                   rows=None, dtype=F64, table=True, days=None):
    """SweepOperands of `dtype` for the MSM family (densities and
    forecast_combos given) or the GARCH family (both None), from the
    float64 inputs; with `rows` (i0, i1) those of outer grid rows
    [i0, i1) (V the whole (T, n, n) day tensors, which are cut here, or
    already those rows). float32 (the f32 engine): V, x, dx, the
    densities, the combos and the weight rows cast to float32, and
    wfc = W0^T nan_to_num(FC) formed in float32, as JAX's f32 engine
    forms it. With `days` (a slice of the T days: a day mesh's block)
    the operands of those days, cut after wfc is formed over all T, so
    a block holds the bits its days have in the whole (a batched product
    may round by its batch). On a CUDA device the prefix table is built
    here, once, unless `table` is False (the f32 engine's refine pass
    reads the float64 V alone)."""
    itemsize(dtype)
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
    if dtype == F32:
        require_full_f32_matmul(V.device)
        V, x, dx = V.to(F32).contiguous(), x.to(F32), dx.to(F32)
        w0, w1, fc = w0.to(F32), w1.to(F32), torch.nan_to_num(fc.to(F32))
        if densities is not None:
            densities = densities.to(F32)
            forecast_combos = forecast_combos.to(F32)
    wfc = torch.einsum("si,tsk->tik", w0, fc).contiguous()
    if forecast_combos is not None:
        forecast_combos = cut_days(forecast_combos, days)
    ops = SweepOperands(cut_days(V, days), x, dx, densities, forecast_combos,
                        cut_days(wfc, days), w1.contiguous(), rows=rows)
    if V.device.type == "cuda" and table:
        ops = with_prefix_table(ops)
    return ops


def with_prefix_table(ops: SweepOperands) -> SweepOperands:
    """The operands with their prefix table (P, flags) on their CUDA
    device, built once by `sweep_table` (operands that hold it come back
    as they are)."""
    if ops.P is not None:
        return ops
    require_ascending(ops.x)
    P, flags = sweep_table(ops)
    return ops._replace(P=P, flags=flags)


def sweep_table_reference(ops: SweepOperands):
    """Plain twin of the prefix table, on any device: (P (T, r,
    row_pitch(n)), flags (T, r) bool) for the operands' r rows. A row of
    U = V .* (wfc W1) holding a cell outside [-MAX_CELL, MAX_CELL] (NaN
    included) is flagged and kept as its cells; every other row is its
    inclusive prefix sum, accumulated in float64 and stored in the
    operands' type, as the kernel stores it. Pad cells are 0."""
    U = ops.V * (ops.wfc @ ops.w1)
    n = U.shape[-1]
    flags = ~(U.abs() <= MAX_CELL).all(dim=-1)
    P = U.new_zeros(U.shape[:2] + (row_pitch(n),))
    prefix = torch.cumsum(U.to(F64), dim=-1).to(U.dtype)
    P[..., :n] = torch.where(flags[..., None], U, prefix)
    return P, flags


def sweep_table(ops: SweepOperands):
    """The prefix table (P, flags) on the operands' CUDA device: the build
    kernel (one block per day and up to 32 rows), launched after checking
    that the card's free memory holds the table. Other devices raise: the
    CPU route sums the cells through the plain sweep and needs no
    table."""
    dev = ops.V.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_table: unsupported device {dev} (the "
                         "table is built on a CUDA device only)")
    with span("launch.sweep_table"):
        T, n, q = check_day_operands(ops)
        r, dt = ops.V.shape[1], ops.dtype
        require_prefix_table_fits(T, n, free_device_bytes(dev), r, dt)
        P = torch.empty((T, r, row_pitch(n)), dtype=dt, device=dev)
        flags = torch.empty((T, r), dtype=torch.bool, device=dev)
        count("prep.table_bytes", P.nbytes + flags.nbytes)
        if T == 0:  # an empty day block: no launch
            return P, flags
        fn = _build.function("cvt_sweep_table", dt)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.V.data_ptr(), ops.wfc.data_ptr(), ops.w1.data_ptr(),
                P.data_ptr(), flags.data_ptr(), T, n, r, q, row_pitch(n),
                stream,
            )
        _build.check(status, "sweep_table")
    count_launch(sweep_table, dt)
    return P, flags


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


def _check_operand(name, t, shape, device, dtype=F64):
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
    dev, dt = ops.V.device, ops.dtype
    itemsize(dt)
    i0, i1 = (0, n) if ops.rows is None else ops.rows
    if i1 - i0 != r or not 0 <= i0 < i1 <= n:
        raise ValueError(f"V holds {r} outer rows, the operands name rows "
                         f"{ops.rows} of {n}")
    _check_operand("V", ops.V, (T, r, n), dev, dt)
    _check_operand("wfc", ops.wfc, (T, r, q), dev, dt)
    _check_operand("w1", ops.w1, (q, n), dev, dt)
    _check_operand("x", ops.x, (n,), dev, dt)
    if n > SWEEP_MAX_GRID_POINTS:
        raise ValueError(
            f"num_points={n}: the dim-2 table and sweep take n <= "
            f"{SWEEP_MAX_GRID_POINTS}, the interval rule's longest row "
            "(csrc/interval.cuh kMaxRow)"
        )
    return T, n, q


def masked_sweep(ops: SweepOperands, bounds, weights, box_min=-5.0):
    """(L, T) slab integrals for bounds (L, T, 2) and per-row portfolio
    weights (L, 2) ([inner, outer]), the share of the operands' outer
    rows, all of the operands' type (float64, or float32 for the f32
    engine). CPU tensors run the plain twin; CUDA tensors launch the
    kernel of that type on the prefix table (one warp per bound row and
    day, a prefix-interval sum per grid row); any other device raises."""
    dev = ops.V.device
    if dev.type == "cpu":
        return masked_sweep_reference(ops, bounds, weights, box_min)
    if dev.type != "cuda":
        raise ValueError(f"masked_sweep: unsupported device {dev}")
    with span("launch.masked_sweep"):
        if ops.P is None or ops.flags is None:
            raise ValueError("masked_sweep: the operands carry no prefix "
                             "table P (build them with sweep_operands)")
        T, r, n = ops.V.shape
        dt = ops.dtype
        itemsize(dt)
        _check_operand("P", ops.P, (T, r, row_pitch(n)), dev, dt)
        _check_operand("flags", ops.flags, (T, r), dev, torch.bool)
        _check_operand("x", ops.x, (n,), dev, dt)
        L = bounds.shape[0]
        _check_operand("bounds", bounds, (L, T, 2), dev, dt)
        _check_operand("weights", weights, (L, 2), dev, dt)
        out = torch.empty((L, T), dtype=dt, device=dev)
        if out.numel() == 0:  # an empty day block: no launch
            return out
        fn = _build.function("cvt_masked_sweep", dt)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.P.data_ptr(), ops.flags.data_ptr(), ops.x.data_ptr(),
                bounds.data_ptr(), weights.data_ptr(), float(box_min),
                out.data_ptr(), T, n, ops.row0, r, L, row_pitch(n), stream,
            )
        _build.check(status, "masked_sweep")
    count_launch(masked_sweep, dt)
    return out
