"""The bisection kernel's wrapper and the full three-stage solve
(counterpart of `copula_var_tpu/ops/pallas_solver.py` and of the `xla`
engine's device programs in `copula_var_tpu/backtest.py`).

`bisect_levels` runs the incremental-CDF bisection for L rows (confidence
levels or portfolios) of a two-asset backtest. Tensors on a CUDA device
launch the hand-written kernel `bisect_levels_kernel` (csrc/quadrature.cu;
one warp per bound row, every halving a prefix-interval sum per grid
row), which replaces the Pallas kernel `_solve_kernel` (K1); tensors on
the CPU run the plain twin `bisect_levels_reference`, the `xla` engine's
while-loop with its per-level all-zeros break (`backtest.py:445-480`).

The while-loop halves every (row, day) bracket until the widest is within
tolerance, so all rows run one data-dependent global count. The kernel
gets that count from the host: one `.item()` of the widest bracket after
the bracketing stages, halved until it is within tolerance. The all-zeros
break is the one difference (see the kernel source).

`bisect_contract3` is the three-asset bisection. The JAX package has no
fused dim-3 bisection: its while-loop calls the sweep every halving. On a
CUDA device the port runs the host-counted number of halvings, each one
`masked_contract3` launch (or `masked_contract3_rebuild` for operands
built without the table U) plus the bookkeeping as device ops; the
all-zeros freeze and the while-loop's own exit are `torch.where` gates on
the device, so no halving reads the host and the roots equal the
while-loop's.

Routes by width (`dim2_bisect_route`, `cuda_quadrature3.contract3_route`):
at dim 2 K1 bisects a grid whose day it holds in shared memory (n <= 169);
a wider grid (up to 1024) bisects by K2 sweeps (`_bisect_by_sweeps`, the
grid path's loop, whose prefix rows and lane sums are K1's). At dim 3 the
table route sweeps U, the rebuild route rebuilds the slabs per launch. On
a CUDA device no route of dim 2 or 3 runs a plain sweep.

`bisect_tcached` is the same loop for four or more assets
(`ColumnOperands`, `ops/tcached.py`), whose every sweep is the plain
transform-cached sweep `tcached_sweep`: the JAX package serves dim >= 4
only through XLA, with no Pallas kernel, so nothing on that path launches
K1-K4.

`full_solve_levels` / `full_solve_portfolios` port
`_device_full_solve_levels_jit` / `_device_full_solve_portfolios_jit`:
stage-1 sweep over [-100, first_guess], stage-2 bracket, bisection, for
two-asset (`SweepOperands`), three-asset (`Contract3Operands`) or
dim >= 4 (`ColumnOperands`) operands. Their `*_reference` forms run the
same flow through the plain twins on any device, so the two can be
compared on the card.

Day sharding (`parallel/`): every solve and bisection takes an optional
`reducer`, a `parallel.mesh.DayMesh` whose rank holds one block of the
days; `None` (one card) leaves the path as it was. The stages and the
bracket are per day; the bisection is not, and three of its decisions
are taken over all days (the counterparts of `_spmd_bisection_levels`,
`parallel/quadrature.py:1229-1288`, and of the shard_map wrappers of K1,
`pallas_solver.py:661,823`): the host-counted halving count from the
global MAX of the widest bracket, so K1 and `bisect_fixed_count` run the
while-loop's global count on every rank; each halving's all-zeros
freeze from the global ALL of `result == 0` (JAX's `gall`), a device
tensor, so no halving reads the host; and the loop's condition from the
global ANY (JAX's `gany`). K1 has no freeze, so a sharded K1 equals the
unsharded one once the count is global.

Grid sharding (`parallel/`): the solves also take `grid`, a
`parallel.mesh.GridMesh` whose rank holds a range of the outer grid rows
(operands built with `rows=`). Every sweep is then the rank's share
(K2, K4 or the plain sweep on its rows) summed over the grid ranks by
`grid.grid_sum`, exact and in rank order, so every grid rank holds the
same (L, T) bits and takes the same bracket, halving count, freezes and
loop exits with no further collective. K1 runs every halving of a day
inside one launch and would need every rank's share in each, so the
grid path bisects as dim 3 does (`_bisect_by_sweeps`: on a CUDA device
`bisect_fixed_count` over the summed K2 or K4 sweep, on the CPU the
while-loop), as the JAX grid engine's while-loop calls its sweep every
halving. `reducer` then names the day mesh of a mesh whose day axis
shards the days too, else None.
"""

from __future__ import annotations

import functools

import torch

from copula_var_tpu_torch.ops import _build
from copula_var_tpu_torch.ops.cuda_quadrature import (
    SweepOperands,
    _check_operand,
    bisect_max_grid_points,
    check_day_operands,
    masked_sweep,
    masked_sweep_reference,
)
from copula_var_tpu_torch.ops.cuda_quadrature3 import (
    Contract3Operands,
    masked_contract3,
    masked_contract3_rebuild,
    masked_contract3_reference,
)
from copula_var_tpu_torch.ops.solvers import bracket_state_batched
from copula_var_tpu_torch.ops.tcached import ColumnOperands, tcached_sweep


def halvings(width: float, tolerance: float) -> int:
    """Iterations the while-loop bisection runs from a widest bracket of
    `width`: halve until the width is within `tolerance`."""
    k = 0
    while width > tolerance:
        width *= 0.5
        k += 1
    return k


def _halving_count(lower, upper, tolerance, reducer):
    """The while-loop's halving count, from the widest bracket on the
    host (one read): over every rank's days with a `reducer`, where an
    empty day block counts 0."""
    width = upper - lower
    if reducer is None:
        return halvings(float(width.max()), tolerance)
    local = width.max() if width.numel() else width.new_zeros(())
    return halvings(float(reducer.max(local)), tolerance)


def _running(state, tolerance, reducer=None):
    """The while-loop's condition, as a device tensor: some bracket of a
    row that has not frozen is wider than `tolerance` (on any rank's days
    with a `reducer`)."""
    lo, up, _, _, _, brk = state
    running = ((up - lo > tolerance) & ~brk[:, None]).any()
    return running if reducer is None else reducer.any(running)


def _halving(ops, state, obj, weights, tolerance, sweep, box_min,
             reducer=None):
    """One iteration of the `xla` engine's whole-array bisection over the
    (L, T) state (lo, up, prev_res, prev_up, ustack, frozen rows), one
    `sweep` per call. A row whose results are all exactly zero (on every
    rank's days with a `reducer`) freezes (the reference's early break).
    Gated on the device by the loop's own condition: once it fails, the
    call changes nothing."""
    lo, up, pr, pu, us, brk = state
    running = _running(state, tolerance, reducer)
    mid = (lo + up) / 2.0
    b_lo = torch.where(us, lo, mid)
    b_up = torch.where(us, mid, up)
    slab = sweep(ops, torch.stack((b_lo, b_up), dim=-1), weights, box_min)
    result = torch.where(b_lo == pu, pr + slab, pr - slab)
    zero = torch.all(result == 0.0, dim=1)
    if reducer is not None:
        zero = reducer.all(zero)
    zero = zero & running
    us_n = result < obj[:, None]
    frozen = (zero | brk)[:, None] | ~running
    return (torch.where(frozen | ~us_n, lo, mid),
            torch.where(frozen | us_n, up, mid),
            torch.where(frozen, pr, result),
            torch.where(frozen, pu, mid),
            torch.where(frozen, us, us_n),
            brk | zero)


def _state(lower, upper, prev_res, prev_up, ustack):
    brk = torch.zeros(lower.shape[0], dtype=torch.bool, device=lower.device)
    return (lower, upper, prev_res, prev_up, ustack, brk)


def bisect_levels_reference(ops, lower, upper, prev_res, prev_up, ustack,
                            obj, weights, tolerance, box_min=-5.0,
                            sweep=masked_sweep_reference, reducer=None):
    """Plain twin on any device: the `xla` engine's while-loop bisection
    over the (L, T) state, one `sweep` per halving (the dim-2 or dim-3
    plain sweep), with its per-row all-zeros break; with a `reducer` the
    loop's condition and the break are taken over every rank's days.
    Returns (L, T) roots."""
    state = _state(lower, upper, prev_res, prev_up, ustack)
    while bool(_running(state, tolerance, reducer)):
        state = _halving(ops, state, obj, weights, tolerance, sweep, box_min,
                         reducer)
    return (state[0] + state[1]) / 2.0


def bisect_levels(ops: SweepOperands, lower, upper, prev_res, prev_up,
                  ustack, obj, weights, tolerance, box_min=-5.0,
                  reducer=None):
    """(L, T) bisection roots. State lower/upper/prev_res/prev_up (L, T)
    float64, ustack (L, T) bool, obj (L,), weights (L, 2). CPU tensors
    run the plain twin; CUDA tensors launch the kernel for the global
    iteration count (over every rank's days with a `reducer`); any other
    device raises."""
    dev = ops.V.device
    if dev.type == "cpu":
        return bisect_levels_reference(ops, lower, upper, prev_res, prev_up,
                                       ustack, obj, weights, tolerance,
                                       box_min, reducer=reducer)
    if dev.type != "cuda":
        raise ValueError(f"bisect_levels: unsupported device {dev}")
    T, n, q = check_bisect_operands(ops)
    L = lower.shape[0]
    for name, t in (("lower", lower), ("upper", upper),
                    ("prev_res", prev_res), ("prev_up", prev_up)):
        _check_operand(name, t, (L, T), dev)
    _check_operand("ustack", ustack, (L, T), dev, torch.bool)
    _check_operand("obj", obj, (L,), dev)
    _check_operand("weights", weights, (L, 2), dev)
    n_iters = _halving_count(lower, upper, tolerance, reducer)
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


def dim2_bisect_route(n: int) -> str:
    """How a CUDA device bisects a dim-2 grid of n points: "k1" (the
    bisection kernel) when a day fits its block's shared memory, else
    "sweeps" (a halving per K2 launch); the sweep's own limit (1024)
    raises where its operands are built."""
    return "k1" if n <= bisect_max_grid_points() else "sweeps"


def bisect_by_k2_sweeps(ops: SweepOperands, lower, upper, prev_res,
                        prev_up, ustack, obj, weights, tolerance,
                        box_min=-5.0, reducer=None):
    """(L, T) dim-2 bisection roots for grids wider than K1's day: on a
    CUDA device `bisect_fixed_count` over `masked_sweep` (K2) for the
    host-counted number of halvings, on the CPU the plain while-loop;
    state and weights as `bisect_levels`."""
    return _bisect_by_sweeps(
        ops, (lower, upper, prev_res, prev_up, ustack), obj, weights,
        tolerance, box_min, masked_sweep_reference, masked_sweep,
        "bisect_by_k2_sweeps", reducer)


def check_bisect_operands(ops: SweepOperands):
    """Validate K1's operands: whole days (all n outer rows) of a grid
    whose day fits in one block's shared memory; returns (T, n, q)."""
    T, n, q = check_day_operands(ops)
    if ops.V.shape[1] != n:
        raise ValueError(
            f"bisect_levels: K1 bisects whole days; operands of outer rows "
            f"{ops.rows} are bisected by their summed sweeps (the solves' "
            "`grid`)")
    n_max = bisect_max_grid_points()
    if n > n_max:
        raise ValueError(
            f"num_points={n}: the dim-2 bisection kernel takes n <= {n_max}, "
            f"holding a day's {n}x{n} float64 in one block's shared memory "
            "(wider grids bisect by K2 sweeps, `bisect_by_k2_sweeps`)"
        )
    return T, n, q


def bisect_fixed_count(ops, lower, upper, prev_res, prev_up, ustack, obj,
                       weights, tolerance, n_iters, sweep, box_min=-5.0,
                       reducer=None):
    """`n_iters` gated halvings (`_halving`) of the (L, T) state with no
    host read. With `n_iters` at least the while-loop's count the roots
    equal `bisect_levels_reference`'s: halvings past the loop's exit
    change nothing."""
    state = _state(lower, upper, prev_res, prev_up, ustack)
    for _ in range(n_iters):
        state = _halving(ops, state, obj, weights, tolerance, sweep, box_min,
                         reducer)
    return (state[0] + state[1]) / 2.0


def _bisect_by_sweeps(ops, state, obj, weights, tolerance, box_min,
                      plain_sweep, sweep, name, reducer):
    """The bisection whose every halving is one `sweep` call: on the CPU
    the plain while-loop over `plain_sweep`; on a CUDA device
    `bisect_fixed_count` over `sweep` for the host-counted number of
    halvings; any other device raises."""
    dev = ops.x.device
    if dev.type == "cpu":
        return bisect_levels_reference(ops, *state, obj, weights, tolerance,
                                       box_min, sweep=plain_sweep,
                                       reducer=reducer)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n_iters = _halving_count(state[0], state[1], tolerance, reducer)
    return bisect_fixed_count(ops, *state, obj, weights, tolerance, n_iters,
                              sweep, box_min, reducer)


def bisect_contract3(ops: Contract3Operands, lower, upper, prev_res, prev_up,
                     ustack, obj, weights, tolerance, box_min=-5.0,
                     reducer=None):
    """(L, T) three-asset bisection roots; state as `bisect_levels`,
    weights (L, 3). CPU tensors run the plain while-loop; CUDA tensors run
    `bisect_fixed_count` with the operands' K4 sweep (`masked_contract3`
    on the table U, `masked_contract3_rebuild` without it) for the
    host-counted number of halvings; any other device raises."""
    return _bisect_by_sweeps(
        ops, (lower, upper, prev_res, prev_up, ustack), obj, weights,
        tolerance, box_min, masked_contract3_reference, _sweeps(ops)[0],
        "bisect_contract3", reducer)


def bisect_tcached(ops: ColumnOperands, lower, upper, prev_res, prev_up,
                   ustack, obj, weights, tolerance, box_min=-5.0,
                   reducer=None):
    """(L, T) bisection roots of a dim >= 4 backtest; state as
    `bisect_levels`, weights (L, dim). CPU tensors run the plain
    while-loop; CUDA tensors run `bisect_fixed_count` with `tcached_sweep`
    for the host-counted number of halvings (the freeze and the exit gated
    on the device); any other device raises."""
    return _bisect_by_sweeps(
        ops, (lower, upper, prev_res, prev_up, ustack), obj, weights,
        tolerance, box_min, tcached_sweep, tcached_sweep, "bisect_tcached",
        reducer)


def _sweeps(ops):
    """(dispatching sweep, plain sweep) for the operands' asset count; at
    dim 3 the table sweep, or the rebuild for operands without U. Dim >= 4
    has no kernel: its sweep is plain on every device."""
    if isinstance(ops, ColumnOperands):
        return tcached_sweep, tcached_sweep
    if isinstance(ops, Contract3Operands):
        kernel = (masked_contract3_rebuild if ops.U is None
                  else masked_contract3)
        return kernel, masked_contract3_reference
    return masked_sweep, masked_sweep_reference


def _grid_summed(sweep, grid):
    """`sweep` whose (L, T) share of the operands' outer rows is summed
    over the grid ranks (`grid.grid_sum`: exact, in rank order)."""
    def summed(ops, bounds, weights, box_min=-5.0):
        return grid.grid_sum(sweep(ops, bounds, weights, box_min))
    return summed


def _grid_routes(ops, plain, grid):
    """(sweep, bisect) of operands that hold a range of outer grid rows:
    each sweep summed over the grid ranks, and the bisection a loop of
    such sweeps (`_bisect_by_sweeps`; with `plain` the while-loop)."""
    kernel, twin = _sweeps(ops)
    plain_sweep = _grid_summed(twin, grid)
    sweep = plain_sweep if plain else _grid_summed(kernel, grid)

    def bisect(ops, lower, upper, prev_res, prev_up, ustack, obj, weights,
               tolerance, box_min=-5.0, reducer=None):
        state = (lower, upper, prev_res, prev_up, ustack)
        if plain:
            return bisect_levels_reference(ops, *state, obj, weights,
                                           tolerance, box_min,
                                           sweep=plain_sweep,
                                           reducer=reducer)
        return _bisect_by_sweeps(ops, state, obj, weights, tolerance,
                                 box_min, plain_sweep, sweep,
                                 "grid-sharded bisection", reducer)
    return sweep, bisect


def _routes(ops, plain):
    """(sweep, bisect) for the operands' asset count and width: the
    dispatching wrappers, or their plain twins. Dim >= 4 has no kernel:
    its sweep is plain on every device."""
    kernel, twin = _sweeps(ops)
    if plain:
        return twin, functools.partial(bisect_levels_reference, sweep=twin)
    if isinstance(ops, ColumnOperands):
        return kernel, bisect_tcached
    if isinstance(ops, Contract3Operands):
        return kernel, bisect_contract3
    if dim2_bisect_route(ops.x.shape[0]) == "sweeps":
        return kernel, bisect_by_k2_sweeps
    return kernel, bisect_levels


def sweep_for(ops):
    """The dispatching sweep wrapper for the operands' asset count."""
    return _routes(ops, plain=False)[0]


def bisect_for(ops):
    """The bisection for the operands' asset count and width (K1, K2
    sweeps, K4 sweeps or the plain dim >= 4 loop), with the signature of
    `bisect_levels`."""
    return _routes(ops, plain=False)[1]


def _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min, plain,
                reducer=None, grid=None):
    """Stage-1 sweep + stage-2 bracket + bisection for L rows. weights is
    (dim,) for one portfolio shared by every row (one stage-1 sweep
    serves them all) or (L, dim) for one portfolio per row. `plain`
    picks the plain twins over the dispatching wrappers. With a
    `reducer` the operands hold one rank's day block, and only the
    bisection's global decisions are reduced. With a `grid` they hold one
    rank's outer grid rows, and every sweep is summed over the grid
    ranks. Returns (roots (L, T), nan_days (L, T))."""
    sweep, bisect = (_routes(ops, plain) if grid is None
                     else _grid_routes(ops, plain, grid))
    T, L = ops.days, obj.shape[0]
    dev = ops.x.device
    stage1 = torch.stack(
        [torch.full((T,), -100.0, dtype=torch.float64, device=dev),
         torch.full((T,), float(cfg[0]), dtype=torch.float64, device=dev)],
        dim=-1,
    )
    dim = weights.shape[-1]
    if weights.dim() == 1:
        weights = weights.reshape(1, dim)
        F1 = sweep(ops, stage1[None], weights, box_min).expand(L, T)
        weights = weights.expand(L, dim).contiguous()
    else:
        F1 = sweep(ops, stage1.expand(L, T, 2).contiguous(), weights, box_min)
    lower, upper, prev_res, prev_up, ustack, nan_days = bracket_state_batched(
        F1, obj, lambda b: sweep(ops, b.contiguous(), weights, box_min), cfg,
        quirks,
    )
    roots = bisect(ops, lower.contiguous(), upper.contiguous(),
                   prev_res.contiguous(), prev_up.contiguous(),
                   ustack.contiguous(), obj, weights, tolerance, box_min,
                   reducer=reducer)
    return roots, nan_days


def full_solve_levels(ops, obj, weights, cfg, tolerance=1e-6, quirks=False,
                      box_min=-5.0, reducer=None, grid=None):
    """All L confidence levels `obj` (L,) of one portfolio `weights` (dim,)
    -> (roots (L, T), nan_days (L, T)), through the kernels on a CUDA
    device and the plain twins on the CPU. cfg = (first_guess, sg0, sg1,
    min_var, max_var). With a `reducer` (a `DayMesh`) `ops` holds this
    rank's day block and T is its length; with a `grid` (a `GridMesh`)
    this rank's outer grid rows."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       False, reducer, grid)


def full_solve_levels_reference(ops, obj, weights, cfg, tolerance=1e-6,
                                quirks=False, box_min=-5.0, reducer=None,
                                grid=None):
    """`full_solve_levels` through the plain twins, on any device."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       True, reducer, grid)


def full_solve_portfolios(ops, obj, weights, cfg, tolerance=1e-6,
                          quirks=False, box_min=-5.0, reducer=None,
                          grid=None):
    """L portfolio rows, row l with its own weights[l] (L, dim) and level
    obj[l] -> (roots (L, T), nan_days (L, T))."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       False, reducer, grid)


def full_solve_portfolios_reference(ops, obj, weights, cfg, tolerance=1e-6,
                                    quirks=False, box_min=-5.0,
                                    reducer=None, grid=None):
    """`full_solve_portfolios` through the plain twins, on any device."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       True, reducer, grid)
