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

The fused route (`fused_stages`: float64 dim-2 operands on a CUDA
device, n <= 169, one card, no mesh) reads no bracket on the host: one
launch of `solve_stages` (csrc/quadrature.cu::solve_stages_kernel) runs
both stage sweeps and the stage-2 bracket of every (row, day) and folds
the widest bracket into a device word, and K1 takes its halving count
from that word (`bisect_levels(..., widest=)`). The stage sweeps are K2's
slabs and the selects `bracket_state_batched`'s, so the roots are the
composed route's bit for bit; `solve.halvings` is not counted there,
since counting it would read the host. Every other route keeps the K2
stage sweeps, `bracket_state_batched` and the host-counted bisection.

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

The f32 engine (`engine="pallas"`): `full_solve_pallas` ports JAX's f32
solves on float32 operands. At dim 2 it is `pallas_solver.py::
_full_solve` (`full_solve_pallas_levels`): the stage sweeps (K2 in
float32), the bracket in float32, then K1 in float32 for exactly
`ops/solvers.full_iters` halvings per row (23 at the defaults), taken
from the config, so no bracket is read on the host; no all-zeros break;
a day whose float32 tensor holds a non-finite entry gets a NaN root.
Grids wider than K1's float32 day (192) halve by the same fixed count of
f32 K2 sweeps (`bisect_fixed`). At dim 3 it is the `xla` engine's
program over the f32 K4 sweep (`backtest.py:376`): the stage sweeps and
the bracket in float32, then the while-loop bisection (all-zeros break,
host-counted halvings as above) on float64 state, each halving's bounds
rounded to float32 for the f32 sweep (`bisect_contract3_f32`). Its
`*_reference` form runs the same flow through the f32 plain twins. The
f32 engine never launches an f64 kernel, and the f64 solves refuse f32
operands.

The f32 engine day-sharded (JAX's engine "sharded_pallas"):
`full_solve_pallas(..., reducer=)` on a rank's block of float32 operands.
At dim 2 every day is independent and the count of halvings is fixed, so
the solve runs no collective, as JAX's `_sharded_full_program` shard_maps
`_full_solve` with none; an empty block runs every stage on 0 days and
launches nothing. At dim 3 the reducer takes the bisection's three
global decisions (below), as JAX's `_dim3_pallas_full_program` does.
The JAX package's dim-2 `*_pallas_levels_sharded` functions are served
by this one function and carry no name of their own in the port.

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
    F32,
    F64,
    SweepOperands,
    _check_operand,
    bisect_max_grid_points,
    check_day_operands,
    count_launch,
    masked_sweep,
    masked_sweep_reference,
    row_pitch,
)
from copula_var_tpu_torch.ops.cuda_quadrature3 import (
    Contract3Operands,
    masked_contract3,
    masked_contract3_rebuild,
    masked_contract3_reference,
)
from copula_var_tpu_torch.ops.solvers import bracket_state_batched, full_iters
from copula_var_tpu_torch.ops.tcached import ColumnOperands, tcached_sweep
from copula_var_tpu_torch.utils.profiling import count, span


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
    with span("sync.halving_count"):
        if reducer is None:
            widest = float(width.max())
        else:
            local = width.max() if width.numel() else width.new_zeros(())
            widest = float(reducer.max(local))
    return halvings(widest, tolerance)


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
    while True:
        with span("sync.bisect_exit"):
            running = bool(_running(state, tolerance, reducer))
        if not running:
            break
        state = _halving(ops, state, obj, weights, tolerance, sweep, box_min,
                         reducer)
        count("solve.halvings")
    return (state[0] + state[1]) / 2.0


def bisect_levels(ops: SweepOperands, lower, upper, prev_res, prev_up,
                  ustack, obj, weights, tolerance, box_min=-5.0,
                  reducer=None, widest=None):
    """(L, T) bisection roots. State lower/upper/prev_res/prev_up (L, T)
    float64, ustack (L, T) bool, obj (L,), weights (L, 2). CPU tensors
    run the plain twin; CUDA tensors launch the kernel for the global
    iteration count (over every rank's days with a `reducer`), read on
    the host, or, given `widest` (`solve_stages`'s (1,) widest bracket,
    on one card), taken by the kernel from it on the device; any other
    device raises."""
    dev = ops.V.device
    _require_dtype(ops, F64, "bisect_levels")
    if widest is not None and reducer is not None:
        raise ValueError("bisect_levels: a device-side count (`widest`) is "
                         "one card's; a day mesh's count is a global MAX")
    if dev.type == "cpu":
        return bisect_levels_reference(ops, lower, upper, prev_res, prev_up,
                                       ustack, obj, weights, tolerance,
                                       box_min, reducer=reducer)
    if dev.type != "cuda":
        raise ValueError(f"bisect_levels: unsupported device {dev}")
    state = (lower, upper, prev_res, prev_up, ustack)
    if widest is not None:
        return _launch_k1(ops, state, obj, weights, box_min,
                          widest=(widest, tolerance))
    n_iters = _halving_count(lower, upper, tolerance, reducer)
    return _launch_k1(ops, state, obj, weights, box_min, n_iters)


def _launch_k1(ops, state, obj, weights, box_min, n_iters=None,
               widest=None):
    """K1 of the operands' type on their CUDA device, counted on
    `bisect_levels`: `n_iters` halvings of the (L, T) state (lower, upper,
    prev_res, prev_up, ustack), or, with `widest` = (the (1,) float64
    widest bracket, tolerance), the count the kernel takes from them (f64
    only; not counted in `solve.halvings`, which would need a host read)."""
    dev, dt = ops.V.device, ops.dtype
    with span("launch.bisect_levels"):
        T, n, q = check_bisect_operands(ops)
        lower, upper, prev_res, prev_up, ustack = state
        L = lower.shape[0]
        for name, t in (("lower", lower), ("upper", upper),
                        ("prev_res", prev_res), ("prev_up", prev_up)):
            _check_operand(name, t, (L, T), dev, dt)
        _check_operand("ustack", ustack, (L, T), dev, torch.bool)
        _check_operand("obj", obj, (L,), dev, dt)
        _check_operand("weights", weights, (L, 2), dev, dt)
        if widest is not None:
            _check_operand("widest", widest[0], (1,), dev, F64)
        roots = torch.empty((L, T), dtype=dt, device=dev)
        if roots.numel() == 0:  # an empty day block: no launch
            return roots
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            head = (ops.V.data_ptr(), ops.wfc.data_ptr(), ops.w1.data_ptr(),
                    ops.x.data_ptr(), lower.data_ptr(), upper.data_ptr(),
                    prev_res.data_ptr(), prev_up.data_ptr(),
                    ustack.data_ptr(), obj.data_ptr(), weights.data_ptr(),
                    float(box_min))
            tail = (roots.data_ptr(), T, n, q, L, stream)
            if widest is None:
                status = _build.function("cvt_bisect_levels", dt)(
                    *head, n_iters, *tail)
            else:
                status = _build.function("cvt_bisect_levels_widest", dt)(
                    *head, widest[0].data_ptr(), float(widest[1]), *tail)
        _build.check(status, "bisect_levels")
    count_launch(bisect_levels, dt)
    if widest is None:
        count("solve.halvings", n_iters)
    return roots


def fused_stages(device, dtype, dim, n, reducer=None, grid=None) -> bool:
    """Whether a solve takes the fused route: its stage sweeps and
    bracket as one `solve_stages` launch, then K1 counting its halvings
    on the device. Float64 operands of two assets on a CUDA device whose
    grid K1 bisects (n <= 169), on one card: no day mesh (`reducer`,
    whose count is a global MAX) and no grid mesh (`grid`, summed
    sweeps). Every other solve (the f32 engine, meshes, n > 169, dim >= 3,
    the CPU) keeps the stage sweeps, `bracket_state_batched` and the
    host-counted bisection."""
    return (torch.device(device).type == "cuda" and dtype == F64
            and dim == 2 and dim2_bisect_route(n) == "k1"
            and reducer is None and grid is None)


def _widest(lower, upper):
    """(1,) float64: the widest bracket, max(upper - lower) and at least
    0 (NaN if a width is NaN), as `solve_stages` folds it."""
    if lower.numel() == 0:
        return lower.new_zeros((1,))
    return (upper - lower).max().clamp_min(0.0).reshape(1)


def solve_stages_reference(ops: SweepOperands, obj, weights, cfg,
                           quirks=False, box_min=-5.0):
    """Plain twin of `solve_stages`, on any device: the plain stage-1
    sweep, `bracket_state_batched` over the plain sweep and the widest
    bracket; weights (L, 2). Returns (lower, upper, prev_res, prev_up,
    ustack, nan_days, widest)."""
    state, _ = _stages(ops, obj, weights, cfg, quirks, box_min,
                       masked_sweep_reference, F64)
    return tuple(state) + (_widest(state[0], state[1]),)


def solve_stages(ops: SweepOperands, obj, weights, cfg, quirks=False,
                 box_min=-5.0):
    """The stage-1 sweep over [-100, first_guess], the stage-2 bracket
    and the widest bracket of L rows (levels `obj` (L,), weights (L, 2))
    of float64 day operands -> (lower, upper, prev_res, prev_up (L, T),
    ustack, nan_days (L, T) bool, widest (1,) float64). CPU tensors run
    the plain twin; CUDA tensors launch the kernel (K2's slabs and
    `bracket_state_batched`'s selects, the same bits) on whole days of a
    grid K1 bisects; any other device raises. cfg = (first_guess, sg0,
    sg1, min_var, max_var)."""
    dev = ops.V.device
    _require_dtype(ops, F64, "solve_stages")
    if dev.type == "cpu":
        return solve_stages_reference(ops, obj, weights, cfg, quirks,
                                      box_min)
    if dev.type != "cuda":
        raise ValueError(f"solve_stages: unsupported device {dev}")
    with span("launch.solve_stages"):
        T, n, _ = check_bisect_operands(ops)
        if ops.P is None or ops.flags is None:
            raise ValueError("solve_stages: the operands carry no prefix "
                             "table P (build them with sweep_operands)")
        _check_operand("P", ops.P, (T, n, row_pitch(n)), dev, F64)
        _check_operand("flags", ops.flags, (T, n), dev, torch.bool)
        L = obj.shape[0]
        _check_operand("obj", obj, (L,), dev, F64)
        _check_operand("weights", weights, (L, 2), dev, F64)
        # one allocation for the four float64 states and the widest word,
        # one for the two flags
        f = torch.empty(4 * L * T + 1, dtype=F64, device=dev)
        b = torch.empty((2, L, T), dtype=torch.bool, device=dev)
        out = tuple(f[:-1].view(4, L, T)) + tuple(b) + (f[-1:],)
        if L * T == 0:  # an empty day block: no launch
            f[-1:] = 0.0
            return out
        fn = _build.function("cvt_solve_stages", F64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.P.data_ptr(), ops.flags.data_ptr(), ops.x.data_ptr(),
                obj.data_ptr(), weights.data_ptr(),
                *(float(c) for c in cfg), int(bool(quirks)), float(box_min),
                *(t.data_ptr() for t in out), T, n, L, row_pitch(n), stream,
            )
        _build.check(status, "solve_stages")
    count_launch(solve_stages, F64)
    return out


def _require_dtype(ops, dtype, what):
    """Raise unless the operands hold `dtype`: the f64 engine's solves
    take float64 operands, the f32 engine's float32 ones."""
    if ops.x.dtype != dtype:
        engine = "f32 engine (full_solve_pallas)" if dtype == F32 else \
            "f64 engine (full_solve_levels / full_solve_portfolios)"
        raise ValueError(f"{what}: the {engine} takes {dtype} operands, not "
                         f"{ops.x.dtype}")


def dim2_bisect_route(n: int, dtype=F64) -> str:
    """How a CUDA device bisects a dim-2 grid of n points of `dtype`: "k1"
    (the bisection kernel) when a day fits its block's shared memory (n
    <= 169 in float64, 192 in float32), else "sweeps" (a halving per K2
    launch); the sweep's own limit (1024) raises where its operands are
    built."""
    return "k1" if n <= bisect_max_grid_points(dtype) else "sweeps"


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
    n_max = bisect_max_grid_points(ops.dtype)
    if n > n_max:
        raise ValueError(
            f"num_points={n}: the dim-2 bisection kernel takes n <= {n_max}, "
            f"holding a day's {n}x{n} {ops.dtype} in one block's shared "
            "memory (wider grids bisect by K2 sweeps, `bisect_by_k2_sweeps`"
            " and `bisect_fixed`)"
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
    count("solve.halvings", n_iters)
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


def fixed_halvings(ops, lower, upper, prev_res, prev_up, ustack, obj,
                   weights, n_iters, sweep, box_min=-5.0):
    """The f32 engine's dim-2 bisection as plain PyTorch over `sweep`:
    exactly `n_iters` halvings of the (L, T) state, with no all-zeros break
    and no host read (`pallas_solver.py::_solve_kernel`'s loop: K1's plain
    twin in float32, with `masked_sweep_reference`)."""
    lo, up, pr, pu, us = lower, upper, prev_res, prev_up, ustack
    for _ in range(n_iters):
        mid = (lo + up) / 2.0
        b_lo = torch.where(us, lo, mid)
        b_up = torch.where(us, mid, up)
        slab = sweep(ops, torch.stack((b_lo, b_up), dim=-1), weights, box_min)
        pr = torch.where(b_lo == pu, pr + slab, pr - slab)
        us = pr < obj[:, None]
        lo, up, pu = torch.where(us, mid, lo), torch.where(us, up, mid), mid
    count("solve.halvings", n_iters)
    return (lo + up) / 2.0


def bisect_fixed(ops: SweepOperands, lower, upper, prev_res, prev_up,
                 ustack, obj, weights, n_iters, box_min=-5.0):
    """(L, T) roots of the f32 engine's dim-2 bisection: `n_iters`
    halvings of the float32 state (lower, upper, prev_res, prev_up (L, T),
    ustack (L, T) bool; obj (L,), weights (L, 2)). CPU tensors run
    `fixed_halvings` over the plain sweep; CUDA tensors launch K1 in
    float32 where a day fits its shared memory (n <= 192), else run
    `fixed_halvings` over the f32 K2 sweep (the same slab bits); any
    other device raises."""
    dev = ops.V.device
    _require_dtype(ops, F32, "bisect_fixed")
    state = (lower, upper, prev_res, prev_up, ustack)
    if dev.type == "cpu":
        return fixed_halvings(ops, *state, obj, weights, n_iters,
                              masked_sweep_reference, box_min)
    if dev.type != "cuda":
        raise ValueError(f"bisect_fixed: unsupported device {dev}")
    if dim2_bisect_route(ops.x.shape[0], F32) == "sweeps":
        return fixed_halvings(ops, *state, obj, weights, n_iters,
                              masked_sweep, box_min)
    return _launch_k1(ops, tuple(t.contiguous() for t in state), obj,
                      weights, box_min, n_iters)


def _day_nan(ops: SweepOperands):
    """(T,) days whose float32 tensor holds a non-finite entry (JAX
    `_full_solve`'s NaN days)."""
    return ~torch.isfinite(ops.V).flatten(1).all(dim=1)


def bisect_contract3_f32(ops: Contract3Operands, lower, upper, prev_res,
                         prev_up, ustack, obj, weights, tolerance,
                         box_min=-5.0, reducer=None, sweep=None):
    """(L, T) float64 roots of the f32 engine's dim-3 bisection: the `xla`
    while-loop (`_bisect_by_sweeps`) on float64 state (lower, upper,
    prev_res, prev_up (L, T) of any floating type, ustack (L, T) bool;
    obj (L,), weights (L, 3)), each halving's bounds rounded to float32
    for the float32 sweep (the operands' kernel sweep, or `sweep`) and
    its result widened to float64; with a `reducer` the halving count,
    the all-zeros freeze and the loop's exit are taken over every rank's
    days (JAX's `_spmd_bisection_levels` over the f32 K4 sweep)."""
    _require_dtype(ops, F32, "bisect_contract3_f32")
    sweep = _sweeps(ops)[0] if sweep is None else sweep
    w = weights.to(F32).contiguous()

    def sweep64(ops, bounds, weights, box_min=-5.0):
        return sweep(ops, bounds.to(F32).contiguous(), w, box_min).to(F64)

    state = tuple(t.to(F64).contiguous()
                  for t in (lower, upper, prev_res, prev_up))
    return _bisect_by_sweeps(
        ops, state + (ustack.contiguous(),), obj.to(F64), w.to(F64),
        tolerance, box_min, sweep64, sweep64, "bisect_contract3_f32",
        reducer)


def _pallas_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                  plain, reducer=None):
    """JAX's f32 engine on float32 operands (see the module docstring):
    dim 2 `_full_solve` (fixed-count K1), dim 3 the `xla` program over
    the f32 K4 sweep. weights (dim,) or (L, dim), as `_full_solve`. With
    a `reducer` the operands hold one rank's day block: dim 2 needs no
    collective, dim 3 reduces the bisection's global decisions. Returns
    (roots (L, T): float32 at dim 2, float64 at dim 3, nan_days (L, T))."""
    _require_dtype(ops, F32, "full_solve_pallas")
    kernel, twin = _sweeps(ops)
    sweep = twin if plain else kernel
    (lower, upper, prev_res, prev_up, ustack, nan_days), w = _stages(
        ops, obj.to(F32), weights.to(F32), cfg, quirks, box_min, sweep, F32)
    with span("solve.bisect"):
        if isinstance(ops, Contract3Operands):
            roots = bisect_contract3_f32(ops, lower, upper, prev_res,
                                         prev_up, ustack, obj, w, tolerance,
                                         box_min, reducer, sweep)
            return roots, nan_days
        n_iters = full_iters(tolerance, cfg[3], cfg[4])
        state = (lower, upper, prev_res, prev_up, ustack)
        if plain:
            roots = fixed_halvings(ops, *state, obj.to(F32), w, n_iters,
                                   twin, box_min)
        else:
            roots = bisect_fixed(ops, *state, obj.to(F32), w, n_iters,
                                 box_min)
    return roots, nan_days | _day_nan(ops)[None]


def full_solve_pallas(ops, obj, weights, cfg, tolerance=1e-6, quirks=False,
                      box_min=-5.0, reducer=None):
    """The f32 engine (`engine="pallas"`) on float32 `sweep_operands` /
    `contract3_operands`: L rows of levels `obj` (L,) with one portfolio
    `weights` (dim,) or one per row (L, dim) -> (roots (L, T), nan_days
    (L, T)), through the f32 kernels on a CUDA device and the f32 plain
    twins on the CPU. cfg = (first_guess, sg0, sg1, min_var, max_var).
    With a `reducer` (a `DayMesh`) `ops` holds this rank's day block and
    T is its length (JAX's engine "sharded_pallas")."""
    return _pallas_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                         False, reducer)


def full_solve_pallas_reference(ops, obj, weights, cfg, tolerance=1e-6,
                                quirks=False, box_min=-5.0, reducer=None):
    """`full_solve_pallas` through the f32 plain twins, on any device."""
    return _pallas_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                         True, reducer)


def _stages(ops, obj, weights, cfg, quirks, box_min, sweep, dt):
    """The stage-1 sweep over [-100, first_guess] (bounds of type `dt`)
    and the stage-2 bracket of L rows: levels `obj` (L,), `weights` (dim,)
    for one portfolio shared by every row (one stage-1 sweep serves them
    all) or (L, dim) for one per row. Returns (the bracket state (lower,
    upper, prev_res, prev_up, ustack, nan_days), the (L, dim) weight
    rows)."""
    T, L = ops.days, obj.shape[0]
    dev = ops.x.device
    with span("solve.stage1"):
        stage1 = torch.stack(
            [torch.full((T,), -100.0, dtype=dt, device=dev),
             torch.full((T,), float(cfg[0]), dtype=dt, device=dev)], dim=-1,
        )
        dim = weights.shape[-1]
        if weights.dim() == 1:
            weights = weights.reshape(1, dim)
            F1 = sweep(ops, stage1[None], weights, box_min).expand(L, T)
            weights = weights.expand(L, dim).contiguous()
        else:
            F1 = sweep(ops, stage1.expand(L, T, 2).contiguous(), weights,
                       box_min)
    with span("solve.bracket"):
        state = bracket_state_batched(
            F1, obj, lambda b: sweep(ops, b.contiguous(), weights, box_min),
            cfg, quirks,
        )
    return state, weights


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
    _require_dtype(ops, F64, "full_solve_levels")
    sweep, bisect = (_routes(ops, plain) if grid is None
                     else _grid_routes(ops, plain, grid))
    kw = {}
    if not plain and fused_stages(ops.x.device, ops.x.dtype,
                                  weights.shape[-1], ops.x.shape[0],
                                  reducer, grid):
        L = obj.shape[0]
        if weights.dim() == 1:
            weights = weights.reshape(1, -1).expand(L, -1)
        weights = weights.contiguous()
        with span("solve.bracket"):
            *state, nan_days, kw["widest"] = solve_stages(
                ops, obj, weights, cfg, quirks, box_min)
    else:
        (*state, nan_days), weights = _stages(
            ops, obj, weights, cfg, quirks, box_min, sweep, F64)
    with span("solve.bisect"):
        roots = bisect(ops, *(t.contiguous() for t in state), obj, weights,
                       tolerance, box_min, reducer=reducer, **kw)
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
