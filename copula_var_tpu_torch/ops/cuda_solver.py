"""The solve's route, its bisections and the full three-stage solve
(counterpart of `copula_var_tpu/ops/pallas_solver.py` and of the `xla`
engine's device programs in `copula_var_tpu/backtest.py`).

`full_solve` runs the stage-1 sweep over [-100, first_guess], the stage-2
bracket and the bisection of L rows (levels of one shared portfolio, or
one portfolio per row) of two-asset (`SweepOperands`), three-asset
(`Contract3Operands`) or dim >= 4 (`ColumnOperands`) operands: float64
ones on the f64 engine (the `xla` engine's `_device_full_solve_levels_jit`
/ `_device_full_solve_portfolios_jit`), float32 ones on the f32 engine
(`engine="pallas"`). `full_solve_reference` runs the same flow through
the plain twins on any device, so the two can be compared on the card.

How a solve runs is decided in one place, `route`: a pure function of
what the code observes (the operands' device, type, asset count and
width n, whether they hold the dim-3 table U, `plain`, and whether a day
mesh or a grid mesh is given). Its rows, on a CUDA device:

  operands             mesh          stages    bisection (count)
  f64, dim 2, n <= 169 none          fused     K1 (device)
  f64, dim 2, n <= 169 day           composed  K1 (host, a global MAX)
  f64, dim 2, n > 169  none or day   composed  halvings of K2 (host)
  f64, dim 3, table U  none          fused     K4 on the device (device)
  f64, dim 3, table U  day           composed  halvings of K4 (host)
  f64, dim 3, no table none or day   composed  halvings of the rebuild
                                               (host)
  f64, dim >= 4        none or day   composed  halvings of `tcached_sweep`
                                               (host)
  f64, any dim         grid          composed  halvings of the summed
                                               sweep (host)
  f32, dim 2, n <= 192 none or day   composed  K1 f32 (fixed)
  f32, dim 2, n > 192  none or day   composed  fixed halvings of K2 f32
                                               (fixed)
  f32, dim 3           none or day   composed  halvings of K4 f32 on
                                               float64 state (host)

On the CPU, or with `plain`, every solve is composed over the plain twin
and bisects by the while-loop, but for the f32 engine's dim 2, which
runs fixed halvings. Without `plain` no route of dim 2 or 3 on a CUDA
device runs a plain sweep; dim >= 4 has no kernel (the JAX package
serves it only through XLA), so its sweep is plain on every device and
K1-K4 never launch.

Stages. "fused": one launch runs both stage sweeps and the stage-2
bracket of every (row, day) and folds the widest bracket into a device
word: `solve_stages` at dim 2 (csrc/quadrature.cu::solve_stages_kernel,
K2's slabs), `solve_stages3` at dim 3 (csrc/contract3.cu::
solve_stages3_kernel, K4's sweep body); the selects are
`bracket_state_batched`'s, so the roots are the composed route's bit for
bit. "composed": the stage-1 sweep and `ops/solvers.py::
bracket_state_batched` over the route's sweep.

Bisections (`_bisect`) and their counts:
- K1 (`bisect_levels`, csrc/quadrature.cu::bisect_levels_kernel, which
  replaces the Pallas `_solve_kernel`): one warp per bound row, every
  halving a prefix-interval sum per grid row, a day in shared memory
  (`bisect_max_grid_points`). It runs the while-loop's global count of
  halvings, read on the host (one `.item()` of the widest bracket) or,
  on the fused route, taken by the kernel from `solve_stages`'s word
  (`bisect_levels(..., widest=)`; `solve.halvings` is not counted there,
  since counting it would read the host). K1 has no all-zeros break
  (see the kernel source).
- K4 on the device (`bisect3`, csrc/contract3.cu::bisect3_kernel): one
  launcher call enqueues `max_halvings` of the config (23 at the
  defaults) launches and a last one for the roots, with no host read.
  Each launch takes its count from `solve_stages3`'s word, as K1 does,
  and one past it exits at once. The freeze and the loop's exit need
  every day's results, so launch k takes halving k - 1's decisions from
  integer words of rows before it halves (a candidate state beside the
  state): the roots are `bisect_fixed_count`'s bit for bit
  (`bisect3_reference` is the twin of that structure). `solve.halvings`
  is not counted there, as on K1's device count.
- halvings (`bisect_fixed_count`): the host-counted number of halvings,
  one sweep each, the all-zeros freeze and the while-loop's own exit
  gated on the device, so no halving reads the host and the roots equal
  the while-loop's. The JAX package's while-loop calls its sweep every
  halving too: it has no fused dim-3 bisection.
- the while-loop (`bisect_levels_reference`): the `xla` engine's loop
  with its per-level all-zeros break (`backtest.py:445-480`), its exit
  read on the host every halving.
- fixed halvings (`fixed_halvings`): K1 f32's loop in plain PyTorch.
A "fixed" count is `ops/solvers.full_iters` of the config (23 at the
defaults), no bracket read on the host. The fused rows are f64 on one
card: a day mesh's count and decisions are collectives over every rank's
days, a grid mesh sums each sweep over its ranks, and the f32 engine's
dim 3 bisects on float64 state, so those keep the composed route.

The f32 engine (JAX's f32 Pallas engine) never launches an f64 kernel.
Its dim 2 is `pallas_solver.py::_full_solve`: stage sweeps and bracket
in float32, then the fixed count of halvings in float32 with no
all-zeros break; a day whose float32 tensor holds a non-finite entry
gets a NaN root. Its dim 3 is the `xla` engine's program over the f32 K4
sweep (`backtest.py:376`): stage sweeps and bracket in float32, then the
halvings on float64 state, each halving's bounds rounded to float32 for
the f32 sweep and its result widened to float64.

Day sharding (`parallel/`): `reducer`, a `parallel.mesh.DayMesh` whose
rank holds one block of the days; None (one card) leaves the path as it
was. The stages and the bracket are per day; the bisection is not, and
three of its decisions are taken over all days (the counterparts of
`_spmd_bisection_levels`, `parallel/quadrature.py:1229-1288`, and of the
shard_map wrappers of K1, `pallas_solver.py:661,823`): the host count
from the global MAX of the widest bracket; each halving's all-zeros
freeze from the global ALL of `result == 0` (JAX's `gall`), a device
tensor, so no halving reads the host; and the loop's condition from the
global ANY (JAX's `gany`). K1 has no freeze, so a sharded K1 equals the
unsharded one once the count is global. The f32 engine's fixed count
needs no collective, as JAX's `_sharded_full_program` shard_maps
`_full_solve` with none; an empty block runs every stage on 0 days and
launches nothing. The JAX package's dim-2 `*_pallas_levels_sharded`
functions are `full_solve(..., reducer=)` on a rank's block and carry no
name of their own in the port.

Grid sharding (`parallel/`): `grid`, a `parallel.mesh.GridMesh` whose
rank holds a range of the outer grid rows (operands built with `rows=`).
Every sweep is the rank's share summed over the grid ranks by
`grid.grid_sum`, exact and in rank order, so every grid rank holds the
same (L, T) bits and takes the same bracket, count, freezes and exits
with no further collective. K1 would need every rank's share in each of
its halvings, so the grid route halves by summed sweeps, as the JAX grid
engine's while-loop calls its sweep every halving. `reducer` then names
the day mesh of a mesh whose day axis shards the days too, else None.

`_routes(ops, plain)` binds the operands' route on one card (its sweep
and its bisection) and `_full_solve` runs it: the benchmark's fault
harness (`varbench/harness/faults.py`) replaces both by these names and
call shapes.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

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
    check_table,
    masked_contract3_reference,
    slab_stride,
)
from copula_var_tpu_torch.ops.solvers import bracket_state_batched, full_iters
from copula_var_tpu_torch.ops.tcached import tcached_sweep
from copula_var_tpu_torch.utils.profiling import count, span


def halvings(width: float, tolerance: float) -> int:
    """Iterations the while-loop bisection runs from a widest bracket of
    `width`: halve until the width is within `tolerance`."""
    k = 0
    while width > tolerance:
        width *= 0.5
        k += 1
    return k


def max_halvings(cfg, tolerance: float) -> int:
    """The most halvings a solve of cfg = (first_guess, sg0, sg1,
    min_var, max_var) can run: `halvings` of the widest of the five
    brackets `bracket_state_batched`'s selects form, (min_var, max_var),
    (min_var, sg0), (sg0, first_guess), (sg1, max_var) and (first_guess,
    sg1); 23 at the defaults. The device bisection's launches (`bisect3`),
    set on the host with no bracket read."""
    fg, sg0, sg1, lo, hi = (float(c) for c in cfg)
    return max(halvings(b - a, tolerance) for a, b in (
        (lo, hi), (lo, sg0), (sg0, fg), (sg1, hi), (fg, sg1)))


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


def _widest(lower, upper):
    """(1,) float64: the widest bracket, max(upper - lower) and at least
    0 (NaN if a width is NaN), as `solve_stages` folds it."""
    if lower.numel() == 0:
        return lower.new_zeros((1,))
    return (upper - lower).max().clamp_min(0.0).reshape(1)


def solve_stages_reference(ops, obj, weights, cfg, quirks=False,
                           box_min=-5.0):
    """Plain twin of `solve_stages` (dim-2 operands, weights (L, 2)) and
    of `solve_stages3` (dim-3, (L, 3)), on any device: the plain stage-1
    sweep, `bracket_state_batched` over the plain sweep and the widest
    bracket. Returns (lower, upper, prev_res, prev_up, ustack, nan_days,
    widest)."""
    sweep = (masked_contract3_reference
             if isinstance(ops, Contract3Operands) else masked_sweep_reference)
    state, _ = _stages(ops, obj, weights, cfg, quirks, box_min, sweep, F64)
    return tuple(state) + (_widest(state[0], state[1]),)


def _stage_outputs(L, T, dev):
    """The fused stages' outputs (lower, upper, prev_res, prev_up (L, T)
    float64, ustack, nan_days (L, T) bool, widest (1,) float64) in one
    float64 and one bool allocation; widest is 0 when there is no (row,
    day), as the launchers leave it for the kernels to fold into."""
    f = torch.empty(4 * L * T + 1, dtype=F64, device=dev)
    b = torch.empty((2, L, T), dtype=torch.bool, device=dev)
    if L * T == 0:
        f[-1:] = 0.0
    return tuple(f[:-1].view(4, L, T)) + tuple(b) + (f[-1:],)


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
        out = _stage_outputs(L, T, dev)
        if L * T == 0:  # an empty day block: no launch
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


def _check_table_solve(ops: Contract3Operands, obj, weights, what):
    """Validate the fused dim-3 solve's operands: the table U and its row
    flags of whole days (every outer slab) and L rows of levels `obj` (L,)
    and weights (L, 3), float64 on one CUDA device; returns (T, n, L)."""
    if ops.row0 != 0 or ops.n_rows != ops.x.shape[0]:
        raise ValueError(
            f"{what}: the fused dim-3 solve takes whole days; operands of "
            f"outer slabs {ops.rows} are solved by their summed sweeps (the "
            "solves' `grid`)")
    T, n, _ = check_table(ops, what)
    L, dev = obj.shape[0], ops.x.device
    _check_operand("obj", obj, (L,), dev, F64)
    _check_operand("weights", weights, (L, 3), dev, F64)
    return T, n, L


def solve_stages3(ops: Contract3Operands, obj, weights, cfg, quirks=False,
                  box_min=-5.0):
    """`solve_stages` of float64 dim-3 operands holding the table U: the
    stage-1 sweep over [-100, first_guess], the stage-2 bracket and the
    widest bracket of L rows (levels `obj` (L,), weights (L, 3)) ->
    (lower, upper, prev_res, prev_up (L, T), ustack, nan_days (L, T) bool,
    widest (1,) float64). CPU tensors run the plain twin; CUDA tensors
    launch the kernel (one block per day, K4's sweep body for both sweeps,
    `bracket_state_batched`'s selects: the same bits) on whole days of one
    card; any other device raises. cfg = (first_guess, sg0, sg1, min_var,
    max_var)."""
    dev = ops.x.device
    _require_dtype(ops, F64, "solve_stages3")
    if dev.type == "cpu":
        return solve_stages_reference(ops, obj, weights, cfg, quirks,
                                      box_min)
    if dev.type != "cuda":
        raise ValueError(f"solve_stages3: unsupported device {dev}")
    with span("launch.solve_stages3"):
        T, n, L = _check_table_solve(ops, obj, weights, "solve_stages3")
        out = _stage_outputs(L, T, dev)
        if L * T == 0:  # an empty day block: no launch
            return out
        fn = _build.function("cvt_solve_stages3", F64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.U.data_ptr(), ops.flags.data_ptr(), ops.x.data_ptr(),
                obj.data_ptr(), weights.data_ptr(),
                *(float(c) for c in cfg), int(bool(quirks)), float(box_min),
                *(t.data_ptr() for t in out), T, n, L, row_pitch(n),
                slab_stride(n), stream,
            )
        _build.check(status, "solve_stages3")
    count_launch(solve_stages3, F64)
    return out


def bisect3_words(n_iters: int, L: int) -> int:
    """The int32 words of the device bisection of L rows over at most
    `n_iters` halvings (csrc/contract3.cu `BisectWords::count`): per
    halving and row, "some result is not 0" and "some candidate bracket
    is still wide"; per launch and row the freeze, and per launch the
    loop's condition."""
    return (3 * n_iters + 1) * L + n_iters + 1


def bisect3_reference(ops, lower, upper, prev_res, prev_up, ustack, obj,
                      weights, tolerance, box_min=-5.0, *, widest, n_iters,
                      sweep=masked_contract3_reference):
    """Plain twin of `bisect3`, on any device, launch by launch. K =
    min(`halvings` of `widest`, n_iters). Launch k (k = 0 .. K) first takes
    halving k - 1's decisions from its row words, "some result is not 0"
    and "some candidate bracket is wider than `tolerance`": a row whose
    results were all exactly 0 while the loop ran freezes, the loop runs
    on while a row not frozen holds a wide candidate, and each state takes
    the candidate where its row moved. Launch K returns the roots; every
    other launch, while the loop runs, halves into a new candidate and its
    row words. The roots are `bisect_fixed_count`'s for K halvings, bit
    for bit."""
    K = min(halvings(float(widest.reshape(())), tolerance), n_iters)
    state = (lower, upper, prev_res, prev_up, ustack)
    brk = torch.zeros(lower.shape[0], dtype=torch.bool, device=lower.device)
    running = True
    cand = nonzero = wide = None
    for k in range(K + 1):
        if k > 0:  # halving k - 1's decisions
            zero = ~nonzero & running
            kept = (zero | brk)[:, None] | (not running)
            state = tuple(torch.where(kept, s, c)
                          for s, c in zip(state, cand))
            brk = brk | zero
            running = running and bool((wide & ~brk).any())
        if k == K or not running:
            continue
        lo, up, pr, pu, us = state
        mid = (lo + up) / 2.0
        b_lo = torch.where(us, lo, mid)
        slab = sweep(ops, torch.stack((b_lo, torch.where(us, mid, up)),
                                      dim=-1), weights, box_min)
        result = torch.where(b_lo == pu, pr + slab, pr - slab)
        below = result < obj[:, None]
        cand = (torch.where(below, mid, lo), torch.where(below, up, mid),
                result, mid, below)
        nonzero = (result != 0.0).any(dim=1)
        wide = (cand[1] - cand[0] > tolerance).any(dim=1)
        count("solve.halvings")
    return (state[0] + state[1]) / 2.0


def bisect3(ops: Contract3Operands, lower, upper, prev_res, prev_up, ustack,
            obj, weights, tolerance, box_min=-5.0, *, widest, n_iters):
    """(L, T) roots of the dim-3 bisection with its count on the device:
    the state lower/upper/prev_res/prev_up (L, T) float64, ustack (L, T)
    bool, obj (L,), weights (L, 3) of float64 operands holding the table
    U; `widest` (`solve_stages3`'s (1,) widest bracket) gives the count,
    `n_iters` (`max_halvings` of the config) caps it. CPU tensors run the
    plain twin; CUDA tensors enqueue n_iters + 1 launches from one
    launcher call (K4's sweep body in each, the freeze and the loop's
    exit gated on the device), with no host read, on whole days of one
    card; any other device raises."""
    dev = ops.x.device
    _require_dtype(ops, F64, "bisect3")
    if dev.type == "cpu":
        return bisect3_reference(ops, lower, upper, prev_res, prev_up,
                                 ustack, obj, weights, tolerance, box_min,
                                 widest=widest, n_iters=n_iters)
    if dev.type != "cuda":
        raise ValueError(f"bisect3: unsupported device {dev}")
    with span("launch.bisect3"):
        T, n, L = _check_table_solve(ops, obj, weights, "bisect3")
        for name, t in (("lower", lower), ("upper", upper),
                        ("prev_res", prev_res), ("prev_up", prev_up)):
            _check_operand(name, t, (L, T), dev, F64)
        _check_operand("ustack", ustack, (L, T), dev, torch.bool)
        _check_operand("widest", widest, (1,), dev, F64)
        # the state and its candidate (8 planes), then the roots
        f = torch.empty(9 * L * T, dtype=F64, device=dev)
        u = torch.empty(2 * L * T, dtype=torch.bool, device=dev)
        words = torch.empty(bisect3_words(n_iters, L), dtype=torch.int32,
                            device=dev)
        roots = f[8 * L * T:].view(L, T)
        if L * T == 0:  # an empty day block: no launch
            return roots
        fn = _build.function("cvt_bisect3", F64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(
                ops.U.data_ptr(), ops.flags.data_ptr(), ops.x.data_ptr(),
                lower.data_ptr(), upper.data_ptr(), prev_res.data_ptr(),
                prev_up.data_ptr(), ustack.data_ptr(), obj.data_ptr(),
                weights.data_ptr(), float(box_min), widest.data_ptr(),
                float(tolerance), int(n_iters), f.data_ptr(), u.data_ptr(),
                words.data_ptr(), roots.data_ptr(), T, n, L, row_pitch(n),
                slab_stride(n), stream,
            )
        _build.check(status, "bisect3")
    count_launch(bisect3, F64)
    return roots


def _require_dtype(ops, dtype, what):
    """Raise unless the operands hold `dtype`: the f64 engine's wrappers
    take float64 operands."""
    if ops.x.dtype != dtype:
        raise ValueError(f"{what}: the f64 engine takes {dtype} operands, "
                         f"not {ops.x.dtype}")


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
            "memory (wider grids bisect by K2 sweeps: `route`)"
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


def _day_nan(ops: SweepOperands):
    """(T,) days whose float32 tensor holds a non-finite entry (JAX
    `_full_solve`'s NaN days)."""
    return ~torch.isfinite(ops.V).flatten(1).all(dim=1)


class Route(NamedTuple):
    """A solve's route (`route`). stages: the fused stages' wrapper
    (one `solve_stages` launch at dim 2, one `solve_stages3` launch at
    dim 3), or None for the composed stages (the stage-1 sweep and
    `bracket_state_batched` over `sweep`). sweep: the wrapper every stage
    sweep and halving calls on this rank's operands. bisect: "k1", "k4"
    (`bisect3`), "halvings", "while" or "fixed_halvings" (`_bisect`).
    count: where its number of halvings comes from: "device", "host",
    "fixed" or "loop" (the loop's own exit)."""

    stages: Optional[Callable]
    sweep: Callable
    bisect: str
    count: str


def route(device, dtype, dim, n, table=False, plain=False, reducer=None,
          grid=None) -> Route:
    """How a solve runs (the module docstring's table): operands of
    `dim` assets and `dtype` on `device` over a grid of n points, holding
    the dim-3 table U or not (`table`), through the plain twins or not
    (`plain`), with a day mesh (`reducer`) and a grid mesh (`grid`) given
    or None. Raises for a device other than the CPU or CUDA and for the
    f32 engine on a grid mesh."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"solve: unsupported device {device}")
    f32 = dtype == F32
    if f32 and grid is not None:
        raise ValueError("the f32 engine serves one device or a day mesh; "
                         "the JAX package has no f32 grid-sharded engine")
    if kind == "cpu" or plain:
        sweep = {2: masked_sweep_reference,
                 3: masked_contract3_reference}.get(dim, tcached_sweep)
        if f32 and dim == 2:
            return Route(None, sweep, "fixed_halvings", "fixed")
        return Route(None, sweep, "while", "loop")
    if dim == 2:
        k1 = grid is None and n <= bisect_max_grid_points(dtype)
        if f32:
            return Route(None, masked_sweep,
                         "k1" if k1 else "fixed_halvings", "fixed")
        if k1 and reducer is None:
            return Route(solve_stages, masked_sweep, "k1", "device")
        return Route(None, masked_sweep, "k1" if k1 else "halvings",
                     "host")
    if dim == 3:
        if table and not f32 and reducer is None and grid is None:
            return Route(solve_stages3, masked_contract3, "k4",
                         "device")
        sweep = masked_contract3 if table else masked_contract3_rebuild
    else:
        sweep = tcached_sweep
    return Route(None, sweep, "halvings", "host")


def _route(ops, plain=False, reducer=None, grid=None) -> Route:
    """`route` of the operands, as the code observes them."""
    if isinstance(ops, SweepOperands):
        dim, table = 2, False
    elif isinstance(ops, Contract3Operands):
        dim, table = 3, ops.U is not None
    else:
        dim, table = ops.cols[0].shape[-2], False
    return route(ops.x.device, ops.x.dtype, dim, ops.x.shape[0], table,
                 plain, reducer, grid)


def _routes(ops, plain, reducer=None, grid=None):
    """(sweep, bisect) of the operands' route: the sweep summed over a
    grid mesh's ranks, and the route's bisection with the signature of
    `bisect_levels`, the meshes bound in, taking a fixed count as
    `n_iters=` and `solve_stages`'s widest bracket as `widest=`."""
    r = _route(ops, plain, reducer, grid)
    sweep = r.sweep if grid is None else _grid_summed(r.sweep, grid)
    return sweep, functools.partial(_bisect, r, sweep, reducer)


def _grid_summed(sweep, grid):
    """`sweep` whose (L, T) share of the operands' outer rows is summed
    over the grid ranks (`grid.grid_sum`: exact, in rank order)."""
    def summed(ops, bounds, weights, box_min=-5.0):
        return grid.grid_sum(sweep(ops, bounds, weights, box_min))
    return summed


def _bisect(r, sweep, reducer, ops, lower, upper, prev_res, prev_up, ustack,
            obj, weights, tolerance, box_min=-5.0, widest=None,
            n_iters=None):
    """Route `r`'s bisection of the (L, T) state (lower, upper, prev_res,
    prev_up, ustack) of levels obj (L,) and weight rows (L, dim) over
    `sweep` -> (L, T) roots, its global decisions taken over every rank's
    days with a `reducer`."""
    state = (lower, upper, prev_res, prev_up, ustack)
    if r.bisect == "k4":
        return bisect3(ops, *state, obj, weights, tolerance, box_min,
                       widest=widest, n_iters=n_iters)
    if r.count == "fixed":  # in the operands' type, as JAX's f32 K1
        obj = obj.to(ops.x.dtype)
        if r.bisect == "k1":
            return _launch_k1(ops, state, obj, weights, box_min, n_iters)
        return fixed_halvings(ops, *state, obj, weights, n_iters, sweep,
                              box_min)
    if r.bisect == "k1":
        return bisect_levels(ops, *state, obj, weights, tolerance, box_min,
                             reducer=reducer, widest=widest)
    if ops.x.dtype == F32:  # float64 state, each halving an f32 sweep
        f32_sweep, weights = sweep, weights.to(F32).contiguous()

        def sweep(ops, bounds, weights, box_min=-5.0):
            return f32_sweep(ops, bounds.to(F32).contiguous(), weights,
                             box_min).to(F64)

        state = tuple(t.to(F64).contiguous() for t in state[:4]) + (
            ustack.contiguous(),)
        obj = obj.to(F64)
    if r.bisect == "while":
        return bisect_levels_reference(ops, *state, obj, weights, tolerance,
                                       box_min, sweep, reducer)
    n_iters = _halving_count(state[0], state[1], tolerance, reducer)
    return bisect_fixed_count(ops, *state, obj, weights, tolerance, n_iters,
                              sweep, box_min, reducer)


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
    """Stage-1 sweep + stage-2 bracket + bisection of L rows on the
    operands' route. weights is (dim,) for one portfolio shared by every
    row (one stage-1 sweep serves them all) or (L, dim) for one portfolio
    per row. `plain` picks the plain twins over the dispatching wrappers.
    With a `reducer` the operands hold one rank's day block, and only the
    bisection's global decisions are reduced; with a `grid` they hold one
    rank's outer grid rows, and every sweep is summed over the grid
    ranks. Returns (roots (L, T), nan_days (L, T))."""
    r = _route(ops, plain, reducer, grid)
    # on one card in the call shape the fault harness replaces
    sweep, bisect = (_routes(ops, plain) if reducer is None and grid is None
                     else _routes(ops, plain, reducer, grid))
    dt, kw = ops.x.dtype, {}
    if r.stages is not None:  # one fused launch
        L = obj.shape[0]
        if weights.dim() == 1:
            weights = weights.reshape(1, -1).expand(L, -1)
        weights = weights.contiguous()
        with span("solve.bracket"):
            *state, nan_days, kw["widest"] = r.stages(
                ops, obj, weights, cfg, quirks, box_min)
    else:
        (*state, nan_days), weights = _stages(
            ops, obj.to(dt), weights.to(dt), cfg, quirks, box_min, sweep, dt)
    if r.count == "fixed":  # JAX's f32 dim-2 `_full_solve`
        kw["n_iters"] = full_iters(tolerance, cfg[3], cfg[4])
        nan_days = nan_days | _day_nan(ops)[None]
    elif r.bisect == "k4":  # the device bisection's launches
        kw["n_iters"] = max_halvings(cfg, tolerance)
    with span("solve.bisect"):
        roots = bisect(ops, *(t.contiguous() for t in state), obj, weights,
                       tolerance, box_min, **kw)
    return roots, nan_days


def full_solve(ops, obj, weights, cfg, tolerance=1e-6, quirks=False,
               box_min=-5.0, reducer=None, grid=None):
    """L rows of levels `obj` (L,) with one portfolio `weights` (dim,)
    shared by every row, or one per row (L, dim) -> (roots (L, T),
    nan_days (L, T)), on the operands' route: float64 operands on the f64
    engine, float32 ones on the f32 engine (roots float32 at dim 2,
    float64 at dim 3); the kernels on a CUDA device, the plain twins on
    the CPU. cfg = (first_guess, sg0, sg1, min_var, max_var). With a
    `reducer` (a `DayMesh`) `ops` holds this rank's day block and T is its
    length; with a `grid` (a `GridMesh`, the f64 engine) this rank's outer
    grid rows."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       False, reducer, grid)


def full_solve_reference(ops, obj, weights, cfg, tolerance=1e-6,
                         quirks=False, box_min=-5.0, reducer=None,
                         grid=None):
    """`full_solve` through the plain twins, on any device."""
    return _full_solve(ops, obj, weights, cfg, tolerance, quirks, box_min,
                       True, reducer, grid)
