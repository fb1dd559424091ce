#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`copula_var_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port still builds and serves.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: name, capability, `nvidia-smi` name and power limit;
  2. build: compile the CUDA kernels from `copula_var_tpu_torch/csrc`, one
     `nvcc` per source, all started together;
  3. main path, two assets, counted: `from_csv` -> `load_artifacts(device=
     "cuda")` -> `calc_var(0.05)` for the flagship MSM and GARCH artifacts
     (2 assets, T = 500 days, 100-point grid, Student-t copula), held
     against `data/flagship_var.npz` at atol 1e-9 with the recorded
     coverage statistics recomputed; the prep builds each backtest's prefix
     table P (40.4 MB) once; then a serving batch, `calc_var_grid` with 32
     portfolios x 4 levels (128 rows);
  4. main path from the CSV, fitted on the card, counted: `from_csv` ->
     `create_var_backtest(device="cuda")` for MSM (k = 4, basin_iter =
     100, seed 0) and GARCH (p, q <= 3) with a Student-t copula at the
     flagship size -> `calc_var(0.05)`. The fits are held to the
     artifacts' `meta` (GARCH (p, q) equal, omega, alpha, beta within 1e-6
     relative, nll 1e-9 relative; MSM m_0 and sigma 1e-6 relative, b and
     gamma 1e-6 absolute, LL 1e-8 relative; rho 1e-6, nu 1e-2); the
     in-sample marginals, densities and integration inputs, built on the
     card from the artifact's own fits, to its arrays at rtol 1e-9, and
     those of the refit at atol 1e-6; the VaR to `data/flagship_var.npz`
     at atol 1e-9; each step's wall time is printed beside the card;
  5. mean-reverting family, counted: `from_csv` -> `load_artifacts(
     data/flagship_artifacts_mean_reverting.npz, device="cuda")` ->
     `calc_var(0.05)` held against `data/flagship_mr_var.npz` at atol
     1e-9; then `config.run_backtest(data, cfg, device="cuda")` with cfg
     the mean-reverting family and a Student-t copula at perturb_scale = 0
     (the rest at its defaults): the UKF EM, the copula fit and the
     integration inputs on the card, the fits held to the artifact's
     `meta` (a, l, q within 1e-9 relative, LL 1e-10 relative; rho 1e-6,
     nu 1e-2), the VaR to the record at 1e-9, each stage's wall time
     printed beside the card; and one `synthetic_dataset` of a GARCH, an
     MSM and an OU series simulated on the card, their sample variances
     printed;
  6. main path, three assets, counted: the same for the dim-3 artifacts
     (`data/dim3_artifacts_{msm,garch}.npz`, weights (0.5, 0.3, 0.2)) held
     against `data/dim3_var.npz`; the prep builds each backtest's table U
     (4.0 GB) once, and the path's peak device memory is read;
  7. the dim-3 path fitted from `data/dim3.csv` on the card, counted:
     `create_var_backtest(device="cuda")` for GARCH and MSM (k = 4,
     basin_iter = 100, seed 0) with a Student-t copula (its correlations
     by L-BFGS), the fits held to the dim-3 artifacts' `meta` with phase
     4's bounds and the VaR to `data/dim3_var.npz` at atol 1e-9, each
     step's wall time printed. Before each counted path every kernel
     launch counter is zeroed and after it read; each kernel of that path
     must have launched and the other paths' kernels must not;
  8. refine_root and the reference-quirks fits, counted:
     `load_artifacts(..., refine_root=True, device="cuda")` for the
     flagship and the dim-3 MSM and GARCH artifacts, `calc_var_levels`,
     `calc_var_portfolios` and a `calc_var_grid` row held against
     `data/{flagship,dim3}_refined_var.npz` at atol 1e-9 (the trap
     re-solve, `ops/refine.py`, is plain PyTorch: the refined paths launch
     the same kernels as the unrefined ones); then
     `create_var_backtest(flagship, "garch", "student",
     reference_quirks=True)` on the card, its GARCH quirk fits (both
     assets, p, q <= 3) held to `data/flagship_quirk_fits.npz` ((p, q)
     equal, params rtol 1e-9, nll 1e-10 relative; rho 1e-6, nu 1e-2) and
     its `calc_var(0.05)` with `reference_quirks = True` to the record at
     1e-9; the MSM quirk fits (k = 4, basin_iter = 0) at 1e-9 (LL 1e-10);
     `generate_student_t_copula_data()` on the card: its density step
     held to the JAX-written copy at rtol 1e-12 on the copy's pairs, its
     pairs equal to the copy's, or, where numpy sorts the 100000 tied
     copula values otherwise, drawn from the same seeded draw; each
     stage's wall time printed;
  9. four assets (dim 4), counted: `load_artifacts(data/dim4_artifacts_
     {msm,garch}.npz, device="cuda")` -> `calc_var(0.05)` over T = 500 at
     n = 32, held against `data/dim4_var.npz` at atol 1e-9 with the
     coverage statistics recomputed; the same fits at n = 90 on the record's
     16-day cut (`create_var_backtest(..., model_fits_override=,
     copula_fit_override=)`), its two portfolio rows at n = 32 and
     `refine_root=True` at n = 32 on 8 days, all at 1e-9; one stage-1
     sweep of the MSM backtest at n = 90 over all 500 days, timed with CUDA
     events, its first 16 days bit-equal to the same sweep of those days
     alone; `create_var_backtest(dim4, "garch", "student", num_points=32)`
     from the artifact's model fits, so the dim-4 Student fit runs on the
     card (rho 1e-6, nu 1e-2 of the artifact's `meta`, VaR at 1e-9). The
     dim >= 4 path is plain PyTorch (the JAX package has no Pallas kernel
     there): K1-K4 must launch 0 times. Prints each query's wall time, the
     phase's peak device memory, a torch.profiler reading of one n = 32
     `calc_var` and the plain sweep's bound (`tcached_bound`);
  10. day sharding (`parallel/`), counted per rank: every path below
     first on one card with no mesh (the one-card series): the flagship
     MSM and GARCH artifacts' `calc_var(0.05)`, the 32 x 4 `calc_var_grid`
     and `refine_root=True` levels of `data/flagship_refined_var.npz`;
     the dim-3 artifacts' `calc_var(0.05)` and 8 x 4 grid; the dim-4 MSM
     artifact at n = 32 over T = 500. (a) A world of one NCCL rank in
     this process (`distributed.initialize`, tcp on 127.0.0.1) serves the
     flagship MSM through a `DayMesh`; (b) three gloo ranks share the card
     (NCCL refuses two ranks on one GPU), spawned by
     `distributed.run_world` after the kernels are built, days [0, 167),
     [167, 334), [334, 500), and serve every path. Each result is held
     bit-equal to the one-card series and within 1e-9 of its record (0
     days above); each rank must launch K1 and K2 on the dim-2 path and
     K4 on the dim-3 path (and nothing on dim 4). Prints each rank's day
     block, launches, peak device memory (U split three ways) and wall
     seconds; the ranks share one card, so no figure here is a scaling
     figure;
  11. grid sharding (`parallel/`, a ('days', 'grid') `GridMesh`), counted
     per rank, held to phase 10's one-card series: (a) a world of one
     NCCL rank in this process serves the flagship MSM through a (1, 1)
     grid mesh (within 1e-12, bit-equal expected; the largest difference
     printed); (b) four gloo ranks share the card as a (1, 4) mesh, each
     on its n / 4 outer grid rows (25 of 100 at dim 2 and 3, 8 of 32 at
     dim 4), and serve every path of phase 10; (c) the same ranks as a
     (2, 2) mesh serve the flagship MSM `calc_var(0.05)` and 32 x 4 grid
     (the MSM dim-2 days split over the day axis too). Every rank's
     results within 1e-12 of the one-card series and 1e-9 of the records
     (0 days above), and bit-equal to rank 0's; K1 launches 0 times (a
     grid rank bisects by K2 or K4 sweeps summed over the ranks), K2 and
     K4 on every rank, one table per backtest; the dim-3 table U of a
     rank is a quarter of one card's and the dim-3 path's peak below half
     of it. Prints each rank's rows, day block, launches, peak device
     memory and wall seconds (the ranks share one card: no scaling
     figure);
  12. wide grids, counted per series: each series of
     `data/wide_grid_var.npz` (written by JAX's xla engine on the CPU:
     dim 2 at n = 180, 200 and 400 on 16 days, dim 3 at n = 180 and 300
     on 8 days, MSM and GARCH, Student-t, the artifacts' fits and the
     record's inputs at that width) served on the card with every plain
     sweep made to raise, at atol 1e-9 with 0 days above; dim 2 past
     K1's 169 must bisect by K2 sweeps (K1 0 launches), dim 3 past the
     table's 169 by the rebuild kernel (`masked_contract3_rebuild`: no
     table, no table sweep); the route and the K1 / K2 / K4-table /
     K4-rebuild launches printed per series; each dim-2 series' table P
     and K2 sweeps (the long-row form at n = 200 and 400) held to their
     plain twins on that series' operands (P rtol 1e-12 with equal flags,
     a stage row and three random rows rtol 1e-12, repeats bit-equal).
     The rebuild kernel against
     its plain twin (n = 300 and 180, all slabs and a range, rtol 1e-13,
     repeats bit-equal); one full-T rebuild sweep at dim 3, n = 300
     (T = 500, L = 1) timed with CUDA events beside its plain twin and
     traced by torch.profiler, as a share of `rebuild_bound`; and an
     adapter holding only the JAX package's minimal contract (GARCH,
     `fit`, `marginals_densities`, `integration_inputs`, `integrals`) on
     a 16-day flagship cut at n = 40 against its JAX record at 1e-9, no
     kernel launched, portfolios refused;
  13. parity: each kernel against its plain PyTorch twin on the card, at
     the main paths' shapes (q = 5 and q = 1, stage and random bounds,
     unequal weights; K4 also with a Gaussian copula; the dim-2 table P
     whole, the dim-3 table U on 16 days), a repeated launch of each that
     must give the same bits, a dim-2 sweep row alone against its bits
     inside a 128-row batch, and the serving batches (128 rows at dim 2,
     8 portfolios x 4 levels at dim 3) against the plain solves; K2 and K4
     on the four outer row ranges of a (1, 4) grid mesh at n = 100: P and
     U the whole tables' rows bit for bit, each range against its plain
     twin, its repeat bit-equal, the four partials summed in rank order
     against the whole launch at rtol 1e-13, and the range of all rows
     bit-equal to the whole launch;
  14. timings: CUDA events after warm-up, median and min of the reps,
     kernel and plain twin taken in turns (one grid rank's 25-row K2 and
     K4 launches among them), and the refine_root trap pass per call
     (L = 1 and 128 at dim 2, L = 1 at dim 3) beside the unrefined solve
     of the same rows;
  15. device profile: torch.profiler over calls of each kernel, `calc_var`,
     the serving batches, the unrefined solves and the trap passes: host
     ms per call, the device's busy ms and ops, and each kernel's
     launches and device ms per launch (each session opens with pad
     kernels, read past, since the trace drops a session's first device
     activities once child processes have used the card; a session that
     lost every pad is run again, up to three times, and then reads "not
     measured").

Each kernel's bound in the record is the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its float64
operations over 34 TFLOP/s (NVIDIA H100 SXM data sheet; FP64 outside the
tensor cores), counted from this run's shapes by `bound()`; the trap
pass's by `trap_bound()`, the dim-4 plain sweep's by `tcached_bound()`
and the rebuild sweep's by `rebuild_bound()`.

Prints the kernels' JSON record on the line before the last (each
kernel's launches on the main path, the rebuild's on phase 12, and, as
`grid_launches_per_rank`, on one rank of phase 11 (b)), and as the last
line `{"ok": true, "device": {...}}`. Exits non-zero, with no result
line, when torch sees no CUDA device or the port's sources are missing.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPS = 10
REPS_DIM3_PLAIN = 3  # a full-width dim-3 plain sweep takes ~0.1 s per row
ROWS_P = 32  # dim-2 serving batch: portfolios x LEVELS
ROWS_P3 = 8  # dim-3 serving batch: portfolios x LEVELS
LEVELS = (0.01, 0.025, 0.05, 0.1)
ATOL_VAR = 1e-9  # tests/test_flagship.py holds the f64 record to this
BASIN_ITER = 100  # examples/flagship.py's MSM basin hop
# fitted state against the artifacts' meta: a VaR day moves only beyond
# these (relative on the model parameters; absolute on MSM's b and gamma,
# which sit on their lower bounds, and on the copula's rho and nu)
FIT_RTOL_PARAMS, FIT_RTOL_GARCH_NLL, FIT_RTOL_MSM_LL = 1e-6, 1e-9, 1e-8
FIT_ATOL_BOUND, FIT_ATOL_RHO, FIT_ATOL_NU = 1e-6, 1e-6, 1e-2
# integration inputs, marginals and densities: built on the card from the
# artifact's own fits, against the artifact's arrays; and from the refit,
# where MSM's m_0 is pinned only to its optimizer's stall resolution
# (~1e-8), so its probabilities move by ~1e-8 while no VaR day does
RTOL_FIT_ARRAYS, ATOL_REFIT_ARRAYS = 1e-9, 1e-6
# the UKF EM at perturb_scale = 0 draws nothing: its fit is the JAX one to
# the rounding of the filter (measured ~1e-14 on the CPU)
FIT_RTOL_UKF, FIT_RTOL_UKF_LL = 1e-9, 1e-10
# the reference-quirks fits draw nothing (MSM at basin_iter = 0): held
# along the trajectory, to the JAX-written record
QUIRK_RTOL_PARAMS, QUIRK_RTOL_LL = 1e-9, 1e-10
RTOL_SAMPLER = 1e-12  # the Student-t fixture's densities
SYNTHETIC = (1635, 1135, ("garch", "msm", "ou"))  # n_total, N, spec
# kernel sweep vs plain sweep: the two sum the same float64 terms in
# different orders (dim 2: masked U = V .* (wfc W1) per warp vs
# W0 (V .* M) W1^T then . FC; dim 3: masked U = V .* (W1^T G W2) per slab
# vs three tensordots then . FC, with CUDA's exp/log1p), so they agree to
# a few ulps of the scale
RTOL_SWEEP = 1e-12
# the partial sweeps of grid ranks' outer rows summed in rank order against
# one launch over all rows: the same terms, grouped by range
RTOL_PARTS = 1e-13
# kernel bisection vs plain bisection: identical masks and bookkeeping;
# a root could move only if a slab's rounding flipped res < obj
ATOL_ROOT = 1e-9
# the tables against their plain twins: dim 3, the same cells of U, only
# CUDA's exp / log1p and the order of the q x q state sum differ; dim 2,
# the prefix sums of P are sequential in the kernel and a parallel scan in
# torch.cumsum, and the q-term state sum is ordered differently
RTOL_TABLE = 1e-12
TABLE_DAYS = 16  # days of U held against the plain twin
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F64_FLOP_PER_S = 34e12  # H100 SXM data sheet, FP64 outside the tensor cores
# the device spans of each wrapper's launch: (counted kernel, others...)
KERNEL_SPANS = {
    "sweep_table": ("sweep_table_kernel",),
    "masked_sweep": ("prefix_sweep_kernel",),
    "bisect_levels": ("bisect_levels_kernel",),
    "contract3_weights": ("contract3_weights_kernel",),
    "masked_contract3": ("contract3_sweep_kernel", "contract3_sum_kernel"),
    "masked_contract3_rebuild": ("contract3_rebuild_kernel",
                                 "contract3_sum_kernel"),
}


def bound(nbytes, flops):
    """(bound ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lookups(n):
    """f64 operations of one row lookup of the interval rule: prev, two
    dynamic bounds (sub, div each), the clamp, two binary searches of
    ceil(log2(n + 1)) compares and one subtraction."""
    return 7 + 2 * math.ceil(math.log2(n + 1))


def day_bytes(T, n, q):
    """The dim-2 kernels' day operands: V, wfc, W1 and x."""
    return 8 * (T * n * n + T * n * q + q * n + n)


def table_bound(T, n, q):
    """sweep_table (K2 build): the day operands in, the T n^2 cells of P
    (not its pad cells) and the T n row flags out; per cell the state sum
    (2q), the product with V and the prefix add."""
    return bound(day_bytes(T, n, q) + 8 * T * n * n + T * n,
                 T * n * n * (2 * q + 2))


def sweep_bound(T, n, q, L, rows=None):
    """masked_sweep (K2) on `rows` outer rows (n by default): of the
    prefix table only the cells the interval rule reads (two per row
    lookup, at most the table's T rows n), the T rows row flags, x, the
    (L, T, 2) bounds and (L, 2) weights in, (L, T) out; one row lookup
    per bound row, day and outer row."""
    r = n if rows is None else rows
    cells = min(T * r * n, 2 * L * T * r)
    return bound(8 * (cells + n + 2 * L * T + 2 * L + L * T) + T * r,
                 L * T * r * lookups(n))


def bisect_bound(T, n, q, L, n_iters):
    """bisect_levels (K1): the day operands and the (L, T) state in, the
    roots out; U formed and scanned once, then n lookups per row, day and
    halving."""
    return bound(day_bytes(T, n, q) + L * T * (8 * 5 + 1) + 8 * 3 * L,
                 T * n * n * (2 * q + 2) + n_iters * L * T * n * lookups(n))


def contract3_bound(T, n, L, rows=None):
    """masked_contract3 (K4 sweep) on `rows` outer slabs (n by default):
    the T rows n^2 cells of U (not the layout's pad cells, which are never
    summed) and (L, T, 2) bounds in, (L, T) out; every row scanned once,
    n lookups per (row, day, i0), rows partials summed per (row, day)."""
    r = n if rows is None else rows
    return bound(8 * (T * r * n * n + n + 2 * L * T + 3 * L + L * T),
                 T * r * n * n + L * T * r * n * lookups(n) + L * T * r)


def weights_bound(T, n, q, student, garch):
    """contract3_weights (K4 build): the columns and G in, the T n^3 cells
    of U out (not its pad cells); per cell the quadratic form (15), the
    density (8, exp and log1p one each), the pdf product (3, GARCH) and the
    state sum (2q + 1); the (q, n) fold per slab."""
    cols = 3 * T * n * (8 * (1 + student + garch) + 1)
    return bound(cols + 8 * (2 * q * n + T * n * q * q + 9 + T * n ** 3),
                 T * n ** 3 * (24 + 2 * q + 3 * garch) + T * n * n * 2 * q * q)


def trap_bound(T, n, q, L, dim, garch, student, halvings):
    """The refine_root trap pass (plain PyTorch, no kernel of its own): in,
    the day tensors (dim 2) or the transform columns (dim 3), the state
    combinations and weights, the (L, T) staircase roots, levels, weights
    and half-widths; out, the (L, T) refined roots. Per halving, row and
    day: the boundary fraction and the mask of
    each cell (13), at dim 3 the density rebuilt from the columns (17,
    7 more for Student-t, 4 more for GARCH), and the state contraction."""
    if dim == 2:
        day_in, per_cell = T * n * n, 13
        contract = 2 * q * n * n + 2 * q * q * n + 2 * q * q
    else:
        day_in = T * 3 * n * (1 + 2 * student + garch)
        per_cell = 30 + 7 * student + 4 * garch
        contract = (2 * q * n ** 3 + 2 * q * q * n * n + 2 * q ** 3 * n
                    + 2 * q ** 3)
    nbytes = 8 * (day_in + T * q ** dim + dim * q * n + n + 2 * L * T
                  + L * (dim + 2))
    return bound(nbytes,
                 halvings * L * T * (n ** dim * per_cell + contract))


def tcached_bound(T, n, dim, q, L, student, garch):
    """The dim >= 4 plain sweep (`ops/tcached.py::tcached_sweep`, no kernel
    of its own): in, the transform columns (z and the log univariate
    density as float64, the finite flags as bytes, Student-t), the pdf
    columns (GARCH) or the state combinations and densities (MSM), x, dx,
    the (L, T, 2) bounds and (L, dim) weights; out, the (L, T) integrals.
    Per cell of the L T n^dim: the quadratic form (2 dim + 3 dim (dim - 1)
    / 2), the density (Student-t 2 dim + 8: the division, log1p, scale,
    the dim - 1 sums of the univariate terms and dim - 1 finite ANDs, the
    difference, exp and the NaN select; Gaussian dim + 3), the mask and its
    select (4), at GARCH the pdf product, the product and nan_to_num
    (dim + 1), and the first state contraction (2q; the later ones and the
    combination sum are a factor n smaller and not counted)."""
    per_cell = (2 * dim + 3 * dim * (dim - 1) // 2
                + (2 * dim + 8 if student else dim + 3) + 4
                + (dim + 1 if garch else 0) + 2 * q)
    cols = T * dim * n * ((8 + 1 + 8) if student else 8)
    state = T * dim * n * 8 if garch else 8 * (T * q ** dim + dim * q * n)
    nbytes = cols + state + 8 * (2 * n + 2 * L * T + L * dim + L * T)
    return bound(nbytes, L * T * n ** dim * per_cell)


def cuda_ms(torch, fns, reps=REPS, warmup=2):
    """{name: (median_ms, min_ms)} for each callable, timed in turns with
    CUDA events after `warmup` untimed calls of each."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    import statistics

    return {k: (statistics.median(v), min(v)) for k, v in times.items()}


# Once child processes have used the card, torch.profiler drops the first
# device activities of a session (on the H100 with torch 2.11; 0-10 of
# them in one run, every pad of one session in another): every session
# first launches PROFILE_PAD spin kernels, and only what follows the last
# one that was recorded is read. A session that lost every pad is run
# again, up to PROFILE_ATTEMPTS times; then its device figures are None
# (not measured).
PROFILE_PAD = 128
PROFILE_PAD_CYCLES = 10000  # ~5 us each
PROFILE_PAD_SPAN = "spin_kernel"  # torch.cuda._sleep's kernel
PROFILE_ATTEMPTS = 3


def device_profile(torch, fn, reps=REPS):
    """Per call of `fn`, traced by torch.profiler after one warm-up call
    and PROFILE_PAD pad kernels: host wall ms, device busy ms (the union
    of the device's activity intervals), and for each of the port's
    kernels its launches and mean device ms per launch (None when the
    trace holds none); pad_lost, the pad kernels the trace dropped, and
    attempts, the sessions run. When every session lost every pad, the
    device figures are None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(PROFILE_PAD_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        spans = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
        )
        pads = [i for i, (_, _, name) in enumerate(spans)
                if PROFILE_PAD_SPAN in name]
        if pads:
            break
    else:
        return {"wall_ms": wall_ms, "busy_ms": None, "device_ops": None,
                "kernels": {k: {"launches": None, "device_ms": None}
                            for k in KERNEL_SPANS},
                "pad_lost": PROFILE_PAD, "attempts": PROFILE_ATTEMPTS}
    spans = spans[pads[-1] + 1:]
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    kernels = {}
    for k, names in KERNEL_SPANS.items():
        n = sum(1 for _, _, name in spans if names[0] in name)
        us = sum(b - a for a, b, name in spans
                 if any(m in name for m in names))
        kernels[k] = {"launches": n / reps,
                      "device_ms": us / n / 1e3 if n else None}
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3 / reps,
            "device_ops": len(spans) / reps, "kernels": kernels,
            "pad_lost": PROFILE_PAD - len(pads), "attempts": attempt}


def _ms(v, fmt=".3f"):
    """A profile's figure, or "not measured" where the trace had none."""
    return "not measured" if v is None else format(v, fmt)


SHARDED_RANKS = 3  # the day-sharded phase's gloo ranks, on the one card
SHARDED_TIMEOUT_S = 300  # a rank that dies fails the others by then


def _served(root, name, data, mesh, **kw):
    """load_artifacts(data/<name>, device="cuda", mesh=mesh, **kw)."""
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    return load_artifacts(os.path.join(root, "data", name), data,
                          device="cuda", mesh=mesh, **kw)


def serve_day_sharded(root, mesh, w_batch, w_batch3,
                      paths=("dim2", "dim3", "dim4")):
    """The `paths` of the sharded phases through `mesh` (a DayMesh or a
    GridMesh; None: one card, cuda:0), each counted alone: ({name:
    array}, {path: launches}, {path: peak device bytes above what was
    allocated when the path began}, {path: wall s}).
    dim2: the flagship MSM and GARCH artifacts' calc_var(0.05), the
    ROWS_P x LEVELS grid and the refined levels of
    `flagship_refined_var.npz`; dim2_msm: the flagship MSM calc_var(0.05)
    and grid alone; dim3: the dim-3 artifacts' calc_var(0.05) and the
    ROWS_P3 x LEVELS grid, one backtest at a time; dim4: the MSM
    artifact's calc_var(0.05) at n = 32 over T = 500."""
    import numpy as np
    import torch

    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
    from copula_var_tpu_torch.ops import cuda_solver as cs

    counters = (cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
                cq3.contract3_weights, cq3.masked_contract3,
                cq3.masked_contract3_rebuild)
    rec_r = np.load(os.path.join(root, "data", "flagship_refined_var.npz"))
    rec3 = np.load(os.path.join(root, "data", "dim3_var.npz"))
    rec4 = np.load(os.path.join(root, "data", "dim4_var.npz"))
    out = {}

    def dim2(families=("msm", "garch"), refined=True):
        data = from_csv(os.path.join(root, "data", "flagship.csv"), 1135)
        for est in families:
            bt = _served(root, f"flagship_artifacts_{est}.npz", data, mesh)
            out[f"dim2/{est}/var"] = bt.calc_var(0.05)
            out[f"dim2/{est}/grid"] = bt.calc_var_grid(w_batch, LEVELS)
            if not refined:
                continue
            bt = _served(root, f"flagship_artifacts_{est}.npz", data, mesh,
                         refine_root=True)
            out[f"dim2/{est}/refined"] = bt.calc_var_levels(
                tuple(rec_r["levels"]))

    def dim3():
        data = from_csv(os.path.join(root, "data", "dim3.csv"),
                        int(rec3["n_insample"]), weights=rec3["weights"])
        for est in ("msm", "garch"):
            bt = _served(root, f"dim3_artifacts_{est}.npz", data, mesh)
            out[f"dim3/{est}/var"] = bt.calc_var(0.05)
            out[f"dim3/{est}/grid"] = bt.calc_var_grid(w_batch3, LEVELS)
            out[f"dim3/{est}/table_bytes"] = np.array(
                bt.sweep_operands().U.numel() * 8)
            del bt
            torch.cuda.empty_cache()

    def dim4():
        data = from_csv(os.path.join(root, "data", "dim4.csv"),
                        int(rec4["n_insample"]), weights=rec4["weights"])
        bt = _served(root, "dim4_artifacts_msm.npz", data, mesh)
        out["dim4/msm/var"] = bt.calc_var(float(rec4["obj_var"]))

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    launches, peaks, walls = {}, {}, {}
    fns = {"dim2": dim2, "dim3": dim3, "dim4": dim4,
           "dim2_msm": lambda: dim2(("msm",), refined=False)}
    for name in paths:
        fn = fns[name]
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        launches[name] = {c.__name__: c.launches for c in counters}
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
    return out, launches, peaks, walls


def day_sharded_rank(root, out_dir, w_batch, w_batch3):
    """One gloo rank of the day-sharded phase (spawned by
    `parallel.distributed.run_world`): serve every path through the
    world's mesh and save what this rank got, its day block, launches,
    peak device memory and wall seconds to out_dir/rank<r>.{npz,json}."""
    import numpy as np

    from copula_var_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    out, launches, peaks, walls = serve_day_sharded(root, mesh, w_batch,
                                                    w_batch3)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump({"rank": mesh.rank, "device": str(mesh.device),
                   "block_T500": list(mesh.day_block(500)),
                   "launches": launches, "peak_bytes": peaks,
                   "wall_s": walls}, f)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _records(root):
    """The records the sharded phases' series are held to, by name."""
    import numpy as np

    def load(name):
        return np.load(os.path.join(root, "data", name))

    rec, rec_r = load("flagship_var.npz"), load("flagship_refined_var.npz")
    rec3, rec4 = load("dim3_var.npz"), load("dim4_var.npz")
    return {"dim2/msm/var": rec["msm_var"],
            "dim2/garch/var": rec["garch_var"],
            "dim2/msm/refined": rec_r["msm_levels"],
            "dim2/garch/refined": rec_r["garch_levels"],
            "dim3/msm/var": rec3["msm_var"],
            "dim3/garch/var": rec3["garch_var"],
            "dim4/msm/var": rec4["msm_var"]}


def _held(phase, name, got, one_card, record, atol=0.0):
    """Raise unless `got` is finite, of the one-card series' shape,
    within `atol` of it (0.0: bit-equal) and within ATOL_VAR of its
    record (0 days above). Returns (|got - one card| max, |got - record|
    max or None)."""
    import numpy as np

    if got.shape != one_card.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{phase} {name}: bad output {got.shape}")
    e1 = float(np.max(np.abs(got - one_card)))
    if not (np.array_equal(got, one_card) if atol == 0.0 else e1 <= atol):
        raise AssertionError(f"{phase} {name}: off the one-card series by "
                             f"{e1:.3e} (bound {atol:g})")
    if record is None:
        return e1, None
    d = np.abs(got - record)
    if not d.max() <= ATOL_VAR:
        raise AssertionError(f"{phase} {name}: off the record by "
                             f"{d.max():.3e}, {int(np.sum(d > ATOL_VAR))}"
                             " days above")
    return e1, float(d.max())


def day_sharded_phase(root, smi, w_batch, w_batch3):
    """The day-sharded phase. First every path of `serve_day_sharded` on
    one card, with no mesh: the one-card series. (a) A world of one NCCL
    rank in this process serves the flagship MSM through a `DayMesh`,
    bit-equal to the one-card series and within 1e-9 of the record;
    (b) SHARDED_RANKS gloo ranks on the one card, spawned after this
    process built the kernels, serve every path, each rank's results
    bit-equal to the one-card series and within 1e-9 of the records
    (0 days above). Returns (the phase's report, the one-card series,
    its peak device bytes per path)."""
    import tempfile

    import numpy as np
    import torch

    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.parallel import distributed, make_mesh

    def held(name, got, want_bits, record):
        return _held("day-sharded", name, got, want_bits, record)[1]

    unsharded, launches1, peaks1, walls1 = serve_day_sharded(
        root, None, w_batch, w_batch3)
    report = {"one_card": {"launches": launches1, "peak_bytes": peaks1,
                           "wall_s": walls1}}
    print(f"day-sharded, one card (no mesh): launches {launches1}; peak "
          f"device bytes above each path's start {peaks1}; dim-3 table U "
          f"{int(unsharded['dim3/msm/table_bytes'])} bytes; wall s "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls1.items()))
    records = _records(root)

    # (a) NCCL, a world of one in this process
    t0 = time.perf_counter()
    distributed.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1,
                           rank=0, backend="nccl", device="cuda",
                           timeout_s=SHARDED_TIMEOUT_S)
    try:
        mesh = make_mesh()
        data = from_csv(os.path.join(root, "data", "flagship.csv"), 1135)
        var = _served(root, "flagship_artifacts_msm.npz", data,
                      mesh).calc_var(0.05)
        backend = torch.distributed.get_backend()
    finally:
        distributed.shutdown()
    err = held("nccl dim2/msm/var", var, unsharded["dim2/msm/var"],
               records["dim2/msm/var"])
    report["nccl_world1"] = {"backend": backend, "max_err": err,
                             "wall_s": time.perf_counter() - t0}
    print(f"day-sharded (a): world of 1, {backend}, flagship MSM through a "
          f"DayMesh: bit-equal to the one-card series, max |VaR - record| "
          f"= {err:.3e} (bound {ATOL_VAR:g}); "
          f"{report['nccl_world1']['wall_s']:.3f} s (host clock)")

    # (b) SHARDED_RANKS gloo ranks sharing this card
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        distributed.run_world(day_sharded_rank, SHARDED_RANKS,
                              (root, out_dir, w_batch, w_batch3),
                              backend="gloo", device="cuda",
                              timeout_s=SHARDED_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(SHARDED_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                info = json.load(f)
            info["results"] = dict(np.load(os.path.join(out_dir,
                                                        f"rank{r}.npz")))
            ranks.append(info)
    errs = {}
    for info in ranks:
        r, got = info["rank"], info["results"]
        for name, want in unsharded.items():
            if name.endswith("table_bytes"):
                continue
            e = held(f"rank {r} {name}", got[name], want, records.get(name))
            if e is not None:
                errs[name] = max(errs.get(name, 0.0), e)
        lc = info["launches"]
        for k in ("sweep_table", "masked_sweep", "bisect_levels"):
            if lc["dim2"][k] <= 0:
                raise AssertionError(f"rank {r}: {k} never launched on the "
                                     "dim-2 path")
        if lc["dim2"]["sweep_table"] != 4:
            raise AssertionError(f"rank {r}: sweep_table did not build one "
                                 "table per dim-2 backtest")
        if lc["dim3"]["contract3_weights"] != 2 or \
                lc["dim3"]["masked_contract3"] <= 0:
            raise AssertionError(f"rank {r}: K4 did not run its dim-3 path "
                                 f"{lc['dim3']}")
        if lc["dim2"]["masked_contract3"] or \
                lc["dim2"]["masked_contract3_rebuild"] or \
                lc["dim3"]["masked_sweep"] or any(lc["dim4"].values()):
            raise AssertionError(f"rank {r}: a kernel launched off its path "
                                 f"{lc}")
        print(f"day-sharded (b) rank {r} of {SHARDED_RANKS} "
              f"({info['device']}, gloo): days [{info['block_T500'][0]}, "
              f"{info['block_T500'][1]}) of 500; launches {lc}; peak device "
              f"bytes above each path's start {info['peak_bytes']}; dim-3 table U "
              f"{int(got['dim3/msm/table_bytes'])} bytes; wall s "
              + ", ".join(f"{k} {v:.3f}" for k, v in info["wall_s"].items()))
    print(f"day-sharded (b): {SHARDED_RANKS} ranks, every result bit-equal "
          f"to the one-card series and each record within {ATOL_VAR:g} "
          "(0 days above): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; phase wall {wall:.3f} s, host clock, spawn included ({smi}; "
          "ranks share one card: not a scaling figure)")
    report["gloo_world"] = {
        "ranks": [{k: v for k, v in info.items() if k != "results"}
                  for info in ranks],
        "max_err": errs, "wall_s": wall}
    return report, unsharded, peaks1


GRID_RANKS = 4  # the grid-sharded phase's gloo ranks, on the one card
GRID_SHAPES = ((1, GRID_RANKS), (2, 2))  # (b) every path; (c) dim2_msm
ATOL_GRID = 1e-12  # a grid-sharded series against the one-card series


def grid_sharded_rank(root, out_dir, w_batch, w_batch3):
    """One gloo rank of the grid-sharded phase (spawned by
    `parallel.distributed.run_world`): (b) every path through the
    (1, GRID_RANKS) grid mesh, (c) the flagship MSM `calc_var` and grid
    through the (2, 2) mesh; saves what this rank got, its outer rows,
    day block, launches, peak device memory and wall seconds to
    out_dir/rank<r>.{npz,json}."""
    import numpy as np

    from copula_var_tpu_torch.parallel import make_mesh

    meshes = [make_mesh(axis_names=("days", "grid"), shape=s)
              for s in GRID_SHAPES]
    out, info = {}, {"rank": meshes[0].rank, "device": str(meshes[0].device)}
    for shape, mesh, paths in zip(GRID_SHAPES, meshes,
                                  (("dim2", "dim3", "dim4"), ("dim2_msm",))):
        tag = f"{shape[0]}x{shape[1]}"
        res, launches, peaks, walls = serve_day_sharded(
            root, mesh, w_batch, w_batch3, paths)
        out.update({f"{tag}/{k}": v for k, v in res.items()})
        info[tag] = {"rows_n100": list(mesh.rows(100)),
                     "rows_n32": list(mesh.rows(32)),
                     "days_T500": list(mesh.day_mesh.day_block(500)),
                     "launches": launches, "peak_bytes": peaks,
                     "wall_s": walls}
    np.savez(os.path.join(out_dir, f"rank{info['rank']}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{info['rank']}.json"), "w") as f:
        json.dump(info, f)


def grid_sharded_phase(root, smi, w_batch, w_batch3, one_card,
                       one_card_peaks):
    """The grid-sharded phase, held to the day-sharded phase's one-card
    series `one_card`. (a) A world of one NCCL rank in this process
    serves the flagship MSM through a (1, 1) grid mesh (its grid_sum an
    NCCL all_reduce over the world): within 1e-12 of the one-card series
    (bit-equal expected; the largest difference printed) and 1e-9 of
    the record. (b) GRID_RANKS gloo ranks share the card, a (1, 4) mesh
    (n / 4 outer rows each), and serve every path; (c) the same ranks as
    a (2, 2) mesh serve the flagship MSM `calc_var` and grid (its days
    split over the day axis too). Every rank's results within 1e-12 of
    the one-card series and 1e-9 of the records (0 days above), and
    bit-equal to rank 0's; K1 launches 0 times, K2 and K4 on every rank,
    one table per backtest; the dim-3 table U of a rank is a quarter of
    one card's. Returns the phase's report."""
    import tempfile

    import numpy as np
    import torch

    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.ops.cuda_quadrature3 import table_bytes
    from copula_var_tpu_torch.parallel import distributed, make_mesh

    records = _records(root)
    report = {}

    # (a) NCCL, a (1, 1) grid mesh over a world of one in this process
    t0 = time.perf_counter()
    distributed.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1,
                           rank=0, backend="nccl", device="cuda",
                           timeout_s=SHARDED_TIMEOUT_S)
    try:
        mesh = make_mesh(axis_names=("days", "grid"), shape=(1, 1))
        data = from_csv(os.path.join(root, "data", "flagship.csv"), 1135)
        var = _served(root, "flagship_artifacts_msm.npz", data,
                      mesh).calc_var(0.05)
        backend = torch.distributed.get_backend()
    finally:
        distributed.shutdown()
    e1, err = _held("grid-sharded (a)", "dim2/msm/var", var,
                    one_card["dim2/msm/var"], records["dim2/msm/var"],
                    ATOL_GRID)
    report["nccl_world1"] = {"backend": backend, "max_err": err,
                             "max_diff_one_card": e1,
                             "bit_equal": bool(np.array_equal(
                                 var, one_card["dim2/msm/var"])),
                             "wall_s": time.perf_counter() - t0}
    print(f"grid-sharded (a): world of 1, {backend}, flagship MSM through a "
          f"(1, 1) grid mesh: max |VaR - one card| = {e1:.3e} (bound "
          f"{ATOL_GRID:g}; bit-equal {report['nccl_world1']['bit_equal']}), "
          f"max |VaR - record| = {err:.3e} (bound {ATOL_VAR:g}); "
          f"{report['nccl_world1']['wall_s']:.3f} s (host clock)")

    # (b), (c) GRID_RANKS gloo ranks sharing this card
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        distributed.run_world(grid_sharded_rank, GRID_RANKS,
                              (root, out_dir, w_batch, w_batch3),
                              backend="gloo", device="cuda",
                              timeout_s=SHARDED_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(GRID_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                info = json.load(f)
            info["results"] = dict(np.load(os.path.join(out_dir,
                                                        f"rank{r}.npz")))
            ranks.append(info)
    u_rank = table_bytes(500, 100, 100 // GRID_RANKS)
    u_card = int(one_card["dim3/msm/table_bytes"])
    errs, diffs = {}, {}
    first = ranks[0]["results"]
    for info in ranks:
        r, got = info["rank"], info["results"]
        for key, value in got.items():
            if not np.array_equal(value, first[key]):
                raise AssertionError(f"grid-sharded rank {r} {key}: not "
                                     "bit-equal to rank 0's")
            tag, name = key.split("/", 1)
            if name.endswith("table_bytes"):
                if int(value) != u_rank:
                    raise AssertionError(f"grid-sharded rank {r} {key}: "
                                         f"{int(value)} bytes, not {u_rank}")
                continue
            e1, e = _held(f"grid-sharded rank {r}", key, value,
                          one_card[name], records.get(name), ATOL_GRID)
            diffs[key] = max(diffs.get(key, 0.0), e1)
            if e is not None:
                errs[key] = max(errs.get(key, 0.0), e)
        for shape in GRID_SHAPES:
            tag = f"{shape[0]}x{shape[1]}"
            lc = info[tag]["launches"]
            if any(c["bisect_levels"] for c in lc.values()):
                raise AssertionError(f"grid-sharded rank {r} {tag}: K1 "
                                     f"launched {lc}")
            dim2 = lc.get("dim2", lc.get("dim2_msm"))
            if dim2["masked_sweep"] <= 0 or dim2["sweep_table"] != (
                    4 if "dim2" in lc else 1):
                raise AssertionError(f"grid-sharded rank {r} {tag}: K2 did "
                                     f"not run its dim-2 path {lc}")
            if "dim3" in lc and (lc["dim3"]["contract3_weights"] != 2 or
                                 lc["dim3"]["masked_contract3"] <= 0):
                raise AssertionError(f"grid-sharded rank {r} {tag}: K4 did "
                                     f"not run its dim-3 path {lc}")
            if dim2["masked_contract3"] or dim2["masked_contract3_rebuild"] or (
                    "dim3" in lc and lc["dim3"]["masked_sweep"]) or (
                    "dim4" in lc and any(lc["dim4"].values())):
                raise AssertionError(f"grid-sharded rank {r} {tag}: a "
                                     f"kernel launched off its path {lc}")
        peak3 = info["1x4"]["peak_bytes"]["dim3"]
        if not peak3 < 0.5 * one_card_peaks["dim3"]:
            raise AssertionError(
                f"grid-sharded rank {r}: dim-3 peak {peak3} bytes is not "
                f"below half of one card's {one_card_peaks['dim3']}")
        for shape in GRID_SHAPES:
            tag = f"{shape[0]}x{shape[1]}"
            i = info[tag]
            print(f"grid-sharded ({'b' if tag == '1x4' else 'c'}) rank {r} "
                  f"of {GRID_RANKS} ({info['device']}, gloo), mesh {shape}: "
                  f"outer rows [{i['rows_n100'][0]}, {i['rows_n100'][1]}) "
                  f"of 100, [{i['rows_n32'][0]}, {i['rows_n32'][1]}) of "
                  f"32; days [{i['days_T500'][0]}, {i['days_T500'][1]}) of "
                  f"500 on the MSM dim-2 path; launches {i['launches']}; "
                  f"peak device bytes above each path's start "
                  f"{i['peak_bytes']}; wall s "
                  + ", ".join(f"{k} {v:.3f}" for k, v in i["wall_s"].items()))
    print(f"grid-sharded (b), (c): {GRID_RANKS} ranks, every result "
          "bit-equal to rank 0's, within "
          f"{ATOL_GRID:g} of the one-card series (largest: "
          + ", ".join(f"{k} {e:.3e}" for k, e in diffs.items())
          + f") and each record within {ATOL_VAR:g} (0 days above): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; dim-3 table U per rank {u_rank} bytes against {u_card} on "
          f"one card, dim-3 path peak per rank "
          f"{ranks[0]['1x4']['peak_bytes']['dim3']} bytes against "
          f"{one_card_peaks['dim3']}; phase wall {wall:.3f} s, host clock, "
          f"spawn included ({smi}; ranks share one card: not a scaling "
          "figure)")
    report["gloo_world"] = {
        "ranks": [{k: v for k, v in info.items() if k != "results"}
                  for info in ranks],
        "max_err": errs, "max_diff_one_card": diffs,
        "table_bytes_per_rank": u_rank, "table_bytes_one_card": u_card,
        "wall_s": wall}
    return report


WIDE_DAYS_T = 500  # the full-T rebuild sweep's days (dim 3, n = 300)
WIDE_N_TIMED = 300
REPS_WIDE = 3  # a full-T n = 300 rebuild sweep takes ~0.1-0.3 s
# the rebuild kernel against its plain twin: the same cells (CUDA's exp
# and log1p against torch's), summed by tiles instead of tensordots
RTOL_REBUILD = 1e-13


class MinimalGarch:
    """A plugin adapter with the JAX package's minimal contract only:
    the GARCH family's fit, marginals, integration inputs and uncached
    integrand, and no day_tensors / day_columns (the host route)."""

    name = "minimal_garch"

    def __init__(self, **kw):
        from copula_var_tpu_torch.backtest import GarchAdapter

        self._inner = GarchAdapter(**kw)

    def fit(self, in_sample, device="cuda", timings=None):
        return self._inner.fit(in_sample, device=device)

    def marginals_densities(self, in_sample, fits, device="cuda"):
        return self._inner.marginals_densities(in_sample, fits, device=device)

    def integration_inputs(self, windows, fits, num_points, box=(-5.0, 5.0),
                           device="cuda"):
        return self._inner.integration_inputs(windows, fits, num_points, box,
                                              device=device)

    def integrals(self, bounds, inputs, spec, weights, box_min=-5.0):
        return self._inner.integrals(bounds, inputs, spec, weights, box_min)


def rebuild_bound(T, n, q, L, student, garch, rows=None):
    """masked_contract3_rebuild (K4 without U) on `rows` outer slabs (n
    by default): in, the columns (z, lu as float64, the finite flags as
    bytes; the pdf columns at GARCH), G, W1, W2, x, the (L, T, 2) bounds
    and (L, 3) weights; out, the (L, T) integrals. Per cell of the
    T rows n^2 of a sweep `weights_bound`'s operations (quadratic form,
    density with one exp and one log1p, pdf product, state sum) and the
    prefix add; the (q, n) fold per slab; n lookups per (row, day, i0)."""
    r = n if rows is None else rows
    cols = 3 * T * n * (8 * (1 + student + garch) + 1)
    nbytes = cols + 8 * (T * n * q * q + 2 * q * n + n + 2 * L * T + 3 * L
                         + L * T)
    flops = (T * r * n * n * (24 + 2 * q + 3 * garch + 1)
             + T * r * n * 2 * q * q + L * T * r * n * lookups(n))
    return bound(nbytes, flops)


def wide_grid_phase(root, smi):
    """Grids past the flagship's, through the kernels, counted per series:
    each series of `data/wide_grid_var.npz` (dim 2 at n = 180, 200, 400
    on 16 days; dim 3 at n = 180, 300 on 8 days; MSM and GARCH, the
    committed artifacts' fits and the record's inputs at that width)
    served on the card with every plain sweep made to raise, held at atol
    1e-9 (0 days above); the route and the K1 / K2 / K4-table /
    K4-rebuild launches printed per series (dim 2 past K1's 169: K2
    sweeps only; dim 3 past the table's 169: the rebuild only), and each
    dim-2 series' P and K2 sweeps, at its width, against their plain
    twins (`k2_parity`). Then the rebuild kernel against its plain twin (n = 300 and 180, all slabs
    and a range, repeats bit-equal), one full-T rebuild sweep at dim 3,
    n = 300 (T = 500, L = 1) timed with CUDA events beside the plain
    twin and traced by torch.profiler, as a share of `rebuild_bound`;
    and the minimal-plugin GARCH adapter against its JAX record.
    Returns (report, the rebuild's kernels-line numbers)."""
    import numpy as np
    import torch

    from copula_var_tpu_torch import backtest as bt_mod
    from copula_var_tpu_torch.data import from_csv, from_returns
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
    from copula_var_tpu_torch.ops import cuda_solver as cs
    from copula_var_tpu_torch.ops import tcached
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    t_phase = time.perf_counter()
    rec = np.load(os.path.join(root, "data", "wide_grid_var.npz"))
    alpha = float(rec["obj_var"])
    counters = (cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
                cq3.contract3_weights, cq3.masked_contract3,
                cq3.masked_contract3_rebuild)

    def refuse(*_a, **_k):
        raise AssertionError("a plain sweep ran on the card")

    # every plain sweep the solver could reach, made to raise while the
    # series are served
    plain = [(cs, "masked_sweep_reference"), (cs, "masked_contract3_reference"),
             (cs, "tcached_sweep"), (cq, "masked_sweep_reference"),
             (cq3, "masked_contract3_reference"), (tcached, "tcached_sweep")]
    dev = torch.device("cuda", 0)
    wrows = torch.tensor([[0.5, 0.5], [0.3, 0.7], [0.75, 0.25], [0.9, 0.1]],
                         dtype=torch.float64, device=dev)

    def k2_parity(tag, ops):
        """K2 at a dim-2 series' width (n > 192: the long-row form) on the
        series' own operands, after its launches were counted: P and its
        flags against `sweep_table_reference`, the sweep of a stage row
        and three random rows against `masked_sweep_reference`, and
        repeated launches bit-equal."""
        T, n = ops.days, ops.x.shape[0]
        p_p, f_p = cq.sweep_table_reference(ops)
        close = torch.isclose(ops.P, p_p, rtol=RTOL_TABLE, atol=1e-300,
                              equal_nan=True)
        if not (bool(close.all()) and torch.equal(ops.flags, f_p)):
            raise AssertionError(
                f"wide {tag} sweep_table: {int((~close).sum())} cells, "
                f"{int((ops.flags != f_p).sum())} flags off the plain twin")
        fin = torch.isfinite(p_p)
        e_p = float((ops.P[fin] - p_p[fin]).abs().max())
        if not torch.equal(ops.P, cq.sweep_table(ops)[0]):
            raise AssertionError(f"wide {tag} sweep_table: a rebuild "
                                 "changed P")
        rng = np.random.default_rng(n)
        lo = rng.uniform(-8.0, -1.0, (3, T))
        rand = np.stack([lo, lo + rng.uniform(0.0, 3.0, (3, T))], -1)
        stage1 = np.stack([np.full(T, -100.0), np.full(T, -3.0)], -1)
        bounds = torch.tensor(np.concatenate([stage1[None], rand]),
                              device=dev)
        k = cq.masked_sweep(ops, bounds, wrows, -5.0)
        p = cq.masked_sweep_reference(ops, bounds, wrows, -5.0)
        scale = float(p.abs().max())
        e = float((k - p).abs().max())
        if not e <= RTOL_SWEEP * scale:
            raise AssertionError(f"wide {tag} masked_sweep: |kernel - plain| "
                                 f"{e:.3e} > {RTOL_SWEEP:g} x {scale:.3e}")
        if not torch.equal(k, cq.masked_sweep(ops, bounds, wrows, -5.0)):
            raise AssertionError(f"wide {tag} masked_sweep: a repeated "
                                 "launch changed the sweep")
        form = "long" if n > cq.BISECT_MAX_ROW else "short"
        print(f"parity wide {tag} (n={n}, {form}-row K2, {T} days): "
              f"sweep_table max abs {e_p:.3e} (bound rel {RTOL_TABLE:g} per "
              f"cell), {int(ops.flags.sum())} rows flagged; masked_sweep L=4 "
              f"max abs {e:.3e} rel {e / scale:.3e} (bound rel "
              f"{RTOL_SWEEP:g}); repeats bit-equal")
        return {"form": form, "sweep_table_max_abs": e_p,
                "masked_sweep_max_abs": e, "masked_sweep_rel": e / scale}

    cases = {2: ("flagship.csv", "flagship_artifacts", None),
             3: ("dim3.csv", "dim3_artifacts", tuple(rec["weights3"]))}
    series, bases, total, k2_report = {}, {}, {}, {}
    for dim, (csv, prefix, w) in cases.items():
        data = from_csv(os.path.join(root, "data", csv), 1135, weights=w)
        days = int(rec[f"dim{dim}_days"])
        cut = from_returns(data.returns[:1135 + days], data.tickers, 1135,
                           weights=w)
        for est in ("msm", "garch"):
            base = load_artifacts(os.path.join(root, "data",
                                               f"{prefix}_{est}.npz"),
                                  data, device="cuda")
            bases[(dim, est)] = (data, base)
            cls = (bt_mod.MsmIntegrationInputs if est == "msm"
                   else bt_mod.GarchIntegrationInputs)
            for n in (int(v) for v in rec[f"dim{dim}_widths"]):
                tag = f"dim{dim}_{est}_n{n}"
                inputs = cls(*[rec[f"{tag}_ii_{f}"] for f in cls._fields])
                for c in counters:
                    c.launches = 0
                saved = [(m, a, getattr(m, a)) for m, a in plain]
                for m, a, _ in saved:
                    setattr(m, a, refuse)
                t0 = time.perf_counter()
                try:
                    bt = bt_mod.VaRBacktest(
                        cut, base.adapter, base.copula, base.copula_fit,
                        base.model_fits, inputs, num_points=n, device="cuda")
                    var = bt.calc_var(alpha)
                    ops = bt.sweep_operands()
                finally:
                    for m, a, fn in saved:
                        setattr(m, a, fn)
                wall = time.perf_counter() - t0
                lc = {c.__name__: c.launches for c in counters}
                for k, v in lc.items():
                    total[k] = total.get(k, 0) + v
                route = (cs.dim2_bisect_route(n) if dim == 2 else
                         "table" if ops.U is not None else "rebuild")
                want = rec[f"{tag}_var"]
                if var.shape != want.shape or not np.all(np.isfinite(var)):
                    raise AssertionError(f"wide {tag}: bad VaR {var.shape}")
                diff = np.abs(var - want)
                above = int(np.sum(diff > ATOL_VAR))
                if above:
                    raise AssertionError(f"wide {tag}: {above} days off the "
                                         f"record, max {diff.max():.3e}")
                if dim == 2 and (route != "sweeps" or lc["bisect_levels"] or
                                 lc["masked_sweep"] <= 0 or
                                 lc["sweep_table"] != 1):
                    raise AssertionError(f"wide {tag}: not bisected by K2 "
                                         f"sweeps: {route} {lc}")
                if dim == 3 and (route != "rebuild" or
                                 lc["masked_contract3"] or
                                 lc["contract3_weights"] or
                                 lc["masked_contract3_rebuild"] <= 0):
                    raise AssertionError(f"wide {tag}: not swept by the "
                                         f"rebuild kernel: {route} {lc}")
                series[tag] = {"route": route, "launches": lc,
                               "max_err": float(diff.max()),
                               "days_above": above, "wall_s": wall}
                print(f"wide {tag}: route {route}, max |VaR - record| = "
                      f"{diff.max():.3e} (bound {ATOL_VAR:g}), days above "
                      f"{above} of {len(var)}; launches K1 "
                      f"{lc['bisect_levels']}, K2 table {lc['sweep_table']} "
                      f"sweep {lc['masked_sweep']}, K4 table "
                      f"{lc['contract3_weights']} sweep "
                      f"{lc['masked_contract3']}, K4 rebuild "
                      f"{lc['masked_contract3_rebuild']}; {wall:.3f} s "
                      "(host clock)")
                if dim == 2:
                    k2_report[tag] = k2_parity(tag, ops)
                del bt, ops
    torch.cuda.empty_cache()

    # the rebuild kernel against its plain twin, repeats bit-equal
    def rows3(T, L, seed):
        rng = np.random.default_rng(seed)
        lo = rng.uniform(-6.0, -0.5, (L, T))
        b = np.stack([lo, lo + rng.uniform(0.3, 4.0, (L, T))], -1)
        return (torch.tensor(b, device="cuda"),
                torch.tensor(rng.dirichlet([2.0, 2.0, 2.0], size=L),
                             device="cuda"))

    parity = {}
    for est, n, rows in (("msm", 300, None), ("msm", 300, (100, 220)),
                         ("garch", 180, None), ("garch", 180, (0, 61))):
        data, base = bases[(3, est)]
        days = int(rec["dim3_days"])
        cls = (bt_mod.MsmIntegrationInputs if est == "msm"
               else bt_mod.GarchIntegrationInputs)
        tag = f"dim3_{est}_n{n}"
        inputs = cls(*[torch.as_tensor(rec[f"{tag}_ii_{f}"], device=dev)
                       for f in cls._fields])
        cols = base.adapter.day_columns(inputs, base.copula_spec)
        ops = base.adapter.contract3_operands(cols, inputs, base.copula_spec,
                                              rows=rows)
        b, w = rows3(days, 4, n)
        got = cq3.masked_contract3_rebuild(ops, b, w)
        want = cq3.masked_contract3_reference(ops, b, w)
        rel = float((got - want).abs().max() / want.abs().max())
        if not rel <= RTOL_REBUILD:
            raise AssertionError(f"rebuild {tag} rows {rows}: {rel:.3e} "
                                 f"relative off its plain twin")
        if not torch.equal(got, cq3.masked_contract3_rebuild(ops, b, w)):
            raise AssertionError(f"rebuild {tag} rows {rows}: a repeated "
                                 "launch gave other bits")
        parity[f"{tag}_rows{rows}"] = {
            "max_abs_err": float((got - want).abs().max()), "rel": rel}
        print(f"parity rebuild {tag} rows {rows or (0, n)}, L=4, {days} "
              f"days: {rel:.3e} relative off the plain twin (bound "
              f"{RTOL_REBUILD:g}), repeat bit-equal")

    # one full-T rebuild sweep at dim 3, n = 300 (T = 500, L = 1): the MSM
    # artifact's T = 500 forecasts at the record's n = 300 grid
    data, base = bases[(3, "msm")]
    ii = base.integration_inputs
    tag = f"dim3_msm_n{WIDE_N_TIMED}"
    full = ii._replace(**{f: torch.as_tensor(rec[f"{tag}_ii_{f}"],
                                             device=dev)
                          for f in ("x", "dx", "densities")})
    bt = bt_mod.VaRBacktest(data, base.adapter, base.copula, base.copula_fit,
                            base.model_fits, full, num_points=WIDE_N_TIMED,
                            device="cuda")
    ops = bt.sweep_operands()
    T, q = ops.days, ops.w1.shape[0]
    if ops.U is not None or T != WIDE_DAYS_T:
        raise AssertionError(f"the full-T n={WIDE_N_TIMED} operands took the "
                             "table route")
    stage1 = torch.tensor([-100.0, -3.0], dtype=torch.float64,
                          device=dev).expand(1, T, 2).contiguous()
    w1 = bt.weights.reshape(1, 3)
    got = cq3.masked_contract3_rebuild(ops, stage1, w1)
    want = cq3.masked_contract3_reference(ops, stage1, w1)  # warms it up
    kern = cuda_ms(torch, {"kernel": lambda: cq3.masked_contract3_rebuild(
        ops, stage1, w1)}, reps=REPS_WIDE)
    plain_ms = cuda_ms(torch, {"plain": lambda: cq3.masked_contract3_reference(
        ops, stage1, w1)}, reps=1, warmup=0)["plain"]
    err_full = float((got - want).abs().max())
    rel_full = err_full / float(want.abs().max())
    if not rel_full <= RTOL_REBUILD:
        raise AssertionError(f"rebuild full T: {rel_full:.3e} relative off "
                             "its plain twin")
    prof = device_profile(torch, lambda: cq3.masked_contract3_rebuild(
        ops, stage1, w1), reps=2)
    dev_ms = prof["kernels"]["masked_contract3_rebuild"]["device_ms"]
    b_ms, by = rebuild_bound(T, WIDE_N_TIMED, q, 1, True, False)
    share = "not measured" if dev_ms is None else f"{b_ms / dev_ms:.1%}"
    print(f"wide rebuild sweep dim3 MSM n={WIDE_N_TIMED}, T={T}, L=1, q={q}: "
          f"call {kern['kernel'][0]:.3f} ms (min {kern['kernel'][1]:.3f}; "
          f"CUDA events), device "
          + ("not measured" if dev_ms is None else f"{dev_ms:.3f} ms")
          + f" (torch.profiler); plain twin {plain_ms[0]:.3f} ms; "
          f"{rel_full:.3e} relative off it; bound {b_ms:.3f} ms by {by} "
          f"({share} of the device time) ({smi})")
    del bt, ops
    torch.cuda.empty_cache()

    # the minimal-plugin route: JAX's host bisection over `integrals`
    bt_mod.register_adapter(MinimalGarch.name, MinimalGarch)
    days, n = int(rec["plugin_days"]), int(rec["plugin_points"])
    data, base = bases[(2, "garch")]
    cut = from_returns(data.returns[:1135 + days], data.tickers, 1135)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    pb = bt_mod.create_var_backtest(
        cut, MinimalGarch.name, "student", num_points=n,
        model_fits_override=base.model_fits,
        copula_fit_override=base.copula_fit, device="cuda")
    var = pb.calc_var(alpha)
    levels = pb.calc_var_levels(tuple(rec["plugin_levels"]))
    plugin_s = time.perf_counter() - t0
    lc = {c.__name__: c.launches for c in counters}
    e_var = float(np.max(np.abs(var - rec["plugin_garch_var"])))
    e_lv = float(np.max(np.abs(levels - rec["plugin_garch_levels"])))
    if not (pb.plugin and e_var <= ATOL_VAR and e_lv <= ATOL_VAR):
        raise AssertionError(f"minimal plugin: VaR {e_var:.3e}, levels "
                             f"{e_lv:.3e} off the JAX record")
    if any(lc.values()):
        raise AssertionError(f"minimal plugin: a kernel launched {lc}")
    try:
        pb.calc_var_portfolios([[0.5, 0.5]], alpha)
    except ValueError:
        pass
    else:
        raise AssertionError("minimal plugin: calc_var_portfolios served")
    print(f"minimal plugin GARCH (fit, marginals_densities, "
          f"integration_inputs, integrals only), {days} days, n={n}: max "
          f"|VaR - JAX record| = {e_var:.3e}, levels {e_lv:.3e} (bound "
          f"{ATOL_VAR:g}); host bisection, plain PyTorch on the card, "
          f"launches {lc}; portfolios refused; {plugin_s:.3f} s (host "
          "clock)")
    phase_s = time.perf_counter() - t_phase
    print(f"wide phase: {phase_s:.3f} s, launches {total} ({smi})")
    report = {"series": series, "launches": total, "parity": parity,
              "k2_parity": k2_report,
              "full_T_sweep": {"T": T, "n": WIDE_N_TIMED, "q": q,
                               "kernel_ms": kern["kernel"],
                               "plain_ms": plain_ms, "device_ms": dev_ms,
                               "profile": prof, "bound_ms": [b_ms, by],
                               "rel_err": rel_full},
              "plugin": {"var_max_err": e_var, "levels_max_err": e_lv,
                         "launches": lc, "wall_s": plugin_s},
              "phase_s": phase_s}
    entry = {"launches": total["masked_contract3_rebuild"],
             "max_abs_err": err_full, "ms": kern["kernel"][0],
             "plain_ms": plain_ms[0], "bound_ms": b_ms, "bound_by": by}
    return report, entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "copula_var_tpu_torch", "csrc")):
        print(f"chip_smoke: the port's sources are not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import numpy as np

    from copula_var_tpu_torch import stats
    from copula_var_tpu_torch.backtest import VaRBacktest, create_var_backtest
    from copula_var_tpu_torch.config import BacktestConfig, run_backtest
    from copula_var_tpu_torch.copulas import fit as copula_fit_mod
    from copula_var_tpu_torch.copulas.student_sampler import (
        fixture_densities,
        generate_student_t_copula_data,
        t_copula_value,
    )
    from copula_var_tpu_torch.models import fit as model_fit_mod
    from copula_var_tpu_torch.data import (
        from_csv,
        from_returns,
        synthetic_dataset,
    )
    from copula_var_tpu_torch.ops import _build
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
    from copula_var_tpu_torch.ops import cuda_solver as cs
    from copula_var_tpu_torch.ops.quadrature import CopulaSpec
    from copula_var_tpu_torch.ops.refine import TRAP_HALVINGS, refine_roots
    from copula_var_tpu_torch.ops.solvers import bracket_state_batched
    from copula_var_tpu_torch.ops.tcached import ColumnOperands, tcached_sweep
    from copula_var_tpu_torch.utils.artifacts import _restore, load_artifacts

    if "jax" in sys.modules or "copula_var_tpu" in sys.modules:
        raise RuntimeError("the port imported jax or the JAX package")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}, capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)  # the card's name and power limit, as nvidia-smi gives them

    # -- build ------------------------------------------------------------
    libs = _build.build(force=True)
    _build.load()
    print(f"build: {_build.build_seconds:.2f} s, {len(libs)} nvcc in "
          f"parallel ({', '.join(str(p.relative_to(root)) for p in libs)})")
    for line in _build.build_log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"  {line.strip()}")

    counters = (cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
                cq3.contract3_weights, cq3.masked_contract3,
                cq3.masked_contract3_rebuild)

    def zero_counts():
        for c in counters:
            c.launches = 0

    def read_counts():
        return {c.__name__: c.launches for c in counters}

    def serve(csv, artifact, rec, weights=None):
        """from_csv -> load_artifacts(cuda) -> calc_var(alpha), held
        against the record; returns (backtest, VaR, prep s, solve s)."""
        alpha = float(rec["obj_var"])
        t0 = time.perf_counter()
        data = from_csv(os.path.join(root, "data", csv),
                        n_insample=int(rec["n_insample"]), weights=weights)
        bt = load_artifacts(os.path.join(root, "data", artifact), data,
                            device="cuda")
        bt.sweep_operands()
        t1 = time.perf_counter()
        var = bt.calc_var(alpha)
        solve = time.perf_counter() - t1
        return bt, var, t1 - t0, solve

    def coverage(est, bt, var, rec):
        alpha = float(rec["obj_var"])
        ptf = bt.data.portfolio_out_sample()
        rate = stats.exception_rate(ptf, var)
        kup = stats.kupiec_pof(ptf, var, alpha).p_value
        if abs(rate - float(rec[f"{est}_exception_rate"])) > 1e-12 or \
                abs(kup - float(rec[f"{est}_kupiec_p"])) > 1e-9:
            raise AssertionError(f"{est}: coverage statistics moved")
        return rate, kup

    # -- main path, two assets, counted -------------------------------------
    rec = np.load(os.path.join(root, "data", "flagship_var.npz"))
    alpha = float(rec["obj_var"])
    rng = np.random.default_rng(0)
    w_batch = rng.dirichlet([2.0, 2.0], size=ROWS_P)
    levels = np.array(LEVELS)
    zero_counts()
    t_main = time.perf_counter()
    bts, prep_s, solve_s = {}, {}, {}
    for est in ("msm", "garch"):
        bt, var, prep_s[est], solve_s[est] = serve(
            "flagship.csv", f"flagship_artifacts_{est}.npz", rec)
        want = rec[f"{est}_var"]
        if var.shape != want.shape or not np.all(np.isfinite(var)):
            raise AssertionError(f"{est}: bad VaR series {var.shape}")
        err = float(np.max(np.abs(var - want)))
        if err > ATOL_VAR:
            raise AssertionError(f"{est}: VaR off the record by {err:.3e}")
        rate, kup = coverage(est, bt, var, rec)
        print(f"main path {est}: max |VaR - record| = {err:.3e} "
              f"(bound {ATOL_VAR:g}), exception rate {rate:.4f}, Kupiec p "
              f"{kup:.4f}; load+prep {prep_s[est]:.3f} s, calc_var "
              f"{solve_s[est]:.3f} s (host clock)")
        bts[est] = bt
    t0 = time.perf_counter()
    grid = bts["msm"].calc_var_grid(w_batch, levels)
    grid_s = time.perf_counter() - t0
    if grid.shape != (ROWS_P, len(LEVELS), bts["msm"].data.out_sample_n) or \
            not np.all(np.isfinite(grid)):
        raise AssertionError(f"calc_var_grid: bad output {grid.shape}")
    launches = read_counts()
    print(f"main path: {time.perf_counter() - t_main:.3f} s, serving batch "
          f"{ROWS_P}x{len(LEVELS)} {grid_s:.3f} s, launches {launches}")
    for name in ("masked_sweep", "bisect_levels"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if launches["sweep_table"] != len(bts):
        raise AssertionError("sweep_table did not build one table per dim-2 "
                             "backtest")
    if launches["masked_contract3"] or launches["contract3_weights"] or \
            launches["masked_contract3_rebuild"]:
        raise AssertionError("a dim-3 kernel launched on the dim-2 path")

    # -- main path from the CSV, fitted on the card, counted -----------------
    def fit_gaps(est, bt, meta):
        """{quantity: (gap, bound)} of the fitted state against meta."""
        gaps = {}

        def rel(a, b):
            a, b = np.atleast_1d(np.asarray(a, float)), np.asarray(b, float)
            return float(np.max(np.abs(a - b) / np.abs(b)))

        for i, (f, m) in enumerate(zip(bt.model_fits, meta["model_fits"])):
            if est == "mean_reverting":
                for k in ("a", "l", "q"):
                    gaps[f"{k}[{i}]"] = (rel(getattr(f, k), m[k]),
                                         FIT_RTOL_UKF)
                gaps[f"LL[{i}]"] = (rel(f.log_likelihood, m["log_likelihood"]),
                                    FIT_RTOL_UKF_LL)
            elif est == "garch":
                if (f.p, f.q) != (m["p"], m["q"]):
                    raise AssertionError(f"garch asset {i}: (p, q) = "
                                         f"{(f.p, f.q)}, artifact "
                                         f"{(m['p'], m['q'])}")
                for k in ("omega", "alpha", "beta"):
                    gaps[f"{k}[{i}]"] = (rel(getattr(f, k), m[k]),
                                         FIT_RTOL_PARAMS)
                gaps[f"nll[{i}]"] = (rel(f.nll, m["nll"]), FIT_RTOL_GARCH_NLL)
            else:
                for k in ("m_0", "sigma"):
                    gaps[f"{k}[{i}]"] = (rel(getattr(f, k), m[k]),
                                         FIT_RTOL_PARAMS)
                for k in ("b", "gamma"):
                    gaps[f"{k}[{i}]"] = (abs(getattr(f, k) - m[k]),
                                         FIT_ATOL_BOUND)
                gaps[f"LL[{i}]"] = (rel(f.log_likelihood, m["log_likelihood"]),
                                    FIT_RTOL_MSM_LL)
        c, cm = bt.copula_fit, meta["copula_fit"]
        gaps["rho"] = (float(np.max(np.abs(c.packed_params[1:] - np.asarray(
            cm["packed_params"][1:])))), FIT_ATOL_RHO)
        gaps["nu"] = (abs(c.nu - cm["nu"]), FIT_ATOL_NU)
        return gaps

    def fitted(est):
        """from_csv -> create_var_backtest(cuda) -> calc_var(alpha), held
        against the artifact and the record; returns (backtest, report)."""
        art = np.load(os.path.join(root, "data",
                                   f"flagship_artifacts_{est}.npz"))
        meta = json.loads(str(art["meta"]))
        kw = ({"k": int(rec["k"]), "basin_iter": BASIN_ITER, "seed": 0}
              if est == "msm" else {})
        t0 = time.perf_counter()
        data = from_csv(os.path.join(root, "data", "flagship.csv"),
                        n_insample=int(rec["n_insample"]))
        bt = create_var_backtest(data, est, "student",
                                 num_points=int(rec["num_points"]),
                                 device="cuda", **kw)
        t1 = time.perf_counter()
        bt.sweep_operands()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        var = bt.calc_var(alpha)
        t3 = time.perf_counter()
        gaps = fit_gaps(est, bt, meta)
        bad = {k: v for k, v in gaps.items() if not v[0] <= v[1]}
        if bad:
            raise AssertionError(f"fit path {est}: fitted state off the "
                                 f"artifact: {bad}")
        # the same arrays built on the card from the artifact's own fits
        fits_a = [getattr(model_fit_mod, meta["fit_type"])(**{
            k: _restore(v) for k, v in f.items()})
            for f in meta["model_fits"]]
        cfit_a = getattr(copula_fit_mod, meta["copula_fit_type"])(**{
            k: _restore(v) for k, v in meta["copula_fit"].items()})
        bt_a = create_var_backtest(data, est, "student",
                                   num_points=int(rec["num_points"]),
                                   device="cuda", model_fits_override=fits_a,
                                   copula_fit_override=cfit_a)
        arr_err, arr_abs = {}, {}
        for k, want in ((k, art[k]) for k in art.files if k != "meta"):
            for b, errs, rel_ in ((bt_a, arr_err, True),
                                  (bt, arr_abs, False)):
                a = (b.integration_inputs._asdict()[k[3:]].cpu().numpy()
                     if k.startswith("ii_") else getattr(b, k))
                if a.shape != want.shape:
                    raise AssertionError(f"fit path {est}: {k} {a.shape}, "
                                         f"artifact {want.shape}")
                d = np.abs(a - want)
                errs[k] = float(np.max(d / np.maximum(np.abs(want), 1e-300)
                                       if rel_ else d))
        del bt_a
        want = rec[f"{est}_var"]
        if var.shape != want.shape or not np.all(np.isfinite(var)):
            raise AssertionError(f"fit path {est}: bad VaR series "
                                 f"{var.shape}")
        diff = np.abs(var - want)
        times = dict(bt.prep_stages, sweep_operands=t2 - t1,
                     first_calc_var=t3 - t2, csv_to_first_var=t3 - t0)
        print(f"fit path {est}: max |VaR - record| = {diff.max():.3e} "
              f"(bound {ATOL_VAR:g}), days above 1e-9: "
              f"{int(np.sum(diff > 1e-9))}; fit vs artifact "
              + ", ".join(f"{k} {g:.2e} (bound {b:g})"
                          for k, (g, b) in gaps.items()))
        print(f"fit path {est}: arrays vs artifact, built from its fits, "
              "max rel " + ", ".join(f"{k} {e:.2e}"
                                     for k, e in arr_err.items())
              + f" (bound {RTOL_FIT_ARRAYS:g}); from the refit, max abs "
              + ", ".join(f"{k} {e:.2e}" for k, e in arr_abs.items())
              + f" (bound {ATOL_REFIT_ARRAYS:g})")
        print(f"fit path {est} wall s (host clock, {smi}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        if diff.max() > ATOL_VAR:
            raise AssertionError(f"fit path {est}: VaR off the record by "
                                 f"{diff.max():.3e}")
        bad = {k: e for k, e in arr_err.items() if not e <= RTOL_FIT_ARRAYS}
        bad.update({k: e for k, e in arr_abs.items()
                    if not e <= ATOL_REFIT_ARRAYS})
        if bad:
            raise AssertionError(f"fit path {est}: arrays off the artifact "
                                 f"{bad}")
        return bt, {"wall_s": times, "fit_gaps": gaps,
                    "array_rel_err_artifact_fits": arr_err,
                    "array_abs_err_refit": arr_abs,
                    "var_max_err": float(diff.max())}

    zero_counts()
    fit_bts, fit_report = {}, {}
    for est in ("garch", "msm"):
        fit_bts[est], fit_report[est] = fitted(est)
    launches_fit = read_counts()
    print(f"fit path: launches {launches_fit}")
    for name in ("masked_sweep", "bisect_levels"):
        if launches_fit[name] <= 0:
            raise AssertionError(f"{name} never launched on the fit path")
    if launches_fit["sweep_table"] != len(fit_bts):
        raise AssertionError("sweep_table did not build one table per "
                             "fitted backtest")
    if launches_fit["masked_contract3"] or launches_fit["contract3_weights"]:
        raise AssertionError("a dim-3 kernel launched on the fit path")
    del fit_bts

    # -- mean-reverting family: served, then fitted by run_backtest, counted --
    mr = "mean_reverting"
    rec_mr = np.load(os.path.join(root, "data", "flagship_mr_var.npz"))
    meta_mr = json.loads(str(np.load(os.path.join(
        root, "data", f"flagship_artifacts_{mr}.npz"))["meta"]))
    want_mr = rec_mr[f"{mr}_var"]
    zero_counts()
    bt_mr, var_mr, prep_mr, solve_mr = serve(
        "flagship.csv", f"flagship_artifacts_{mr}.npz", rec_mr)
    if var_mr.shape != want_mr.shape or not np.all(np.isfinite(var_mr)):
        raise AssertionError(f"{mr}: bad VaR series {var_mr.shape}")
    err_mr = float(np.max(np.abs(var_mr - want_mr)))
    if err_mr > ATOL_VAR:
        raise AssertionError(f"{mr}: VaR off the record by {err_mr:.3e}")
    rate, kup = coverage(mr, bt_mr, var_mr, rec_mr)
    print(f"main path {mr}: max |VaR - record| = {err_mr:.3e} (bound "
          f"{ATOL_VAR:g}), exception rate {rate:.4f}, Kupiec p {kup:.4f}; "
          f"load+prep {prep_mr:.3f} s, calc_var {solve_mr:.3f} s (host "
          "clock)")
    del bt_mr
    cfg_mr = BacktestConfig(estimation_type=mr, copula_type="student",
                            n_insample=int(rec_mr["n_insample"]),
                            num_points=int(rec_mr["num_points"]))
    cfg_mr.mean_reverting.perturb_scale = float(rec_mr["perturb_scale"])
    cfg_mr.solver.obj_var = float(rec_mr["obj_var"])
    t0 = time.perf_counter()
    data_mr = from_csv(os.path.join(root, "data", "flagship.csv"),
                       n_insample=cfg_mr.n_insample)
    bt_rb, var_rb = run_backtest(data_mr, cfg_mr, device="cuda")
    csv_to_var_mr = time.perf_counter() - t0
    gaps_mr = fit_gaps(mr, bt_rb, meta_mr)
    diff_mr = np.abs(var_rb - want_mr)
    times_mr = dict(bt_rb.prep_stages, csv_to_var=csv_to_var_mr)
    print(f"run_backtest {mr}: max |VaR - record| = {diff_mr.max():.3e} "
          f"(bound {ATOL_VAR:g}), days above 1e-9: "
          f"{int(np.sum(diff_mr > 1e-9))}; fit vs artifact "
          + ", ".join(f"{k} {g:.2e} (bound {b:g})"
                      for k, (g, b) in gaps_mr.items()))
    print(f"run_backtest {mr} wall s (host clock, {smi}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times_mr.items()))
    bad = {k: v for k, v in gaps_mr.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"run_backtest {mr}: fitted state off the "
                             f"artifact: {bad}")
    if var_rb.shape != want_mr.shape or not diff_mr.max() <= ATOL_VAR:
        raise AssertionError(f"run_backtest {mr}: VaR off the record by "
                             f"{diff_mr.max():.3e}")
    launches_mr = read_counts()
    print(f"mean-reverting path: launches {launches_mr}")
    for name in ("sweep_table", "masked_sweep", "bisect_levels"):
        if launches_mr[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 "mean-reverting path")
    if launches_mr["masked_contract3"] or launches_mr["contract3_weights"]:
        raise AssertionError("a dim-3 kernel launched on the mean-reverting "
                             "path")
    del bt_rb
    t0 = time.perf_counter()
    syn = synthetic_dataset(0, *SYNTHETIC, device="cuda")
    syn_s = time.perf_counter() - t0
    syn_var = syn.returns.var(axis=0)
    if syn.returns.shape != (SYNTHETIC[0], len(SYNTHETIC[2])) or \
            not np.all(np.isfinite(syn.returns)):
        raise AssertionError(f"synthetic_dataset: bad returns "
                             f"{syn.returns.shape}")
    print(f"simulators: synthetic_dataset(0, {SYNTHETIC[0]}, {SYNTHETIC[1]}"
          f", {SYNTHETIC[2]}) on the card in {syn_s:.3f} s, sample variances "
          + ", ".join(f"{t} {v:.4f}" for t, v in zip(syn.tickers, syn_var)))

    # -- main path, three assets, counted -----------------------------------
    rec3 = np.load(os.path.join(root, "data", "dim3_var.npz"))
    w3 = np.asarray(rec3["weights"], np.float64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base3 = torch.cuda.memory_allocated()
    zero_counts()
    t_main3 = time.perf_counter()
    bts3, prep3_s, solve3_s, vars3 = {}, {}, {}, {}
    for est in ("msm", "garch"):
        bt, var, prep3_s[est], solve3_s[est] = serve(
            "dim3.csv", f"dim3_artifacts_{est}.npz", rec3, weights=w3)
        want = rec3[f"{est}_var"]
        if var.shape != want.shape or not np.all(np.isfinite(var)):
            raise AssertionError(f"dim3 {est}: bad VaR series {var.shape}")
        diff = np.abs(var - want)
        err = float(np.max(diff))
        rate, kup = coverage(est, bt, var, rec3)
        print(f"main path dim3 {est}: max |VaR - record| = {err:.3e} "
              f"(bound {ATOL_VAR:g}), days above 1e-9: "
              f"{int(np.sum(diff > 1e-9))}, exception rate {rate:.4f}, "
              f"Kupiec p {kup:.4f}; load+prep {prep3_s[est]:.3f} s, "
              f"calc_var {solve3_s[est]:.3f} s (host clock)")
        bts3[est], vars3[est] = bt, var
    launches3 = read_counts()
    torch.cuda.synchronize()
    peak3 = torch.cuda.max_memory_allocated()
    print(f"main path dim3: {time.perf_counter() - t_main3:.3f} s, "
          f"launches {launches3}; device memory peak {peak3} bytes "
          f"({base3} before the path), tables U "
          f"{[int(b.sweep_operands().U.numel() * 8) for b in bts3.values()]}"
          " bytes")
    if launches3["contract3_weights"] != len(bts3):
        raise AssertionError("contract3_weights did not build one table "
                             "per dim-3 backtest")
    if launches3["masked_contract3"] <= 0:
        raise AssertionError("masked_contract3 never launched on the dim-3 "
                             "main path")
    if launches3["masked_sweep"] or launches3["bisect_levels"] or \
            launches3["sweep_table"]:
        raise AssertionError("a dim-2 kernel launched on the dim-3 path")
    if launches3["masked_contract3_rebuild"]:
        raise AssertionError("the flagship dim-3 path left its table route")
    cfg = (-3.0, -3.5, -2.0, -7.5, 0.0)
    for est, bt in bts3.items():
        diff = np.abs(vars3[est] - rec3[f"{est}_var"])
        if np.max(diff) <= ATOL_VAR:
            continue
        # which bracket decision flipped: the plain solve on the same card
        r_plain, _ = cs.full_solve_levels_reference(
            bt.sweep_operands(), bt._tensor([alpha]), bt.weights, cfg)
        plain = r_plain[0].cpu().numpy() + bt.data.ptf_mean
        for d in np.flatnonzero(diff > ATOL_VAR):
            print(f"dim3 {est} day {d}: kernel {vars3[est][d]!r}, plain "
                  f"{plain[d]!r}, record {rec3[f'{est}_var'][d]!r}")
        raise AssertionError(f"dim3 {est}: VaR off the record by "
                             f"{np.max(diff):.3e}")

    # -- the dim-3 path fitted from the CSV on the card, counted -------------
    zero_counts()
    fit3_report = {}
    for est in ("garch", "msm"):
        meta3 = json.loads(str(np.load(os.path.join(
            root, "data", f"dim3_artifacts_{est}.npz"))["meta"]))
        kw = ({"k": int(rec3["k"]), "basin_iter": BASIN_ITER, "seed": 0}
              if est == "msm" else {})
        t0 = time.perf_counter()
        data3 = from_csv(os.path.join(root, "data", "dim3.csv"),
                         n_insample=int(rec3["n_insample"]), weights=w3)
        bt = create_var_backtest(data3, est, "student",
                                 num_points=int(rec3["num_points"]),
                                 device="cuda", **kw)
        t1 = time.perf_counter()
        bt.sweep_operands()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        var = bt.calc_var(alpha)
        t3 = time.perf_counter()
        gaps = fit_gaps(est, bt, meta3)
        diff = np.abs(var - rec3[f"{est}_var"])
        times = dict(bt.prep_stages, sweep_operands=t2 - t1,
                     first_calc_var=t3 - t2, csv_to_first_var=t3 - t0)
        print(f"dim3 fit path {est}: max |VaR - record| = {diff.max():.3e} "
              f"(bound {ATOL_VAR:g}), days above 1e-9: "
              f"{int(np.sum(diff > 1e-9))}; fit vs artifact "
              + ", ".join(f"{k} {g:.2e} (bound {b:g})"
                          for k, (g, b) in gaps.items()))
        print(f"dim3 fit path {est} wall s (host clock, {smi}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        bad = {k: v for k, v in gaps.items() if not v[0] <= v[1]}
        if bad:
            raise AssertionError(f"dim3 fit path {est}: fitted state off the "
                                 f"artifact: {bad}")
        if var.shape != diff.shape or not diff.max() <= ATOL_VAR:
            raise AssertionError(f"dim3 fit path {est}: VaR off the record "
                                 f"by {diff.max():.3e}")
        fit3_report[est] = {"wall_s": times, "fit_gaps": gaps,
                            "var_max_err": float(diff.max())}
        del bt
        torch.cuda.empty_cache()
    launches_fit3 = read_counts()
    print(f"dim3 fit path: launches {launches_fit3}")
    if launches_fit3["contract3_weights"] != len(fit3_report):
        raise AssertionError("contract3_weights did not build one table per "
                             "fitted dim-3 backtest")
    if launches_fit3["masked_contract3"] <= 0:
        raise AssertionError("masked_contract3 never launched on the fitted "
                             "dim-3 path")
    if launches_fit3["masked_sweep"] or launches_fit3["bisect_levels"] or \
            launches_fit3["sweep_table"]:
        raise AssertionError("a dim-2 kernel launched on the fitted dim-3 "
                             "path")

    # -- refine_root and the reference-quirks fits, counted -------------------
    def refined(csv, prefix, rec_r, dim_name, weights=None):
        """load_artifacts(refine_root=True) on the card for both families:
        levels, portfolios and a grid row, held against the refined
        record; returns {est: backtest} and {est: report}."""
        obj_r = float(rec_r["obj_var"])
        rows = np.asarray(rec_r["portfolio_weights"])
        out_bts, out = {}, {}
        for est in ("msm", "garch"):
            t0 = time.perf_counter()
            data = from_csv(os.path.join(root, "data", csv),
                            n_insample=int(rec_r["n_insample"]),
                            weights=weights)
            bt = load_artifacts(os.path.join(root, "data",
                                             f"{prefix}_{est}.npz"), data,
                                device="cuda", refine_root=True)
            bt.sweep_operands()
            t1 = time.perf_counter()
            lv = bt.calc_var_levels(tuple(rec_r["levels"]))
            t2 = time.perf_counter()
            trap_lv = bt.refine_seconds
            pf = bt.calc_var_portfolios(rows, obj_r)
            t3 = time.perf_counter()
            trap_pf = bt.refine_seconds
            row = bt.calc_var_grid(rows[1:], [obj_r])[0, 0]
            want_lv = rec_r[f"{est}_levels"]
            want_pf = rec_r[f"{est}_portfolios"]
            errs = {"levels": float(np.max(np.abs(lv - want_lv))),
                    "portfolios": float(np.max(np.abs(pf - want_pf))),
                    "grid_row": float(np.max(np.abs(row - want_pf[1])))}
            times = {"load_prep": t1 - t0, "levels": t2 - t1,
                     "levels_trap": trap_lv, "portfolios": t3 - t2,
                     "portfolios_trap": trap_pf}
            print(f"refine {dim_name} {est}: max |VaR - record| "
                  + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                  + f" (bound {ATOL_VAR:g}); wall s (host clock, {smi}): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
            for arr in (lv, pf, row):
                if not np.all(np.isfinite(arr)):
                    raise AssertionError(f"refine {dim_name} {est}: "
                                         "non-finite VaR")
            bad = {k: e for k, e in errs.items() if not e <= ATOL_VAR}
            if bad:
                raise AssertionError(f"refine {dim_name} {est}: off the "
                                     f"record {bad}")
            out_bts[est], out[est] = bt, {"max_err": errs, "wall_s": times}
        return out_bts, out

    refine_report = {}
    rec_r2 = np.load(os.path.join(root, "data", "flagship_refined_var.npz"))
    zero_counts()
    bts_r, refine_report["dim2"] = refined("flagship.csv",
                                           "flagship_artifacts", rec_r2,
                                           "dim2")
    launches_r2 = read_counts()
    print(f"refine dim2: launches {launches_r2}")
    if launches_r2["sweep_table"] != len(bts_r):
        raise AssertionError("sweep_table did not build one table per "
                             "refined dim-2 backtest")
    for name in ("masked_sweep", "bisect_levels"):
        if launches_r2[name] <= 0:
            raise AssertionError(f"{name} never launched on the refined "
                                 "dim-2 path")
    if launches_r2["masked_contract3"] or launches_r2["contract3_weights"]:
        raise AssertionError("a dim-3 kernel launched on the refined dim-2 "
                             "path")
    rec_r3 = np.load(os.path.join(root, "data", "dim3_refined_var.npz"))
    zero_counts()
    bts_r3, refine_report["dim3"] = refined("dim3.csv", "dim3_artifacts",
                                            rec_r3, "dim3", weights=w3)
    launches_r3 = read_counts()
    print(f"refine dim3: launches {launches_r3}")
    if launches_r3["contract3_weights"] != len(bts_r3):
        raise AssertionError("contract3_weights did not build one table per "
                             "refined dim-3 backtest")
    if launches_r3["masked_contract3"] <= 0:
        raise AssertionError("masked_contract3 never launched on the refined "
                             "dim-3 path")
    if launches_r3["masked_sweep"] or launches_r3["bisect_levels"] or \
            launches_r3["sweep_table"]:
        raise AssertionError("a dim-2 kernel launched on the refined dim-3 "
                             "path")
    refine_report["launches"] = {"dim2": launches_r2, "dim3": launches_r3}
    del bts_r, bts_r3
    torch.cuda.empty_cache()

    rec_q = np.load(os.path.join(root, "data", "flagship_quirk_fits.npz"))
    zero_counts()
    t0 = time.perf_counter()
    data_q = from_csv(os.path.join(root, "data", "flagship.csv"),
                      n_insample=int(rec_q["n_insample"]))
    bt_q = create_var_backtest(data_q, "garch", "student",
                               num_points=int(rec_q["num_points"]),
                               device="cuda", reference_quirks=True)
    bt_q.reference_quirks = True
    t1 = time.perf_counter()
    var_q = bt_q.calc_var(float(rec_q["obj_var"]))
    t2 = time.perf_counter()
    launches_q = read_counts()
    quirk_gaps = {}
    for i, f in enumerate(bt_q.model_fits):
        pq = (int(rec_q["garch_p"][i]), int(rec_q["garch_q"][i]))
        if (f.p, f.q) != pq:
            raise AssertionError(f"garch quirk fit {i}: (p, q) = "
                                 f"{(f.p, f.q)}, record {pq}")
        want = rec_q["garch_params"][i][:len(f.params)]
        quirk_gaps[f"garch params[{i}]"] = (
            float(np.max(np.abs(f.params - want) / np.abs(want))),
            QUIRK_RTOL_PARAMS)
        quirk_gaps[f"garch nll[{i}]"] = (
            abs(f.nll - rec_q["garch_nll"][i]) / abs(rec_q["garch_nll"][i]),
            QUIRK_RTOL_LL)
    quirk_gaps["rho"] = (float(abs(bt_q.copula_fit.packed_params[1]
                                   - rec_q["quirk_copula_packed"][1])),
                         FIT_ATOL_RHO)
    quirk_gaps["nu"] = (abs(bt_q.copula_fit.nu - float(rec_q[
        "quirk_copula_nu"])), FIT_ATOL_NU)
    t3 = time.perf_counter()
    mfits_q = model_fit_mod.fit_msm_batch(
        data_q.in_sample, int(rec_q["k"]), basin_iter=int(rec_q["basin_iter"]),
        reference_quirks=True, device="cuda")
    msm_q_s = time.perf_counter() - t3
    for i, f in enumerate(mfits_q):
        want = rec_q["msm_params"][i]
        got = np.array([f.m_0, f.b, f.gamma, f.sigma])
        quirk_gaps[f"msm params[{i}]"] = (
            float(np.max(np.abs(got - want) / np.abs(want))),
            QUIRK_RTOL_PARAMS)
        quirk_gaps[f"msm LL[{i}]"] = (
            abs(f.log_likelihood - rec_q["msm_ll"][i])
            / abs(rec_q["msm_ll"][i]), QUIRK_RTOL_LL)
    diff_q = np.abs(var_q - rec_q["garch_quirk_var"])
    times_q = dict(bt_q.prep_stages, csv_to_backtest=t1 - t0,
                   calc_var=t2 - t1, msm_quirk_fit=msm_q_s)
    print("quirk fits vs record: " + ", ".join(
        f"{k} {g:.2e} (bound {b:g})" for k, (g, b) in quirk_gaps.items())
        + f"; quirk pipeline max |VaR - record| = {diff_q.max():.3e} (bound "
        f"{ATOL_VAR:g}), launches {launches_q}")
    print(f"quirk wall s (host clock, {smi}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times_q.items()))
    bad = {k: v for k, v in quirk_gaps.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"quirk fits off the record: {bad}")
    if var_q.shape != diff_q.shape or not diff_q.max() <= ATOL_VAR:
        raise AssertionError(f"quirk pipeline: VaR off the record by "
                             f"{diff_q.max():.3e}")
    for name in ("sweep_table", "masked_sweep", "bisect_levels"):
        if launches_q[name] <= 0:
            raise AssertionError(f"{name} never launched on the quirk path")
    if launches_q["masked_contract3"] or launches_q["contract3_weights"]:
        raise AssertionError("a dim-3 kernel launched on the quirk path")
    del bt_q
    # the default fixture on the card; its pairs are the rows numpy's
    # argsort leaves last among 100000 tied copula values (the sampler's
    # docstring), so they equal the JAX-written copy's only where numpy
    # sorts ties alike; the card's density step is held to the copy on the
    # copy's own pairs either way
    t0 = time.perf_counter()
    marg_s, dens_s = generate_student_t_copula_data(device="cuda")
    sampler_s = time.perf_counter() - t0
    rec_m, rec_d = rec_q["student_marginals"], rec_q["student_densities"]
    err_s = float(np.max(np.abs(fixture_densities(rec_m, 5, device="cuda")
                                - rec_d) / np.abs(rec_d)))
    same_pairs = bool(np.array_equal(marg_s, rec_m))
    np.random.seed(42)
    draw = np.random.rand(100000, 2)
    ties = bool(np.all(t_copula_value(draw[:, 0], draw[:, 1], 0.5, 5)
                       == 1.0))
    drawn = {tuple(r) for r in draw}
    from_draw = all(tuple(r) in drawn for r in marg_s)
    print(f"student sampler on the card: {sampler_s:.3f} s, "
          f"{marg_s.shape[0]} pairs, equal to the JAX-written copy's "
          f"{same_pairs} (numpy {np.__version__}; all copula values tie "
          f"{ties}, every pair from the seeded draw {from_draw}); density "
          f"step on the copy's pairs max rel {err_s:.3e} (bound "
          f"{RTOL_SAMPLER:g})")
    if same_pairs:
        err_s = max(err_s, float(np.max(np.abs(dens_s - rec_d)
                                        / np.abs(rec_d))))
    if not (err_s <= RTOL_SAMPLER and marg_s.shape == rec_m.shape
            and np.all(np.isfinite(dens_s)) and from_draw
            and (same_pairs or ties)):
        raise AssertionError("student sampler off the JAX-written fixture")
    quirk_report = {"gaps": quirk_gaps, "var_max_err": float(diff_q.max()),
                    "wall_s": times_q, "launches": launches_q,
                    "sampler_s": sampler_s, "sampler_rel_err": err_s,
                    "sampler_pairs_equal_record": same_pairs}

    # -- four assets (dim 4): the plain transform-cached path, counted -------
    rec4 = np.load(os.path.join(root, "data", "dim4_var.npz"))
    w4 = np.asarray(rec4["weights"], np.float64)
    n_in4, obj4 = int(rec4["n_insample"]), float(rec4["obj_var"])
    days_w4, days_r4 = int(rec4["days_wide"]), int(rec4["days_refined"])
    n_wide4 = int(rec4["num_points_wide"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base4 = torch.cuda.memory_allocated()
    zero_counts()
    t_dim4 = time.perf_counter()
    data4 = from_csv(os.path.join(root, "data", "dim4.csv"),
                     n_insample=n_in4, weights=w4)

    def cut4(days):
        return from_returns(data4.returns[:n_in4 + days], data4.tickers,
                            n_in4, weights=w4)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    dim4_report, bts4 = {}, {}
    for est in ("msm", "garch"):
        bt, load_s = timed(lambda est=est: load_artifacts(os.path.join(
            root, "data", f"dim4_artifacts_{est}.npz"), data4, device="cuda"))
        ops4, ops_s = timed(bt.sweep_operands)
        if not isinstance(ops4, ColumnOperands):
            raise AssertionError(f"dim4 {est}: operands {type(ops4).__name__}")
        var, var_s = timed(lambda bt=bt: bt.calc_var(obj4))
        kw = {"model_fits_override": bt.model_fits,
              "copula_fit_override": bt.copula_fit, "device": "cuda"}
        if est == "msm":
            kw["k"] = int(rec4["k"])
        wide, wide_build_s = timed(lambda est=est, kw=kw: create_var_backtest(
            cut4(days_w4), est, "student", num_points=n_wide4, **kw))
        var90, var90_s = timed(lambda wide=wide: wide.calc_var(obj4))
        narrow = create_var_backtest(cut4(days_w4), est, "student",
                                     num_points=int(rec4["num_points"]),
                                     **kw)
        ptf, ptf_s = timed(lambda narrow=narrow: narrow.calc_var_portfolios(
            rec4["ptf_rows"], rec4["ptf_levels"]))
        refined = create_var_backtest(cut4(days_r4), est, "student",
                                      num_points=int(rec4["num_points"]),
                                      refine_root=True, **kw)
        ref, ref_s = timed(lambda refined=refined: refined.calc_var(obj4))
        got = {"var": var, "var90": var90, "ptf": ptf, "refined": ref}
        errs, above = {}, {}
        for k, a in got.items():
            want = rec4[f"{est}_{k}"]
            if a.shape != want.shape or not np.all(np.isfinite(a)):
                raise AssertionError(f"dim4 {est} {k}: bad VaR {a.shape}")
            d = np.abs(a - want)
            errs[k], above[k] = float(d.max()), int(np.sum(d > ATOL_VAR))
        rate, kup = coverage(est, bt, var, rec4)
        times = {"load": load_s, "sweep_operands": ops_s,
                 "calc_var_n32": var_s,
                 f"build_n{n_wide4}_{days_w4}d": wide_build_s,
                 f"calc_var_n{n_wide4}_{days_w4}d": var90_s,
                 f"portfolios_n32_{days_w4}d": ptf_s,
                 f"refined_n32_{days_r4}d": ref_s}
        print(f"dim4 {est}: max |VaR - record| "
              + ", ".join(f"{k} {e:.3e} ({above[k]} days above)"
                          for k, e in errs.items())
              + f" (bound {ATOL_VAR:g}); exception rate {rate:.4f}, Kupiec p "
              f"{kup:.4f}; wall s (host clock, {smi}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        bad = {k: e for k, e in errs.items() if not e <= ATOL_VAR}
        if bad:
            raise AssertionError(f"dim4 {est}: off the record {bad}")
        dim4_report[est] = {"max_err": errs, "wall_s": times,
                            "exception_rate": rate, "kupiec_p": kup}
        bts4[est] = bt
        if est == "msm":
            wide_msm = wide
        del wide, narrow, refined
    # one stage-1 sweep at the widest grid over all T days; each day is its
    # own chunk at n = 90, so its first days are the cut's bits
    bt_m = bts4["msm"]
    full90 = VaRBacktest(data4, bt_m.adapter, "student", bt_m.copula_fit,
                         bt_m.model_fits, bt_m.adapter.integration_inputs(
                             data4.rolling_windows(), bt_m.model_fits,
                             n_wide4, device="cuda"),
                         num_points=n_wide4, device="cuda")
    ops90, ops90_s = timed(full90.sweep_operands)
    T4 = ops90.days
    st90 = torch.stack([torch.full((T4,), -100.0, device=dev),
                        torch.full((T4,), -3.0, device=dev)],
                       -1).double()[None]
    w90 = full90.weights[None]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sweep90 = tcached_sweep(ops90, st90, w90)
    end.record()
    end.synchronize()
    sweep90_ms = start.elapsed_time(end)
    # the same sweep of the first days alone: on the same columns, bit for
    # bit (a day's chunk does not depend on the others); on the 16-day
    # backtest's own columns to the sweep's rounding (t_ppf iterates until
    # every lane of its batch has converged, so a 16-day batch's columns
    # may differ from the 500-day batch's in the last bit)
    head = st90[:, :days_w4].contiguous()
    sweep90_cut = tcached_sweep(ops90._replace(
        cols=tuple(c[:days_w4] for c in ops90.cols),
        forecast_combos=ops90.forecast_combos[:days_w4]), head, w90)
    if not torch.equal(sweep90[:, :days_w4], sweep90_cut):
        raise AssertionError("dim4: the full-T n = 90 sweep's first days "
                             "differ from the same sweep of those days")
    sweep90_wide = tcached_sweep(wide_msm.sweep_operands(), head, w90)
    e90 = float((sweep90[:, :days_w4] - sweep90_wide).abs().max())
    s90 = float(sweep90_wide.abs().max())
    if not (e90 <= RTOL_SWEEP * s90 and bool(torch.isfinite(sweep90).all())):
        raise AssertionError(f"dim4: the n = 90 sweep off the 16-day "
                             f"backtest's by {e90:.3e} (scale {s90:.3e})")
    del full90, ops90, wide_msm
    # the dim-4 Student fit on the card, from the artifact's model fits
    meta4 = json.loads(str(np.load(os.path.join(
        root, "data", "dim4_artifacts_garch.npz"))["meta"]))
    bt_f, fit4_s = timed(lambda: create_var_backtest(
        data4, "garch", "student", num_points=int(rec4["num_points"]),
        model_fits_override=bts4["garch"].model_fits, device="cuda"))
    var_f, var_f_s = timed(lambda: bt_f.calc_var(obj4))
    rho4 = np.asarray(meta4["copula_fit"]["packed_params"][1:])
    gaps4 = {"rho": (float(np.max(np.abs(bt_f.copula_fit.packed_params[1:]
                                         - rho4))), FIT_ATOL_RHO),
             "nu": (abs(bt_f.copula_fit.nu - meta4["copula_fit"]["nu"]),
                    FIT_ATOL_NU)}
    diff_f = np.abs(var_f - rec4["garch_var"])
    print(f"dim4 student fit on the card: fit vs artifact "
          + ", ".join(f"{k} {g:.2e} (bound {b:g})"
                      for k, (g, b) in gaps4.items())
          + f"; max |VaR - record| {diff_f.max():.3e}, days above 1e-9: "
          f"{int(np.sum(diff_f > ATOL_VAR))}; wall s (host clock, {smi}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in dict(
              bt_f.prep_stages, create_var_backtest=fit4_s,
              calc_var=var_f_s).items()))
    bad = {k: v for k, v in gaps4.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"dim4 student fit off the artifact: {bad}")
    if var_f.shape != diff_f.shape or not diff_f.max() <= ATOL_VAR:
        raise AssertionError(f"dim4 student fit: VaR off the record by "
                             f"{diff_f.max():.3e}")
    fit4_times = dict(bt_f.prep_stages, create_var_backtest=fit4_s,
                      calc_var=var_f_s)
    del bt_f
    launches4 = read_counts()
    torch.cuda.synchronize()
    peak4 = torch.cuda.max_memory_allocated()
    phase4_s = time.perf_counter() - t_dim4
    if any(launches4.values()):
        raise AssertionError(f"a kernel launched on the dim-4 path: "
                             f"{launches4}")
    # its torch.profiler reading (~19 000 device ops a call) is taken last,
    # after the kernels' own short traces (section "device time")
    bt4 = bts4["msm"]
    n4, q4 = bt4.integration_inputs.x.shape[0], \
        bt4.integration_inputs.densities.shape[1]
    bound4 = tcached_bound(T4, n_wide4, 4, q4, 1, True, False)
    bound4_32 = tcached_bound(T4, n4, 4, q4, 1, True, False)
    print(f"dim4 phase: {phase4_s:.3f} s, launches {launches4}; device memory "
          f"peak {peak4} bytes ({base4} before the phase); stage-1 sweep "
          f"n={n_wide4} over {T4} days {sweep90_ms:.3f} ms (CUDA events), "
          f"operands {ops90_s:.3f} s, first {days_w4} days bit-equal to "
          f"those days alone, {e90 / s90:.2e} rel off the {days_w4}-day "
          f"backtest's (bound {RTOL_SWEEP:g}); bound {bound4[0]:.3f} ms by "
          f"{bound4[1]} "
          f"({bound4[0] / sweep90_ms:.2%} of the sweep) ({smi})")
    dim4_report.update({
        "launches": launches4, "peak_device_bytes": peak4,
        "bytes_before_phase": base4, "phase_s": phase4_s,
        "sweep_n90_full_T_ms": sweep90_ms, "sweep_n90_operands_s": ops90_s,
        "sweep_n90_rel_err_cut_backtest": e90 / s90,
        "bound_sweep_n90_ms": bound4, "bound_sweep_n32_ms": bound4_32,
        "student_fit_gaps": gaps4,
        "student_fit_wall_s": fit4_times,
        "student_fit_var_max_err": float(diff_f.max())})
    del bts4
    torch.cuda.empty_cache()

    # -- day sharding (parallel/): a world of one NCCL rank, then gloo ranks
    # sharing the card, each rank on its block of days ----------------------
    w_batch3_s = np.random.default_rng(3).dirichlet([2.0, 2.0, 2.0],
                                                    size=ROWS_P3)
    sharded_report, one_card, one_card_peaks = day_sharded_phase(
        root, smi, w_batch, w_batch3_s)

    # -- grid sharding (parallel/): a (1, 1) grid mesh over one NCCL rank,
    # then gloo ranks sharing the card, each on its outer grid rows -------
    grid_report = grid_sharded_phase(root, smi, w_batch, w_batch3_s,
                                     one_card, one_card_peaks)

    # -- wide grids: dim 2 past K1's day through K2 sweeps, dim 3 past the
    # table through the rebuild kernel, and the minimal plugin, counted ----
    wide_report, wide_entry = wide_grid_phase(root, smi)

    # -- parity: kernels vs plain twins on the card ---------------------------
    def tens(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    wrows = tens([[0.5, 0.5], [0.3, 0.7], [0.75, 0.25], [0.9, 0.1]])
    obj = tens(LEVELS)
    err_sweep, err_root, err_p = 0.0, 0.0, 0.0
    states = {}
    for est, bt in bts.items():
        ops = bt.sweep_operands()
        T = ops.V.shape[0]
        p_p, f_p = cq.sweep_table_reference(ops)
        close = torch.isclose(ops.P, p_p, rtol=RTOL_TABLE, atol=1e-300,
                              equal_nan=True)
        if not (bool(close.all()) and torch.equal(ops.flags, f_p)):
            raise AssertionError(
                f"sweep_table {est}: {int((~close).sum())} cells, "
                f"{int((ops.flags != f_p).sum())} flags off the plain twin")
        fin = torch.isfinite(p_p)
        e_p = float((ops.P[fin] - p_p[fin]).abs().max())
        err_p = max(err_p, e_p)
        if not torch.equal(ops.P, cq.sweep_table(ops)[0]):
            raise AssertionError(f"sweep_table {est}: a rebuild changed P")
        del p_p, f_p, close, fin
        stage1 = np.stack([np.full(T, -100.0), np.full(T, -3.0)], -1)
        lo = rng.uniform(-8.0, -1.0, (3, T))
        rand = np.stack([lo, lo + rng.uniform(0.0, 3.0, (3, T))], -1)
        bounds = tens(np.concatenate([stage1[None], rand]))
        k = cq.masked_sweep(ops, bounds, wrows, -5.0)
        p = cq.masked_sweep_reference(ops, bounds, wrows, -5.0)
        scale = float(p.abs().max())
        e = float((k - p).abs().max())
        if not e <= RTOL_SWEEP * scale:
            raise AssertionError(f"masked_sweep {est}: |kernel - plain| {e:.3e}"
                                 f" > {RTOL_SWEEP:g} x {scale:.3e}")
        err_sweep = max(err_sweep, e)
        if not torch.equal(k, cq.masked_sweep(ops, bounds, wrows, -5.0)):
            raise AssertionError(f"masked_sweep {est}: a repeated launch "
                                 "changed the sweep")
        F1 = cq.masked_sweep(ops, bounds[:1].expand(4, T, 2).contiguous(),
                             wrows, -5.0)
        st = bracket_state_batched(
            F1, obj, lambda b: cq.masked_sweep(ops, b.contiguous(), wrows,
                                               -5.0), cfg, False)
        st = [s.contiguous() for s in st[:5]]
        states[est] = (ops, st)
        rk = cs.bisect_levels(ops, *st, obj, wrows, 1e-6)
        rp = cs.bisect_levels_reference(ops, *st, obj, wrows, 1e-6)
        e_r = float((rk - rp).abs().max())
        if not e_r <= ATOL_ROOT:
            raise AssertionError(f"bisect_levels {est}: |kernel - plain| "
                                 f"{e_r:.3e} > {ATOL_ROOT:g}")
        if not torch.equal(rk, cs.bisect_levels(ops, *st, obj, wrows, 1e-6)):
            raise AssertionError(f"bisect_levels {est}: a repeated launch "
                                 "changed the roots")
        err_root = max(err_root, e_r)
        print(f"parity {est} (q={ops.w1.shape[0]}): sweep_table max abs "
              f"{e_p:.3e} (bound rel {RTOL_TABLE:g} per cell), "
              f"{int(ops.flags.sum())} rows flagged; masked_sweep max abs "
              f"{e:.3e} rel {e / scale:.3e} (bound rel {RTOL_SWEEP:g}); "
              f"bisect_levels max abs {e_r:.3e} (bound {ATOL_ROOT:g})")
    ops_m = bts["msm"].sweep_operands()
    w_rows = np.repeat(w_batch, len(LEVELS), axis=0)
    a_rows = np.tile(levels, ROWS_P)
    # a 128-row sweep of random bounds: against the plain twin, and each
    # row's bits alone equal to its bits inside the batch
    T = ops_m.days
    lo = rng.uniform(-8.0, -1.0, (len(w_rows), T))
    b128 = tens(np.stack([lo, lo + rng.uniform(0.0, 3.0, lo.shape)], -1))
    wr128 = tens(w_rows)
    k = cq.masked_sweep(ops_m, b128, wr128, -5.0)
    p = cq.masked_sweep_reference(ops_m, b128, wr128, -5.0)
    scale = float(p.abs().max())
    e = float((k - p).abs().max())
    if not e <= RTOL_SWEEP * scale:
        raise AssertionError(f"masked_sweep L={len(w_rows)}: |kernel - "
                             f"plain| {e:.3e} > {RTOL_SWEEP:g} x {scale:.3e}")
    err_sweep = max(err_sweep, e)
    for l_ in (0, 1, 63, len(w_rows) - 1):
        alone = cq.masked_sweep(ops_m, b128[l_:l_ + 1].contiguous(),
                                wr128[l_:l_ + 1].contiguous(), -5.0)
        if not torch.equal(alone[0], k[l_]):
            raise AssertionError(f"masked_sweep: row {l_} alone differs "
                                 "from its bits in the batch")
    print(f"parity masked_sweep L={len(w_rows)}: max abs {e:.3e} rel "
          f"{e / scale:.3e} (bound rel {RTOL_SWEEP:g}); rows alone bit-equal "
          "to the batch")
    # ranges of outer grid rows (grid sharding): the GRID_RANKS ranges of
    # a (1, GRID_RANKS) mesh, P the whole table's rows bit for bit, each
    # range's sweep against its plain twin on its rows, a repeat the same
    # bits, the partials summed in rank order against the whole launch,
    # and the range of all rows the whole launch's bits
    grid_parity = {}
    for est, bt in bts.items():
        ops = bt.sweep_operands()
        n, T = ops.x.shape[0], ops.days
        lo = rng.uniform(-8.0, -1.0, (3, T))
        b_g = tens(np.concatenate([
            np.stack([np.full(T, -100.0), np.full(T, -3.0)], -1)[None],
            np.stack([lo, lo + rng.uniform(0.0, 3.0, (3, T))], -1)]))

        def range_ops(rows, ops=ops):
            return cq.sweep_operands(ops.V, ops.x, ops.dx, ops.densities,
                                     ops.forecast_combos, rows=rows)

        full = cq.masked_sweep(ops, b_g, wrows, -5.0)
        scale = float(full.abs().max())
        parts, e_k = [], 0.0
        for k_ in range(GRID_RANKS):
            rows = (k_ * n // GRID_RANKS, (k_ + 1) * n // GRID_RANKS)
            ops_r = range_ops(rows)
            if not (torch.equal(ops_r.P, ops.P[:, rows[0]:rows[1]]) and
                    torch.equal(ops_r.flags, ops.flags[:, rows[0]:rows[1]])):
                raise AssertionError(f"sweep_table {est} rows {rows}: not "
                                     "the whole table's rows")
            k = cq.masked_sweep(ops_r, b_g, wrows, -5.0)
            p = cq.masked_sweep_reference(ops_r, b_g, wrows, -5.0)
            e = float((k - p).abs().max())
            if not e <= RTOL_SWEEP * scale:
                raise AssertionError(f"masked_sweep {est} rows {rows}: "
                                     f"|kernel - plain| {e:.3e}")
            if not torch.equal(k, cq.masked_sweep(ops_r, b_g, wrows, -5.0)):
                raise AssertionError(f"masked_sweep {est} rows {rows}: a "
                                     "repeated launch changed the sweep")
            parts.append(k)
            e_k = max(e_k, e)
        summed = parts[0]
        for part in parts[1:]:
            summed = summed + part
        e_sum = float((summed - full).abs().max())
        if not e_sum <= RTOL_PARTS * scale:
            raise AssertionError(f"masked_sweep {est}: the ranges' partials "
                                 f"off the whole launch by {e_sum:.3e}")
        if not torch.equal(cq.masked_sweep(range_ops((0, n)), b_g, wrows,
                                           -5.0), full):
            raise AssertionError(f"masked_sweep {est}: rows (0, {n}) differ "
                                 "from the whole launch")
        grid_parity[f"masked_sweep/{est}"] = {"max_abs_err": e_k,
                                              "partials_sum_err": e_sum}
        err_sweep = max(err_sweep, e_k)
        print(f"parity masked_sweep {est} on {GRID_RANKS} row ranges of "
              f"{n}: P the table's rows bit for bit; max abs vs plain "
              f"{e_k:.3e} (bound rel {RTOL_SWEEP:g}); partials summed vs "
              f"the whole launch {e_sum:.3e} rel {e_sum / scale:.3e} (bound "
              f"rel {RTOL_PARTS:g}); rows (0, {n}) bit-equal; repeats "
              "bit-equal")
    ops_r25 = cq.sweep_operands(ops_m.V, ops_m.x, ops_m.dx, ops_m.densities,
                                ops_m.forecast_combos,
                                rows=(0, ops_m.x.shape[0] // GRID_RANKS))
    r_plain, nd_plain = cs.full_solve_portfolios_reference(
        ops_m, tens(a_rows), tens(w_rows), cfg)
    ptf_means = np.asarray(bts["msm"].data.in_sample_mean) @ w_rows.T
    plain = np.where(nd_plain.cpu().numpy(), np.nan,
                     r_plain.cpu().numpy()) + ptf_means[:, None]
    e_grid = float(np.max(np.abs(grid.reshape(ROWS_P * len(LEVELS), -1) - plain)))
    if not e_grid <= ATOL_ROOT:
        raise AssertionError(f"serving batch: kernel vs plain {e_grid:.3e}")
    print(f"parity serving batch {ROWS_P * len(LEVELS)} rows: max abs {e_grid:.3e}"
          f" (bound {ATOL_ROOT:g})")

    # K4 at full width: MSM (q = 5) and GARCH (q = 1), the fitted Student
    # copula and a Gaussian one on the MSM artifact's fitted correlation
    T3 = bts3["msm"].sweep_operands().days
    w3rows = tens(np.concatenate([w3[None], rng.dirichlet([2.0] * 3, 3)]))
    stage1 = np.stack([np.full(T3, -100.0), np.full(T3, -3.0)], -1)
    lo = rng.uniform(-6.0, -0.5, (3, T3))
    bounds3 = tens(np.concatenate([
        stage1[None], np.stack([lo, lo + rng.uniform(0.0, 3.0, (3, T3))], -1)
    ]))
    gauss = CopulaSpec("gaussian", (bts3["msm"].copula_spec.params[1],))
    err3, err_u = 0.0, 0.0
    days = slice(0, TABLE_DAYS)
    for est, bt in bts3.items():
        inputs = bt.integration_inputs
        cols = bt.adapter.day_columns(inputs, gauss)
        for copula, ops3 in (
                ("student", bt.sweep_operands()),
                ("gaussian", bt.adapter.contract3_operands(cols, inputs,
                                                           gauss))):
            n3 = ops3.x.shape[0]
            u_k = cq3.table_cells(ops3.U[days], n3)
            u_p = cq3.contract3_weights_reference(ops3, days)
            close = torch.isclose(u_k, u_p, rtol=RTOL_TABLE, atol=1e-300,
                                  equal_nan=True)
            fin = torch.isfinite(u_p)
            e_u = float((u_k[fin] - u_p[fin]).abs().max())
            if not bool(close.all()):
                raise AssertionError(
                    f"contract3_weights {est} {copula}: "
                    f"{int((~close).sum())} cells off the plain twin")
            if not bool((cq3.table_pads(ops3.U, n3) == 0).all()):
                raise AssertionError("contract3_weights: pad cells not 0")
            err_u = max(err_u, e_u)
            del u_k, u_p, close, fin
            k = cq3.masked_contract3(ops3, bounds3, w3rows, -5.0)
            p = cq3.masked_contract3_reference(ops3, bounds3, w3rows, -5.0)
            scale = float(p.abs().max())
            e = float((k - p).abs().max())
            if not (e <= RTOL_SWEEP * scale and bool(torch.isfinite(k).all())):
                raise AssertionError(
                    f"masked_contract3 {est} {copula}: |kernel - plain| "
                    f"{e:.3e} > {RTOL_SWEEP:g} x {scale:.3e}")
            err3 = max(err3, e)
            if not torch.equal(k, cq3.masked_contract3(ops3, bounds3, w3rows,
                                                       -5.0)):
                raise AssertionError(f"masked_contract3 {est} {copula}: a "
                                     "repeated launch changed the sweep")
            print(f"parity dim3 {est} {copula} (q={ops3.w1.shape[0]}): "
                  f"contract3_weights on {TABLE_DAYS} days max abs {e_u:.3e}"
                  f" (bound rel {RTOL_TABLE:g} per cell); masked_contract3 "
                  f"max abs {e:.3e} rel {e / scale:.3e} (bound rel "
                  f"{RTOL_SWEEP:g}); repeats bit-equal")
            del ops3
    for est, bt in bts3.items():
        ops3 = bt.sweep_operands()
        n3 = ops3.x.shape[0]

        def range_ops3(rows, ops3=ops3):
            return cq3.contract3_operands(
                ops3.cols, ops3.x, ops3.dx, ops3.spec, ops3.densities,
                ops3.forecast_combos, ops3.p_cols, rows=rows)

        full = cq3.masked_contract3(ops3, bounds3, w3rows, -5.0)
        scale = float(full.abs().max())
        parts, e_k, e_u3 = [], 0.0, 0.0
        for k_ in range(GRID_RANKS):
            rows = (k_ * n3 // GRID_RANKS, (k_ + 1) * n3 // GRID_RANKS)
            ops_r = range_ops3(rows)
            if not torch.equal(ops_r.U, ops3.U[:, rows[0]:rows[1]]):
                raise AssertionError(f"contract3_weights {est} rows {rows}: "
                                     "not the whole table's slabs")
            u_k = cq3.table_cells(ops_r.U[days], n3)
            u_p = cq3.contract3_weights_reference(ops_r, days)
            fin = torch.isfinite(u_p)
            if not bool(torch.isclose(u_k, u_p, rtol=RTOL_TABLE, atol=1e-300,
                                      equal_nan=True).all()):
                raise AssertionError(f"contract3_weights {est} rows {rows}: "
                                     "cells off the plain twin")
            e_u3 = max(e_u3, float((u_k[fin] - u_p[fin]).abs().max()))
            del u_k, u_p, fin
            k = cq3.masked_contract3(ops_r, bounds3, w3rows, -5.0)
            p = cq3.masked_contract3_reference(ops_r, bounds3, w3rows, -5.0)
            e = float((k - p).abs().max())
            if not e <= RTOL_SWEEP * scale:
                raise AssertionError(f"masked_contract3 {est} rows {rows}: "
                                     f"|kernel - plain| {e:.3e}")
            if not torch.equal(k, cq3.masked_contract3(ops_r, bounds3,
                                                       w3rows, -5.0)):
                raise AssertionError(f"masked_contract3 {est} rows {rows}: a"
                                     " repeated launch changed the sweep")
            parts.append(k)
            e_k = max(e_k, e)
            del ops_r
            torch.cuda.empty_cache()
        summed = parts[0]
        for part in parts[1:]:
            summed = summed + part
        e_sum = float((summed - full).abs().max())
        if not e_sum <= RTOL_PARTS * scale:
            raise AssertionError(f"masked_contract3 {est}: the ranges' "
                                 f"partials off the whole launch by "
                                 f"{e_sum:.3e}")
        ops_all = range_ops3((0, n3))
        if not (torch.equal(ops_all.U, ops3.U) and torch.equal(
                cq3.masked_contract3(ops_all, bounds3, w3rows, -5.0), full)):
            raise AssertionError(f"masked_contract3 {est}: rows (0, {n3}) "
                                 "differ from the whole launch")
        del ops_all
        torch.cuda.empty_cache()
        grid_parity[f"masked_contract3/{est}"] = {"max_abs_err": e_k,
                                                  "partials_sum_err": e_sum,
                                                  "table_max_abs_err": e_u3}
        err3, err_u = max(err3, e_k), max(err_u, e_u3)
        print(f"parity dim3 {est} on {GRID_RANKS} slab ranges of {n3}: U "
              f"the table's slabs bit for bit, its cells on {TABLE_DAYS} "
              f"days max abs {e_u3:.3e} vs plain; masked_contract3 max abs "
              f"vs plain {e_k:.3e} (bound rel {RTOL_SWEEP:g}); partials "
              f"summed vs the whole launch {e_sum:.3e} rel "
              f"{e_sum / scale:.3e} (bound rel {RTOL_PARTS:g}); rows (0, "
              f"{n3}) bit-equal; repeats bit-equal")
    u_first = bts3["msm"].sweep_operands().U
    if not torch.equal(u_first, cq3.contract3_weights(
            bts3["msm"].sweep_operands())):
        raise AssertionError("contract3_weights: a rebuild changed U")
    rng3 = np.random.default_rng(3)
    w_batch3 = rng3.dirichlet([2.0, 2.0, 2.0], size=ROWS_P3)
    t0 = time.perf_counter()
    grid3 = bts3["msm"].calc_var_grid(w_batch3, levels)
    grid3_s = time.perf_counter() - t0
    if grid3.shape != (ROWS_P3, len(LEVELS), T3) or \
            not np.all(np.isfinite(grid3)):
        raise AssertionError(f"dim3 calc_var_grid: bad output {grid3.shape}")
    ops3_m = bts3["msm"].sweep_operands()
    w_rows3 = np.repeat(w_batch3, len(LEVELS), axis=0)
    a_rows3 = np.tile(levels, ROWS_P3)
    t0 = time.perf_counter()
    r_plain3, nd_plain3 = cs.full_solve_portfolios_reference(
        ops3_m, tens(a_rows3), tens(w_rows3), cfg)
    grid3_plain_s = time.perf_counter() - t0
    ptf_means3 = np.asarray(bts3["msm"].data.in_sample_mean) @ w_rows3.T
    plain3 = np.where(nd_plain3.cpu().numpy(), np.nan,
                      r_plain3.cpu().numpy()) + ptf_means3[:, None]
    e_grid3 = float(np.max(np.abs(grid3.reshape(len(w_rows3), -1) - plain3)))
    if not e_grid3 <= ATOL_ROOT:
        raise AssertionError(f"dim3 serving batch: kernel vs plain "
                             f"{e_grid3:.3e}")
    print(f"parity dim3 serving batch {len(w_rows3)} rows: max abs "
          f"{e_grid3:.3e} (bound {ATOL_ROOT:g}); kernel {grid3_s:.3f} s, "
          f"plain {grid3_plain_s:.3f} s (host clock)")

    # -- timings on the card --------------------------------------------------
    timing = {}
    for est, bt in bts.items():  # day-tensor prep is plain PyTorch
        timing[f"prep_{est}"] = cuda_ms(torch, {
            "plain": lambda bt=bt: bt.adapter.day_tensors(
                bt.integration_inputs, bt.copula_spec)})
    timing["sweep_table"] = cuda_ms(torch, {
        "kernel": lambda: cq.sweep_table(ops_m),
        "plain": lambda: cq.sweep_table_reference(ops_m)})
    st1 = torch.stack([torch.full((T,), -100.0, device=dev),
                       torch.full((T,), -3.0, device=dev)], -1).double()
    for L in (1, ROWS_P * len(LEVELS)):
        b = st1.expand(L, T, 2).contiguous()
        w = tens(w_rows[:L]) if L > 1 else wrows[:1].contiguous()
        timing[f"sweep_L{L}"] = cuda_ms(torch, {
            "kernel": lambda b=b, w=w: cq.masked_sweep(ops_m, b, w, -5.0),
            "plain": lambda b=b, w=w: cq.masked_sweep_reference(ops_m, b, w,
                                                                -5.0)})
    # one grid rank's launch: its n / GRID_RANKS outer rows
    r25 = ops_r25.V.shape[1]
    b1, w1_ = st1[None].contiguous(), wrows[:1].contiguous()
    timing[f"sweep_rows{r25}_L1"] = cuda_ms(torch, {
        "kernel": lambda: cq.masked_sweep(ops_r25, b1, w1_, -5.0),
        "plain": lambda: cq.masked_sweep_reference(ops_r25, b1, w1_, -5.0)})
    ops_b, st_b = states["msm"]
    s1 = [s[:1].contiguous() for s in st_b]
    timing["bisect_L1"] = cuda_ms(torch, {
        "kernel": lambda: cs.bisect_levels(ops_b, *s1, obj[:1], wrows[:1],
                                           1e-6),
        "plain": lambda: cs.bisect_levels_reference(ops_b, *s1, obj[:1],
                                                    wrows[:1], 1e-6)})
    L128 = ROWS_P * len(LEVELS)
    wr, ar = tens(w_rows), tens(a_rows)
    F1_128 = cq.masked_sweep(ops_m, st1.expand(L128, T, 2).contiguous(), wr,
                             -5.0)
    st128 = [s.contiguous() for s in bracket_state_batched(
        F1_128, ar, lambda b: cq.masked_sweep(ops_m, b.contiguous(), wr,
                                              -5.0), cfg, False)[:5]]
    r128 = cs.bisect_levels(ops_m, *st128, ar, wr, 1e-6)
    e128 = float((r128 - cs.bisect_levels_reference(
        ops_m, *st128, ar, wr, 1e-6)).abs().max())
    if not e128 <= ATOL_ROOT:
        raise AssertionError(f"bisect_levels L={L128}: |kernel - plain| "
                             f"{e128:.3e}")
    err_root = max(err_root, e128)
    print(f"parity bisect_levels L={L128}: max abs {e128:.3e} (bound "
          f"{ATOL_ROOT:g})")
    timing[f"bisect_L{L128}"] = cuda_ms(torch, {
        "kernel": lambda: cs.bisect_levels(ops_m, *st128, ar, wr, 1e-6),
        "plain": lambda: cs.bisect_levels_reference(ops_m, *st128, ar, wr,
                                                    1e-6)}, reps=3, warmup=1)
    w_main = bts["msm"].weights
    timing["full_L1"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve_levels(ops_m, obj[2:3], w_main, cfg),
        "plain": lambda: cs.full_solve_levels_reference(ops_m, obj[2:3],
                                                        w_main, cfg)})
    timing[f"full_rows{ROWS_P * len(LEVELS)}"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve_portfolios(ops_m, ar, wr, cfg),
        "plain": lambda: cs.full_solve_portfolios_reference(ops_m, ar, wr,
                                                            cfg)},
        reps=3, warmup=1)
    # dim 3: K4 per sweep, the whole calc_var, and the column prep
    for est, bt in bts3.items():  # t_ppf etc. on 3 n T values: plain PyTorch
        timing[f"dim3_prep_{est}"] = cuda_ms(torch, {
            "plain": lambda bt=bt: bt.adapter.day_columns(
                bt.integration_inputs, bt.copula_spec)}, reps=2, warmup=0)
    timing["contract3_weights"] = cuda_ms(torch, {
        "kernel": lambda: cq3.contract3_weights(ops3_m),
        "plain": lambda: cq3.contract3_weights_reference(ops3_m)},
        reps=REPS_DIM3_PLAIN, warmup=1)
    st3 = tens(stage1)
    for L in (1, ROWS_P3 * len(LEVELS)):
        b = st3.expand(L, T3, 2).contiguous()
        w = tens(w_rows3[:L]) if L > 1 else tens(w3[None])
        timing[f"contract3_L{L}"] = cuda_ms(torch, {
            "kernel": lambda b=b, w=w: cq3.masked_contract3(ops3_m, b, w,
                                                            -5.0),
            "plain": lambda b=b, w=w: cq3.masked_contract3_reference(
                ops3_m, b, w, -5.0)}, reps=REPS_DIM3_PLAIN, warmup=1)
    ops3_r25 = cq3.contract3_operands(
        ops3_m.cols, ops3_m.x, ops3_m.dx, ops3_m.spec, ops3_m.densities,
        ops3_m.forecast_combos, ops3_m.p_cols,
        rows=(0, ops3_m.x.shape[0] // GRID_RANKS))
    r3_25 = ops3_r25.n_rows
    b3_1, w3_1 = st3[None].contiguous(), tens(w3[None])
    timing[f"contract3_rows{r3_25}_L1"] = cuda_ms(torch, {
        "kernel": lambda: cq3.masked_contract3(ops3_r25, b3_1, w3_1, -5.0),
        "plain": lambda: cq3.masked_contract3_reference(ops3_r25, b3_1, w3_1,
                                                        -5.0)},
        reps=REPS_DIM3_PLAIN, warmup=1)
    w3_main = bts3["msm"].weights
    timing["dim3_full_L1"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve_levels(ops3_m, obj[2:3], w3_main,
                                               cfg),
        "plain": lambda: cs.full_solve_levels_reference(
            ops3_m, obj[2:3], w3_main, cfg)}, reps=REPS_DIM3_PLAIN, warmup=1)
    # the refine_root trap pass per call (plain PyTorch), beside the
    # unrefined solve of the same rows above (full_L1, full_rows128,
    # dim3_full_L1)
    roots1, _ = cs.full_solve_levels(ops_m, obj[2:3], w_main, cfg)
    roots128, _ = cs.full_solve_portfolios(ops_m, ar, wr, cfg)
    roots3, _ = cs.full_solve_levels(ops3_m, obj[2:3], w3_main, cfg)
    h1 = tens([bts["msm"]._plateau_h()])
    h128 = tens(bts["msm"]._plateau_h(w_rows))
    h3 = tens([bts3["msm"]._plateau_h()])
    trap_calls = {
        "trap_L1": lambda: refine_roots(ops_m, roots1, obj[2:3],
                                        w_main.expand(1, -1), h1),
        f"trap_L{L128}": lambda: refine_roots(ops_m, roots128, ar, wr, h128),
        "dim3_trap_L1": lambda: refine_roots(ops3_m, roots3, obj[2:3],
                                             w3_main.expand(1, -1), h3),
    }
    for key, fn in trap_calls.items():
        timing[key] = cuda_ms(torch, {"plain": fn},
                              **({} if key == "trap_L1"
                                 else {"reps": 3, "warmup": 1}))
    for name, res in timing.items():
        print(f"time {name}: " + ", ".join(
            f"{k} median {v[0]:.3f} ms min {v[1]:.3f} ms"
            for k, v in res.items()))

    # -- device time inside those calls (torch.profiler) ----------------------
    profiles = {
        "sweep_table": device_profile(torch, lambda: cq.sweep_table(ops_m)),
        "sweep_L1": device_profile(torch, lambda: cq.masked_sweep(
            ops_m, st1[None].contiguous(), wrows[:1].contiguous(), -5.0)),
        "bisect_L1": device_profile(torch, lambda: cs.bisect_levels(
            ops_b, *s1, obj[:1], wrows[:1], 1e-6)),
        f"bisect_L{L128}": device_profile(torch, lambda: cs.bisect_levels(
            ops_m, *st128, ar, wr, 1e-6)),
        "calc_var_msm": device_profile(torch, lambda: bts["msm"].calc_var(alpha)),
        "calc_var_garch": device_profile(
            torch, lambda: bts["garch"].calc_var(alpha)),
        "grid_32x4": device_profile(
            torch, lambda: bts["msm"].calc_var_grid(w_batch, levels)),
        "contract3_L1": device_profile(torch, lambda: cq3.masked_contract3(
            ops3_m, st3[None].contiguous(), tens(w3[None]), -5.0)),
        f"sweep_rows{r25}_L1": device_profile(
            torch, lambda: cq.masked_sweep(ops_r25, b1, w1_, -5.0)),
        f"contract3_rows{r3_25}_L1": device_profile(
            torch, lambda: cq3.masked_contract3(ops3_r25, b3_1, w3_1, -5.0)),
        "contract3_weights": device_profile(
            torch, lambda: cq3.contract3_weights(ops3_m), reps=2),
        "dim3_calc_var_msm": device_profile(
            torch, lambda: bts3["msm"].calc_var(alpha), reps=3),
        "dim3_calc_var_garch": device_profile(
            torch, lambda: bts3["garch"].calc_var(alpha), reps=3),
        "dim3_grid_8x4": device_profile(
            torch, lambda: bts3["msm"].calc_var_grid(w_batch3, levels),
            reps=2),
        "full_L1": device_profile(torch, lambda: cs.full_solve_levels(
            ops_m, obj[2:3], w_main, cfg)),
        f"full_rows{L128}": device_profile(
            torch, lambda: cs.full_solve_portfolios(ops_m, ar, wr, cfg),
            reps=3),
        "dim3_full_L1": device_profile(torch, lambda: cs.full_solve_levels(
            ops3_m, obj[2:3], w3_main, cfg), reps=3),
        **{k: device_profile(torch, fn, reps=10 if k == "trap_L1" else 2)
           for k, fn in trap_calls.items()},
        "dim4_calc_var_msm": device_profile(
            torch, lambda: bt4.calc_var(obj4), reps=1),
    }
    prof4 = profiles["dim4_calc_var_msm"]
    busy4 = prof4["busy_ms"]
    print(f"dim4 profile calc_var n={n4} MSM: host {prof4['wall_ms']:.3f} "
          f"ms/call, device busy {_ms(busy4)} ms/call ("
          + _ms(None if busy4 is None else busy4 / prof4["wall_ms"], ".1%")
          + f"), {_ms(prof4['device_ops'], 'g')} device ops per call; one "
          f"n={n4} sweep's "
          f"bound {bound4_32[0]:.4f} ms by {bound4_32[1]} ({smi})")
    for name, p in profiles.items():
        print(f"profile {name}: host {p['wall_ms']:.3f} ms/call, device busy "
              f"{_ms(p['busy_ms'])} ms/call, {_ms(p['device_ops'], 'g')} "
              f"device ops per call ({p['pad_lost']} of {PROFILE_PAD} pad "
              f"kernels dropped by the trace, session {p['attempts']} of "
              f"{PROFILE_ATTEMPTS}); " + ", ".join(
                  f"{k} {v['launches']:g} launches x "
                  + ("not measured" if v["device_ms"] is None
                     else f"{v['device_ms']:.4f} ms")
                  for k, v in p["kernels"].items() if v["launches"]))
    report = {
        "card": smi, "reps": REPS, "build_s": _build.build_seconds,
        "day_tensor_bytes": int(ops_m.V.numel() * 8),
        "sweep_table_bytes": int(ops_m.P.numel() * 8 + ops_m.flags.numel()),
        "host_prep_s": prep_s, "host_calc_var_s": solve_s,
        "host_grid_s": grid_s, "dim3_host_prep_s": prep3_s,
        "dim3_host_calc_var_s": solve3_s, "dim3_host_grid_s": grid3_s,
        "dim3_host_grid_plain_s": grid3_plain_s,
        "dim3_peak_device_bytes": peak3, "dim3_bytes_before_path": base3,
        "dim3_table_bytes": int(ops3_m.U.numel() * 8),
        "launches_dim2": launches, "launches_dim3": launches3,
        "launches_fit_path": launches_fit, "fit_path": fit_report,
        "mean_reverting": {
            "served_var_max_err": err_mr, "host_prep_s": prep_mr,
            "host_calc_var_s": solve_mr, "run_backtest_wall_s": times_mr,
            "fit_gaps": gaps_mr, "var_max_err": float(diff_mr.max()),
            "launches": launches_mr},
        "synthetic": {"seconds": syn_s, "tickers": syn.tickers,
                      "sample_variances": syn_var.tolist()},
        "dim3_fit_path": fit3_report, "launches_dim3_fit_path": launches_fit3,
        "timing_ms": timing, "profile": profiles,
    }

    # bounds from this run's shapes (see the module docstring)
    n, q = ops_m.x.shape[0], ops_m.w1.shape[0]
    T3, n3, q3 = ops3_m.days, ops3_m.x.shape[0], ops3_m.w1.shape[0]
    iters = {L_: cs.halvings(float((st_[1] - st_[0]).max()), 1e-6)
             for L_, st_ in ((1, s1), (L128, st128))}
    L3 = ROWS_P3 * len(LEVELS)
    bounds_ms = {
        "sweep_table": table_bound(T, n, q),
        "sweep_L1": sweep_bound(T, n, q, 1),
        f"sweep_L{L128}": sweep_bound(T, n, q, L128),
        "bisect_L1": bisect_bound(T, n, q, 1, iters[1]),
        f"bisect_L{L128}": bisect_bound(T, n, q, L128, iters[L128]),
        "contract3_weights": weights_bound(
            T3, n3, q3, ops3_m.spec.kind == "student",
            ops3_m.p_cols is not None),
        "contract3_L1": contract3_bound(T3, n3, 1),
        f"contract3_L{L3}": contract3_bound(T3, n3, L3),
        f"sweep_rows{r25}_L1": sweep_bound(T, n, q, 1, rows=r25),
        f"contract3_rows{r3_25}_L1": contract3_bound(T3, n3, 1, rows=r3_25),
    }
    # the profile holding each shape's kernel at that L (the serving
    # batches' sweeps run at L = 128 and 32)
    prof_key = {"sweep_table": ("sweep_table", "sweep_table"),
                "sweep_L1": ("sweep_L1", "masked_sweep"),
                f"sweep_L{L128}": ("grid_32x4", "masked_sweep"),
                "bisect_L1": ("bisect_L1", "bisect_levels"),
                f"bisect_L{L128}": (f"bisect_L{L128}", "bisect_levels"),
                "contract3_weights": ("contract3_weights",
                                      "contract3_weights"),
                "contract3_L1": ("contract3_L1", "masked_contract3"),
                f"contract3_L{L3}": ("dim3_grid_8x4", "masked_contract3"),
                f"sweep_rows{r25}_L1": (f"sweep_rows{r25}_L1",
                                        "masked_sweep"),
                f"contract3_rows{r3_25}_L1": (f"contract3_rows{r3_25}_L1",
                                              "masked_contract3")}
    for key, (b_ms, by) in bounds_ms.items():
        prof, kern = prof_key[key]
        dev_ms = profiles[prof]["kernels"][kern]["device_ms"]
        print(f"bound {key}: {b_ms:.4f} ms by {by}; kernel call "
              f"{timing[key]['kernel'][0]:.3f} ms, device "
              + ("not measured (no trace of the kernel)" if dev_ms is None
                 else f"{dev_ms:.4f} ms, {b_ms / dev_ms:.1%} of the bound"))
    trap_bounds = {
        "trap_L1": trap_bound(T, n, q, 1, 2, False, True, TRAP_HALVINGS),
        f"trap_L{L128}": trap_bound(T, n, q, L128, 2, False, True,
                                    TRAP_HALVINGS),
        "dim3_trap_L1": trap_bound(T3, n3, q3, 1, 3, False,
                                   ops3_m.spec.kind == "student",
                                   TRAP_HALVINGS),
    }
    unrefined = {"trap_L1": "full_L1", f"trap_L{L128}": f"full_rows{L128}",
                 "dim3_trap_L1": "dim3_full_L1"}
    for key, (b_ms, by) in trap_bounds.items():
        pr, base = profiles[key], profiles[unrefined[key]]
        print(f"refine {key}: trap pass call {timing[key]['plain'][0]:.3f} "
              f"ms, device busy {_ms(pr['busy_ms'])} ms, "
              f"{_ms(pr['device_ops'], 'g')} device ops per call; bound "
              f"{b_ms:.4f} ms by {by} ("
              + (f"{b_ms / pr['busy_ms']:.1%}" if pr["busy_ms"] else
                 "not measured")
              + " of the busy time); the unrefined solve "
              f"{timing[unrefined[key]]['kernel'][0]:.3f} ms, device busy "
              f"{_ms(base['busy_ms'])} ms ({smi})")
    bounds_ms.update(trap_bounds)
    report["bounds_ms"] = bounds_ms
    report["refine"] = refine_report
    report["quirks"] = quirk_report
    report["dim4"] = dim4_report
    report["day_sharded"] = sharded_report
    report["grid_sharded"] = grid_report
    report["grid_parity"] = grid_parity
    report["wide_grid"] = wide_report
    report["halvings"] = iters
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print("report " + json.dumps(report))

    # launches of each kernel per rank on the grid-sharded path (rank 0 of
    # phase 11 (b), every path)
    grid_launches = {}
    for c in grid_report["gloo_world"]["ranks"][0]["1x4"]["launches"].values():
        for k_, v in c.items():
            grid_launches[k_] = grid_launches.get(k_, 0) + v

    def entry(name, source, replaces, launches_, err, key):
        b = bounds_ms[key]
        return {"name": name, "route": "cuda",
                "source": f"copula_var_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": timing[key]["kernel"][0],
                "plain_ms": timing[key]["plain"][0], "bound_ms": b[0],
                "bound_by": b[1], "library_ms": None,
                "grid_launches_per_rank": grid_launches[name]}

    k4 = "copula_var_tpu/ops/pallas_quadrature3.py:92"
    k23 = "copula_var_tpu/ops/pallas_quadrature.py"
    kernels = [
        entry("sweep_table", "quadrature.cu", f"{k23}:101; {k23}:32",
              launches["sweep_table"], err_p, "sweep_table"),
        entry("masked_sweep", "quadrature.cu",
              "copula_var_tpu/ops/pallas_quadrature.py:101",
              launches["masked_sweep"], err_sweep, "sweep_L1"),
        entry("bisect_levels", "quadrature.cu",
              "copula_var_tpu/ops/pallas_solver.py:93",
              launches["bisect_levels"], err_root, "bisect_L1"),
        entry("contract3_weights", "contract3.cu", k4,
              launches3["contract3_weights"], err_u, "contract3_weights"),
        entry("masked_contract3", "contract3.cu", k4,
              launches3["masked_contract3"], err3, "contract3_L1"),
        # its launches: the wide-grid phase's dim-3 series (the only path
        # that takes the rebuild route); its times: the full-T n = 300
        # sweep
        dict({"name": "masked_contract3_rebuild", "route": "cuda",
              "source": "copula_var_tpu_torch/csrc/contract3.cu",
              "replaces": k4, "library_ms": None,
              "grid_launches_per_rank":
                  grid_launches["masked_contract3_rebuild"]}, **wide_entry),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
