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
     must have launched and the other paths' kernels must not. Phase 5's
     `run_backtest` fit (`mr_fit_phase`) and phase 7 (`dim3_fit_phase`)
     each run in a spawned child process, counted there, from the end of
     the build on, and are joined where they stand: the fits are
     launch-bound host work, so they overlap phases 3-6 on other cores
     (their host-clock stage times then include that sharing);
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
     K4 on the dim-3 path (and nothing on dim 4), no f32 kernel on
     these f64 paths. The same ranks then serve the dim-2 and dim-3
     paths on the f32 engine (`bt.engine = "pallas"` on the `DayMesh`,
     JAX's "sharded_pallas"; flagship MSM and GARCH calc_var(0.05), the
     32 x 4 grid and the refined levels; dim-3 MSM and GARCH
     calc_var(0.05) and the 8 x 4 grid), counted with the f32 and f64
     counters, held in phase 16; and a 4-day flagship MSM cut on the f32
     engine (rank 2's block empty), bit-equal on every rank to rank 0's
     cut on one card with no mesh. Prints each rank's day block,
     launches, peak device memory (U split three ways) and wall seconds;
     the ranks share one card, so no figure here is a scaling figure;
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
     table, no table sweep, one flag table: `contract3_row_flags`); the
     route and the K1 / K2 / K4-table / K4-rebuild / flag launches
     printed per series; each dim-2 series' table P
     and K2 sweeps (the long-row form at n = 200 and 400) held to their
     plain twins on that series' operands (P rtol 1e-12 with equal flags,
     a stage row and three random rows rtol 1e-12, repeats bit-equal).
     The rebuild kernel against
     its plain twin (n = 300 and 180, all slabs and a range, rtol 1e-13,
     repeats and the full-row walk bit-equal, the flag table equal to its
     twin); then the full-T dim-3 backtests at n = 300 (T = 500), MSM
     and GARCH: the flag pass against its twin and timed (MSM), the
     stage-1 sweep (MSM) and a late bisection band of the real solve
     (both) on the truncated and the full-row route, bit-equal, timed
     with CUDA events in turns, traced by torch.profiler, against the
     plain twin, as shares of `rebuild_bound` over the cells the sweep's
     bounds need (`walk_cells`, counted on the host) and over the full
     cube; and a whole `calc_var(0.05)` on both routes (the full-row one
     by handing the operands over without their flags), the series
     bit-equal, host-clock seconds and launches printed, and for the MSM
     query each sweep's formation share (the cells its bounds need over
     its ms at the flag pass's cells per ms, `formation_share`) beside
     the cells a walk of one thread per row would spend
     (`warp_walk_cells`); and an
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
     bit-equal to the whole launch; the fused dim-3 solve on the dim-3
     MSM operands at the query's L = 1 and the serving batch's L = 32:
     `solve_stages3` bit-equal to the composed stages (K4 sweeps,
     `bracket_state_batched`, the widest bracket) and within rtol 1e-12 of
     its plain twin, `bisect3` on that state bit-equal to
     `bisect_fixed_count` over K4 sweeps and to its launch twin
     (`bisect3_reference`) over K4 sweeps, its repeat bit-equal and its
     roots within 1e-9 of the plain twin's;
  14. timings: CUDA events after warm-up, median and min of the reps,
     kernel and plain twin taken in turns (one grid rank's 25-row K2 and
     K4 launches among them, and `solve_stages3` and `bisect3` at L = 1
     and 32), and the refine_root trap pass per call
     (L = 1 and 128 at dim 2, L = 1 at dim 3) beside the unrefined solve
     of the same rows;
  15. device profile: torch.profiler over calls of each kernel, `calc_var`,
     the serving batches, the unrefined solves and the trap passes: host
     ms per call, the device's busy ms and ops, and each kernel's
     launches and device ms per launch (each session opens with pad
     kernels, read past, since the trace drops a session's first device
     activities once child processes have used the card; a session that
     lost every pad is run again, up to three times, and then reads "not
     measured");
  16. the f32 engine (`engine="pallas"`), counted (`f32_engine_phase`):
     with TF32 off (set and asserted), the flagship MSM and GARCH and the
     dim-3 MSM and GARCH artifacts loaded, then `bt.engine = "pallas"`,
     `calc_var(0.05)` held to `data/{flagship,dim3}_var.npz`, the 32 x 4
     and 8 x 4 grids to this run's f64 grids, and a full-T (T = 500)
     dim-3 MSM n = 300 query on the f32 truncated rebuild route to the
     f64 truncated route's series: every day within
     `root_plateau_bound(dx, weights)`, the 0.9 quantile within the
     median-dx bound, NaN days equal. No f32 kernel may launch before
     the phase (every earlier phase serves the f64 engine), and on it
     every f32 kernel must launch and no f64 one. Then each f32 kernel
     against its f32 twin (RTOL_F32 of the scale; K1 for 23 halvings
     bit-equal to 23 f32 K2 sweeps and within the plateau bound of its
     twin; the rebuild bit-equal to the f32 table sweep and to its
     full-row walk; the f32 flags equal to their twin), timed and traced
     beside the f64 figures, with bounds at float32 bytes and the
     float32 rate (67 TFLOP/s), the f32 queries' times and the f32 path's
     peak device memory (U in float32) beside the f64 path's. Past the
     count, the GARCH grids (held to phase 10's f64 grids) and the
     refined flagship levels (5e-4 of the f64 refined record) on one
     card, then phase 10's day-sharded f32 ranks held to these one-card
     f32 series: every series bit-equal, every f32 kernel of each path
     launched on each rank and no f64 one, each rank's U float32 its
     block's share of one card's to the byte (its size and each (day,
     slab) row's sum of the integers its bytes spell); prints each
     rank's f32 launches, peak device memory and wall seconds.

Each kernel's bound in the record is the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its float64
operations over 34 TFLOP/s (NVIDIA H100 SXM data sheet; FP64 outside the
tensor cores), counted from this run's shapes by `bound()`; the trap
pass's by `trap_bound()`, the dim-4 plain sweep's by `tcached_bound()`,
the rebuild sweep's by `rebuild_bound()` over the cells its bounds need
(`walk_cells`; the full cube's printed beside it), the flag pass's by
`flags_bound()`, and the fused dim-3 kernels' by `stages3_bound()` and
`bisect3_bound()` over the row lookups their sweeps' bounds hit
(`table_hits`, each halving's bounds kept from its launch twin); the f32 instantiations' by the same functions at 4
bytes an entry and 67 TFLOP/s.

Prints the kernels' JSON record on the line before the last (each
kernel's launches on the main path: `bisect3`'s as launcher calls, and
0 for `masked_contract3`, whose launches on each day-sharded rank's
dim-3 paths are its `day_sharded_launches_per_rank`; the rebuild's and
the flag pass's on phase 12, the f32 instantiations' ("<name>_f32") on
phase 16 and, as `day_sharded_f32_launches_per_rank`, on each rank's
f32 paths of phase 10, and, as `grid_launches_per_rank`, on one rank of
phase 11 (b)), and as the last line `{"ok": true, "device": {...}}`. Exits non-zero, with no result
line, when torch sees no CUDA device or the port's sources are missing.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
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
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, FP32 outside the tensor cores
# f32 refined roots against the f64 refined ones: the trap re-solve lands
# on the same continuous root from either plateau edge
# (tests/test_torch_f32_engine.py's bar)
ATOL_REFINED_F32 = 5e-4
# the device spans of each wrapper's launch: (counted kernel, others...)
KERNEL_SPANS = {
    "sweep_table": ("sweep_table_kernel",),
    "masked_sweep": ("prefix_sweep_kernel",),
    "bisect_levels": ("bisect_levels_kernel",),
    "contract3_weights": ("contract3_weights_kernel", "contract3_scan_kernel"),
    "masked_contract3": ("contract3_sweep_kernel",),
    "contract3_row_flags": ("contract3_flags_kernel",),
    "masked_contract3_rebuild": ("contract3_rebuild_kernel",
                                 "contract3_sum_kernel"),
    "solve_stages": ("solve_stages_kernel",),
    "solve_stages3": ("solve_stages3_kernel",),
    "bisect3": ("bisect3_kernel",),
}


def bound(nbytes, flops, isz=8):
    """(bound ms, "bytes" or "operations"): the least time for the work,
    its operations at the float64 rate (isz 8) or the float32 rate (isz
    4, the f32 engine's kernels)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (F64_FLOP_PER_S if isz == 8 else F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lookups(n):
    """f64 operations of one row lookup of the interval rule: prev, two
    dynamic bounds (sub, div each), the clamp, two binary searches of
    ceil(log2(n + 1)) compares and one subtraction."""
    return 7 + 2 * math.ceil(math.log2(n + 1))


def day_bytes(T, n, q, isz=8):
    """The dim-2 kernels' day operands: V, wfc, W1 and x, of `isz` bytes
    an entry (8: float64; 4: the f32 engine's float32)."""
    return isz * (T * n * n + T * n * q + q * n + n)


def table_bound(T, n, q, isz=8):
    """sweep_table (K2 build): the day operands in, the T n^2 cells of P
    (not its pad cells) and the T n row flags out; per cell the state sum
    (2q), the product with V and the prefix add."""
    return bound(day_bytes(T, n, q, isz) + isz * T * n * n + T * n,
                 T * n * n * (2 * q + 2), isz)


def sweep_bound(T, n, q, L, rows=None, isz=8):
    """masked_sweep (K2) on `rows` outer rows (n by default): of the
    prefix table only the cells the interval rule reads (two per row
    lookup, at most the table's T rows n), the T rows row flags, x, the
    (L, T, 2) bounds and (L, 2) weights in, (L, T) out; one row lookup
    per bound row, day and outer row."""
    r = n if rows is None else rows
    cells = min(T * r * n, 2 * L * T * r)
    return bound(isz * (cells + n + 2 * L * T + 2 * L + L * T) + T * r,
                 L * T * r * lookups(n), isz)


def stages_bound(T, n, L, isz=8):
    """solve_stages: the two slab sweeps of every row and day (the
    stage-1 slab and the stage-2 bracket's) read at most the T n^2 cells
    of P, or two per row lookup; the T n row flags, x, obj and the (L, 2)
    weights in; the four (L, T) states, two (L, T) flags and the widest
    word out; one row lookup per slab, row, day and outer row."""
    cells = min(T * n * n, 4 * L * T * n)
    return bound(isz * (cells + n + 3 * L + 4 * L * T + 1) + T * n
                 + 2 * L * T, 2 * L * T * n * lookups(n), isz)


def bisect_bound(T, n, q, L, n_iters, isz=8):
    """bisect_levels (K1): the day operands and the (L, T) state in, the
    roots out; U formed and scanned once, then n lookups per row, day and
    halving."""
    return bound(day_bytes(T, n, q, isz) + L * T * (isz * 5 + 1)
                 + isz * 3 * L,
                 T * n * n * (2 * q + 2) + n_iters * L * T * n * lookups(n),
                 isz)


def contract3_bound(T, n, L, hits, rows=None, isz=8):
    """masked_contract3 (K4 sweep) on `rows` outer slabs (n by default):
    two stored prefixes of U per row lookup whose interval holds a grid
    point (`hits`, `table_hits`), x and the (L, T, 2) bounds in, (L, T)
    out; n lookups per (row, day, i0), rows partials summed per (row,
    day)."""
    r = n if rows is None else rows
    return bound(isz * (2 * hits + n + 2 * L * T + 3 * L + L * T),
                 L * T * r * n * lookups(n) + L * T * r, isz)


def stages3_bound(T, n, L, hits, isz=8):
    """solve_stages3: the two K4 sweeps of every row and day (the stage-1
    slab and the stage-2 bracket's), two stored prefixes of U per row
    lookup whose interval holds a grid point (`hits`, `table_hits` of
    both sweeps' bounds), x, obj and the (L, 3) weights in; the four (L,
    T) states, two (L, T) flags and the widest word out; n lookups per
    (sweep, row, day, i0), n partials summed per (sweep, row, day)."""
    return bound(isz * (2 * hits + n + 4 * L + 4 * L * T + 1) + 2 * L * T,
                 2 * (L * T * n * n * lookups(n) + L * T * n), isz)


def bisect3_bound(T, n, L, hits, sweeps, isz=8):
    """bisect3: the K4 sweeps of its `sweeps` halvings, two stored
    prefixes of U per row lookup whose interval holds a grid point
    (`hits`, `table_hits` summed over the halvings' bounds; U is 4 GB,
    so no halving finds another's cells in the cache), x, the (L, T)
    state, obj, the (L, 3) weights and the widest word in, the (L, T)
    roots out; n lookups per (halving, row, day, i0), n partials summed
    per (halving, row, day)."""
    return bound(isz * (2 * hits + n + 4 * L * T + 4 * L + 1 + L * T)
                 + L * T,
                 sweeps * (L * T * n * n * lookups(n) + L * T * n), isz)


def weights_bound(T, n, q, student, garch, isz=8):
    """contract3_weights (K4 build): the columns and G in, the T n^3 cells
    of U out (not its pad cells); per cell the quadratic form (15), the
    density (8, exp and log1p one each), the pdf product (3, GARCH) and the
    state sum (2q + 1); the (q, n) fold per slab."""
    cols = 3 * T * n * (isz * (1 + student + garch) + 1)
    return bound(cols + isz * (2 * q * n + T * n * q * q + T * n ** 3)
                 + 8 * 9,
                 T * n ** 3 * (24 + 2 * q + 3 * garch) + T * n * n * 2 * q * q,
                 isz)


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
# the day-sharded ranks' paths: the f64 engine's, then the f32 engine's
SHARDED_PATHS = ("dim2", "dim3", "dim4", "dim2_f32", "dim3_f32")
F32_PATHS = ("dim2_f32", "dim3_f32")
CUT_DAYS = 4  # the flagship cut on three ranks: days 2 + 2 + 0


def _served(root, name, data, mesh, engine="xla", **kw):
    """load_artifacts(data/<name>, device="cuda", mesh=mesh, **kw), then
    `bt.engine = engine` (JAX's recipe for the f32 engine)."""
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    bt = load_artifacts(os.path.join(root, "data", name), data,
                        device="cuda", mesh=mesh, **kw)
    if engine != "xla":
        bt.engine = engine
    return bt


def table_sums(U):
    """(T, r) int64: each (day, slab) row of the table U summed as the
    integers its bytes spell (4 or 8 bytes an entry), a fingerprint that
    any flipped bit moves, read on the card a day at a time (the int64
    sum of a whole float32 table would take twice its bytes)."""
    import numpy as np
    import torch

    ints = U.view(torch.int32 if U.element_size() == 4 else torch.int64)
    return np.stack([day.sum(dim=-1, dtype=torch.int64).cpu().numpy()
                     for day in ints]) if len(ints) else \
        np.zeros(U.shape[:2], np.int64)


def serve_day_sharded(root, mesh, w_batch, w_batch3,
                      paths=("dim2", "dim3", "dim4")):
    """The `paths` of the sharded phases through `mesh` (a DayMesh or a
    GridMesh; None: one card, cuda:0), each counted alone: ({name:
    array}, {path: f64 launches, and path + "/f32": its f32 launches},
    {path: peak device bytes above what was allocated when the path
    began}, {path: wall s}).
    dim2: the flagship MSM and GARCH artifacts' calc_var(0.05), the
    ROWS_P x LEVELS grid and the refined levels of
    `flagship_refined_var.npz`; dim2_msm: the flagship MSM calc_var(0.05)
    and grid alone; dim3: the dim-3 artifacts' calc_var(0.05) and the
    ROWS_P3 x LEVELS grid, one backtest at a time, and the bytes of the
    table U (on the f32 engine its (day, slab) fingerprint too,
    `table_sums`); dim4: the MSM
    artifact's calc_var(0.05) at n = 32 over T = 500; dim2_f32,
    dim3_f32: dim2 and dim3 on the f32 engine (`bt.engine = "pallas"`,
    on a DayMesh JAX's "sharded_pallas")."""
    import numpy as np
    import torch

    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
    from copula_var_tpu_torch.ops import cuda_solver as cs

    counters = (cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
                cq3.contract3_weights, cq3.masked_contract3,
                cq3.contract3_row_flags, cq3.masked_contract3_rebuild,
                cs.solve_stages, cs.solve_stages3, cs.bisect3)
    rec_r = np.load(os.path.join(root, "data", "flagship_refined_var.npz"))
    rec3 = np.load(os.path.join(root, "data", "dim3_var.npz"))
    rec4 = np.load(os.path.join(root, "data", "dim4_var.npz"))
    out = {}

    def dim2(families=("msm", "garch"), refined=True, engine="xla"):
        tag = "dim2" if engine == "xla" else "dim2_f32"
        data = from_csv(os.path.join(root, "data", "flagship.csv"), 1135)
        for est in families:
            bt = _served(root, f"flagship_artifacts_{est}.npz", data, mesh,
                         engine)
            out[f"{tag}/{est}/var"] = bt.calc_var(0.05)
            out[f"{tag}/{est}/grid"] = bt.calc_var_grid(w_batch, LEVELS)
            if not refined:
                continue
            bt = _served(root, f"flagship_artifacts_{est}.npz", data, mesh,
                         engine, refine_root=True)
            out[f"{tag}/{est}/refined"] = bt.calc_var_levels(
                tuple(rec_r["levels"]))

    def dim3(engine="xla"):
        tag = "dim3" if engine == "xla" else "dim3_f32"
        data = from_csv(os.path.join(root, "data", "dim3.csv"),
                        int(rec3["n_insample"]), weights=rec3["weights"])
        for est in ("msm", "garch"):
            bt = _served(root, f"dim3_artifacts_{est}.npz", data, mesh,
                         engine)
            out[f"{tag}/{est}/var"] = bt.calc_var(0.05)
            out[f"{tag}/{est}/grid"] = bt.calc_var_grid(w_batch3, LEVELS)
            U = bt.sweep_operands().U
            out[f"{tag}/{est}/table_bytes"] = np.array(
                U.numel() * U.element_size())
            if engine != "xla":
                out[f"{tag}/{est}/table_sums"] = table_sums(U)
            del bt, U
            torch.cuda.empty_cache()

    def dim4():
        data = from_csv(os.path.join(root, "data", "dim4.csv"),
                        int(rec4["n_insample"]), weights=rec4["weights"])
        bt = _served(root, "dim4_artifacts_msm.npz", data, mesh)
        out["dim4/msm/var"] = bt.calc_var(float(rec4["obj_var"]))

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    launches, peaks, walls = {}, {}, {}
    fns = {"dim2": dim2, "dim3": dim3, "dim4": dim4,
           "dim2_msm": lambda: dim2(("msm",), refined=False),
           "dim2_f32": lambda: dim2(engine="pallas"),
           "dim3_f32": lambda: dim3("pallas")}
    for name in paths:
        fn = fns[name]
        _zero_launches(f32=True)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        launches[name] = {c.__name__: _launches(c) for c in counters}
        launches[f"{name}/f32"] = {c.__name__: _launches(c, f32=True)
                                   for c in counters}
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
    return out, launches, peaks, walls


def flagship_cut_f32(root, out_dir, mesh):
    """The flagship MSM artifact cut to its first CUT_DAYS days (written
    to out_dir), served on the f32 engine through the day mesh (on
    SHARDED_RANKS ranks the last block is empty): {"cut_f32/msm/var":
    (CUT_DAYS,)}; rank 0 adds the same cut on one card with no mesh,
    "cut_f32/msm/one_card". Not counted."""
    import numpy as np

    from copula_var_tpu_torch.data import from_csv, from_returns
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    z = np.load(os.path.join(root, "data", "flagship_artifacts_msm.npz"))
    arrays = {k: z[k] for k in z.files}
    for k in ("ii_forecasts_by_states", "ii_forecast_combos"):
        arrays[k] = arrays[k][:CUT_DAYS]
    path = os.path.join(out_dir, f"cut_msm_rank{mesh.rank}.npz")
    np.savez(path, **arrays)
    full = from_csv(os.path.join(root, "data", "flagship.csv"), 1135)
    data = from_returns(full.returns[:1135 + CUT_DAYS], full.tickers, 1135)
    out = {}
    for key, m in (("var", mesh), ("one_card", None)):
        if m is None and mesh.rank != 0:
            continue
        bt = load_artifacts(path, data, device="cuda", mesh=m)
        bt.engine = "pallas"
        out[f"cut_f32/msm/{key}"] = bt.calc_var(0.05)
    return out


def day_sharded_rank(root, out_dir, w_batch, w_batch3):
    """One gloo rank of the day-sharded phase (spawned by
    `parallel.distributed.run_world`): serve every path of SHARDED_PATHS
    through the world's mesh, then the f32 flagship cut
    (`flagship_cut_f32`), and save what this rank got, its day block,
    launches, peak device memory and wall seconds to
    out_dir/rank<r>.{npz,json}."""
    import numpy as np
    import torch

    from copula_var_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 engine's
    mesh = make_mesh()
    out, launches, peaks, walls = serve_day_sharded(root, mesh, w_batch,
                                                    w_batch3, SHARDED_PATHS)
    out.update(flagship_cut_f32(root, out_dir, mesh))
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
    """The day-sharded phase. First every f64 path of `serve_day_sharded`
    on one card, with no mesh: the one-card series. (a) A world of one
    NCCL rank in this process serves the flagship MSM through a
    `DayMesh`, bit-equal to the one-card series and within 1e-9 of the
    record; (b) SHARDED_RANKS gloo ranks on the one card, spawned after
    this process built the kernels, serve every path of SHARDED_PATHS,
    each rank's f64 results bit-equal to the one-card series and within
    1e-9 of the records (0 days above), with no f32 launch on an f64
    path, and the f32 flagship cut of CUT_DAYS days (the last rank's
    block empty) bit-equal to rank 0's cut on one card. The ranks' f32
    paths are held in the f32 phase, which serves their one-card series
    (this process may launch no f32 kernel before it). Returns (the
    phase's report, the one-card series, its peak device bytes per path,
    the ranks' f32 results: [{rank, block, results, launches, peak_bytes,
    wall_s}])."""
    import tempfile

    import numpy as np
    import torch

    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.parallel import DayMesh, distributed, make_mesh

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
    cut = ranks[0]["results"]["cut_f32/msm/one_card"]
    for info in ranks:
        r, got = info["rank"], info["results"]
        if not np.array_equal(got["cut_f32/msm/var"], cut):
            raise AssertionError(f"rank {r}: the f32 {CUT_DAYS}-day cut is "
                                 "not bit-equal to one card's")
        for name, want in unsharded.items():
            if name.endswith(("table_bytes", "table_sums")):
                continue
            e = held(f"rank {r} {name}", got[name], want, records.get(name))
            if e is not None:
                errs[name] = max(errs.get(name, 0.0), e)
        lc = info["launches"]
        for k in ("sweep_table", "masked_sweep", "bisect_levels"):
            if lc["dim2"][k] <= 0:
                raise AssertionError(f"rank {r}: {k} never launched on the "
                                     "dim-2 path")
        if lc["dim2"]["solve_stages"]:
            raise AssertionError(f"rank {r}: a day mesh took the one-card "
                                 "fused route")
        if lc["dim2"]["sweep_table"] != 4:
            raise AssertionError(f"rank {r}: sweep_table did not build one "
                                 "table per dim-2 backtest")
        if lc["dim3"]["contract3_weights"] != 2 or \
                lc["dim3"]["masked_contract3"] <= 0:
            raise AssertionError(f"rank {r}: K4 did not run its dim-3 path "
                                 f"{lc['dim3']}")
        if lc["dim2"]["masked_contract3"] or \
                lc["dim2"]["masked_contract3_rebuild"] or \
                lc["dim2"]["contract3_row_flags"] or \
                lc["dim3"]["contract3_row_flags"] or \
                lc["dim3"]["masked_sweep"] or any(lc["dim4"].values()) or \
                any(any(lc[f"{p}/f32"].values())
                    for p in ("dim2", "dim3", "dim4")):
            raise AssertionError(f"rank {r}: a kernel launched off its path "
                                 f"{lc}")
        print(f"day-sharded (b) rank {r} of {SHARDED_RANKS} "
              f"({info['device']}, gloo): days [{info['block_T500'][0]}, "
              f"{info['block_T500'][1]}) of 500; launches {lc}; peak device "
              f"bytes above each path's start {info['peak_bytes']}; dim-3 table U "
              f"{int(got['dim3/msm/table_bytes'])} bytes; wall s "
              + ", ".join(f"{k} {v:.3f}" for k, v in info["wall_s"].items()))
    cut_blocks = [DayMesh(None, r, SHARDED_RANKS, "cpu").day_block(CUT_DAYS)
                  for r in range(SHARDED_RANKS)]
    print(f"day-sharded (b): the f32 flagship MSM cut of {CUT_DAYS} days "
          f"(rank blocks {cut_blocks}) bit-equal to one card's on every "
          "rank")
    print(f"day-sharded (b): {SHARDED_RANKS} ranks, every f64 result "
          "bit-equal to the one-card series and each record within "
          f"{ATOL_VAR:g} (0 days above): "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; phase wall {wall:.3f} s, host clock, spawn included ({smi}; "
          "ranks share one card: not a scaling figure)")
    report["gloo_world"] = {
        "ranks": [{k: v for k, v in info.items() if k != "results"}
                  for info in ranks],
        "max_err": errs, "wall_s": wall}
    f32_ranks = [{"rank": info["rank"], "block": info["block_T500"],
                  "results": {k: v for k, v in info["results"].items()
                              if k.startswith(F32_PATHS)},
                  "launches": {k: v for k, v in info["launches"].items()
                               if k.startswith(F32_PATHS)},
                  "peak_bytes": {p: info["peak_bytes"][p]
                                 for p in F32_PATHS},
                  "wall_s": {p: info["wall_s"][p] for p in F32_PATHS}}
                 for info in ranks]
    return report, unsharded, peaks1, f32_ranks


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
            if any(c["bisect_levels"] or c["solve_stages"]
                   for c in lc.values()):
                raise AssertionError(f"grid-sharded rank {r} {tag}: K1 or "
                                     f"the fused stages launched {lc}")
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
                    dim2["contract3_row_flags"]) or (
                    "dim3" in lc and (lc["dim3"]["masked_sweep"] or
                                      lc["dim3"]["contract3_row_flags"])) or (
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


def cell_ops(q, garch):
    """f64 operations of one cell of U (`weights_bound`'s count: the
    quadratic form, the density with one exp and one log1p counted one
    each, the pdf product at GARCH, the state sum) and one more: the
    prefix add, or the flag pass's test."""
    return 24 + 2 * q + 3 * garch + 1


def _reaches(x, bounds, weights, box_min=-5.0, rows=None, day_chunk=25):
    """Per block of `day_chunk` days, the (days, rows, n) reach of each
    (t, i0, i1) row of the outer slabs `rows` ((i0, i1), all by default):
    the longest hi = #{x_j <= dup} of the bound rows whose interval (dlo,
    dup] holds a grid point, 0 where none does (the kernel's arithmetic:
    prev = x0 w1 + x1 w2, dup = (b_up - prev) / w_in, dlo = max((b_lo -
    prev) / w_in, box_min), NaN an empty interval), counted on the host."""
    import torch

    x = x.detach().cpu()
    b = bounds.detach().cpu()
    w = weights.detach().cpu()
    x0 = x if rows is None else x[rows[0]:rows[1]]
    lo_box = torch.tensor(box_min, dtype=torch.float64)
    for t0 in range(0, b.shape[1], day_chunk):
        reach = None
        for l in range(b.shape[0]):
            prev = x0[:, None] * w[l, 1] + x[None, :] * w[l, 2]
            bt = b[l, t0:t0 + day_chunk]
            dup = (bt[:, 1, None, None] - prev) / w[l, 0]
            dlo = torch.maximum((bt[:, 0, None, None] - prev) / w[l, 0],
                                lo_box)
            hi = torch.searchsorted(x, dup.contiguous(), right=True)
            lo = torch.searchsorted(x, dlo.contiguous(), right=True)
            used = (hi > lo) & ~torch.isnan(dup) & ~torch.isnan(dlo)
            h = torch.where(used, hi, torch.zeros_like(hi))
            reach = h if reach is None else torch.maximum(reach, h)
        yield reach


def walk_cells(x, bounds, weights, box_min=-5.0, rows=None, day_chunk=25):
    """(cells, fold columns, rows, slabs) of one rebuild sweep, an exact
    count on the host (`_reaches`). cells: the reaches summed, the cells
    the truncated walk needs; fold columns: per (t, i0) slab its longest
    reach, summed; rows and slabs: those with a reach, each of whose n
    cells (rows) or n fold columns (slabs) the full-row walk forms."""
    cells = cols = used_rows = used_slabs = 0
    for reach in _reaches(x, bounds, weights, box_min, rows, day_chunk):
        cells += int(reach.sum())
        slab = reach.amax(dim=-1)
        cols += int(slab.sum())
        used_rows += int((reach > 0).sum())
        used_slabs += int((slab > 0).sum())
    return cells, cols, used_rows, used_slabs


def warp_walk_cells(x, bounds, weights, box_min=-5.0, rows=None,
                    day_chunk=25):
    """The cell slots a walk of one thread per row spends on one rebuild
    sweep: per warp of 32 consecutive i1 rows of a (t, i0) slab (i1 in
    [32 k, 32 k + 32), the last warp of a slab short of rows) its longest
    reach (`_reaches`) times 32 lanes, summed. Over `walk_cells`' cells,
    the share of lanes such a walk leaves idle."""
    import torch

    spent = 0
    for reach in _reaches(x, bounds, weights, box_min, rows, day_chunk):
        n = reach.shape[-1]
        pad = torch.nn.functional.pad(reach, (0, -n % 32))
        spent += 32 * int(pad.unflatten(-1, (-1, 32)).amax(dim=-1).sum())
    return spent


def formation_share(cells, device_ms, flag_cells, flag_ms):
    """How far a rebuild sweep forms its cells at the flag pass's rate:
    the cells it needs (`walk_cells`) over its device ms times the flag
    kernel's cells per ms on the same book (every lane of that kernel
    forms a cell; T rows n^2 cells in `flag_ms`). 1.0: every lane busy as
    the flag pass keeps them; None without both times."""
    if not device_ms or not flag_ms:
        return None
    return cells / (device_ms * flag_cells / flag_ms)


def table_hits(x, bounds, weights, box_min=-5.0, rows=None, day_chunk=25,
               device="cpu"):
    """Row lookups of one table sweep whose interval (dlo, dup] holds a
    grid point, over the bound rows, the days and the outer slabs `rows`
    ((i0, i1), all by default), an exact count with the kernel's
    arithmetic (as `walk_cells`), on the host or on `device` (each
    operation on its own, so no step is fused: the same count)."""
    import torch

    x = x.detach().to(device)
    b = bounds.detach().to(device)
    w = weights.detach().to(device)
    x0 = x if rows is None else x[rows[0]:rows[1]]
    lo_box = torch.tensor(box_min, dtype=x.dtype, device=device)
    hits = 0
    for t0 in range(0, b.shape[1], day_chunk):
        for l in range(b.shape[0]):
            prev = x0[:, None] * w[l, 1] + x[None, :] * w[l, 2]
            bt = b[l, t0:t0 + day_chunk]
            dup = (bt[:, 1, None, None] - prev) / w[l, 0]
            dlo = torch.maximum((bt[:, 0, None, None] - prev) / w[l, 0],
                                lo_box)
            hi = torch.searchsorted(x, dup.contiguous(), right=True)
            lo = torch.searchsorted(x, dlo.contiguous(), right=True)
            hits += int(((hi > lo) & ~torch.isnan(dup)
                         & ~torch.isnan(dlo)).sum())
    return hits


def rebuild_bound(T, n, q, L, student, garch, rows=None, walk=None,
                  isz=8):
    """masked_contract3_rebuild (K4 without U) on `rows` outer slabs (n
    by default): in, the columns (z, lu as float64, the finite flags as
    bytes; the pdf columns at GARCH), G, W1, W2, x, the (L, T, 2) bounds
    and (L, 3) weights, and with `walk` the row flags; out, the (L, T)
    integrals. Per cell `cell_ops`, the (q, n) fold's 2q^2 per column, and
    n lookups per (row, day, i0). Without `walk` every cell of the T rows
    n^2 and every fold column (the full cube); with `walk`, (cells, fold
    columns): the work this sweep's bounds need (`walk_cells`)."""
    r = n if rows is None else rows
    cols = 3 * T * n * (isz * (1 + student + garch) + 1)
    nbytes = cols + isz * (T * n * q * q + 2 * q * n + n + 2 * L * T + 3 * L
                           + L * T)
    cells, fold = (T * r * n * n, T * r * n) if walk is None else walk
    if walk is not None:
        nbytes += T * r * n
    flops = (cells * cell_ops(q, garch) + fold * 2 * q * q
             + L * T * r * n * lookups(n))
    return bound(nbytes, flops, isz)


def flags_bound(T, n, q, student, garch, rows=None, isz=8):
    """contract3_row_flags: the columns and G in, a byte per (t, i0, i1)
    row out; every cell of the T rows n^2 formed and tested once
    (`cell_ops`), the (q, n) fold per slab."""
    r = n if rows is None else rows
    cols = 3 * T * n * (isz * (1 + student + garch) + 1)
    nbytes = cols + isz * (T * n * q * q + 2 * q * n) + 8 * 9 + T * r * n
    return bound(nbytes, T * r * n * n * cell_ops(q, garch)
                 + T * r * n * 2 * q * q, isz)


def wide_grid_phase(root, smi):
    """Grids past the flagship's, through the kernels, counted per series:
    each series of `data/wide_grid_var.npz` (dim 2 at n = 180, 200, 400
    on 16 days; dim 3 at n = 180, 300 on 8 days; MSM and GARCH, the
    committed artifacts' fits and the record's inputs at that width)
    served on the card with every plain sweep made to raise, held at atol
    1e-9 (0 days above); the route and the K1 / K2 / K4-table /
    K4-rebuild / flag launches printed per series (dim 2 past K1's 169:
    K2 sweeps only; dim 3 past the table's 169: one flag table and the
    rebuild only, `prep.flag_bytes` and `prep.flagged_rows` the flags'
    bytes and set rows), and each dim-2 series' P and K2 sweeps, at its width,
    against their plain twins (`k2_parity`). Then the rebuild kernel
    against its plain twin (n = 300 and 180, all slabs and a range,
    repeats and the full-row walk bit-equal, the flags equal to their
    twin); the full-T n = 300 backtests (MSM, GARCH): the flag pass, the
    stage-1 sweep and a late band of the real solve on both routes, and a
    whole `calc_var` on both routes, bit-equal, timed against both
    bounds; and the minimal-plugin GARCH adapter against its JAX record.
    Returns (report, the rebuild's and the flag pass's kernels-line
    numbers)."""
    import numpy as np
    import torch

    from copula_var_tpu_torch import backtest as bt_mod
    from copula_var_tpu_torch.data import from_csv, from_returns
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
    from copula_var_tpu_torch.ops import cuda_solver as cs
    from copula_var_tpu_torch.ops import tcached
    from copula_var_tpu_torch.utils import profiling
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    t_phase = time.perf_counter()
    rec = np.load(os.path.join(root, "data", "wide_grid_var.npz"))
    alpha = float(rec["obj_var"])
    counters = (cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
                cq3.contract3_weights, cq3.masked_contract3,
                cq3.contract3_row_flags, cq3.masked_contract3_rebuild,
                cs.solve_stages, cs.solve_stages3, cs.bisect3)

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
                _zero_launches()
                saved = [(m, a, getattr(m, a)) for m, a in plain]
                for m, a, _ in saved:
                    setattr(m, a, refuse)
                flag_keys = ("prep.flag_bytes", "prep.flagged_rows")
                before = profiling.counters()
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
                after = profiling.counters()
                flag_counts = {k: after.get(k, 0) - before.get(k, 0)
                               for k in flag_keys}
                lc = {c.__name__: _launches(c) for c in counters}
                for k, v in lc.items():
                    total[k] = total.get(k, 0) + v
                route = (cs.route("cuda", torch.float64, 2, n).bisect
                         if dim == 2 else
                         "table" if ops.U is not None else
                         "rebuild" if ops.flags is not None else
                         "rebuild_full")
                want = rec[f"{tag}_var"]
                if var.shape != want.shape or not np.all(np.isfinite(var)):
                    raise AssertionError(f"wide {tag}: bad VaR {var.shape}")
                diff = np.abs(var - want)
                above = int(np.sum(diff > ATOL_VAR))
                if above:
                    raise AssertionError(f"wide {tag}: {above} days off the "
                                         f"record, max {diff.max():.3e}")
                if dim == 2 and (route != "halvings" or lc["bisect_levels"] or
                                 lc["solve_stages"] or
                                 lc["masked_sweep"] <= 0 or
                                 lc["sweep_table"] != 1):
                    raise AssertionError(f"wide {tag}: not bisected by K2 "
                                         f"sweeps: {route} {lc}")
                if dim == 2 and lc["contract3_row_flags"]:
                    raise AssertionError(f"wide {tag}: a dim-3 kernel "
                                         f"launched: {lc}")
                if dim == 3 and (route != "rebuild" or
                                 lc["masked_contract3"] or
                                 lc["contract3_weights"] or
                                 lc["contract3_row_flags"] != 1 or
                                 lc["masked_contract3_rebuild"] <= 0):
                    raise AssertionError(f"wide {tag}: not swept by the "
                                         f"rebuild kernel: {route} {lc}")
                if dim == 3 and flag_counts != {
                        "prep.flag_bytes": ops.flags.nbytes,
                        "prep.flagged_rows": int(ops.flags.sum())}:
                    raise AssertionError(f"wide {tag}: the flag counters "
                                         f"{flag_counts} are not the flags' "
                                         f"bytes and rows")
                series[tag] = {"route": route, "launches": lc,
                               "flag_counters": flag_counts,
                               "max_err": float(diff.max()),
                               "days_above": above, "wall_s": wall}
                print(f"wide {tag}: route {route}, max |VaR - record| = "
                      f"{diff.max():.3e} (bound {ATOL_VAR:g}), days above "
                      f"{above} of {len(var)}; launches K1 "
                      f"{lc['bisect_levels']}, K2 table {lc['sweep_table']} "
                      f"sweep {lc['masked_sweep']}, K4 table "
                      f"{lc['contract3_weights']} sweep "
                      f"{lc['masked_contract3']}, K4 rebuild "
                      f"{lc['masked_contract3_rebuild']} (flags "
                      f"{lc['contract3_row_flags']}); {wall:.3f} s "
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
        if ops.flags is None or not torch.equal(
                ops.flags, cq3.contract3_row_flags_reference(ops)):
            raise AssertionError(f"rebuild {tag} rows {rows}: the flag "
                                 "table is missing or off its plain twin")
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
        if not torch.equal(got, cq3.masked_contract3_rebuild(
                ops._replace(flags=None), b, w)):
            raise AssertionError(f"rebuild {tag} rows {rows}: the full-row "
                                 "walk gave other bits")
        parity[f"{tag}_rows{rows}"] = {
            "max_abs_err": float((got - want).abs().max()), "rel": rel,
            "flags_set": int(ops.flags.sum())}
        print(f"parity rebuild {tag} rows {rows or (0, n)}, L=4, {days} "
              f"days: {rel:.3e} relative off the plain twin (bound "
              f"{RTOL_REBUILD:g}), repeat and full-row walk bit-equal; flag "
              f"table equal to its twin, {int(ops.flags.sum())} rows "
              "flagged")

    # the full-T dim-3 backtests at n = 300 (T = 500): the artifacts'
    # T = 500 forecasts at the record's n = 300 grid, on the truncated route
    # (the flag table built with the operands) and on the full-row route
    # (the same operands handed over without their flags)
    def full_T(est):
        data, base = bases[(3, est)]
        tag = f"dim3_{est}_n{WIDE_N_TIMED}"
        grid = ("x", "dx", "densities") if est == "msm" else ("x", "dx")
        inputs = base.integration_inputs._replace(
            **{f: torch.as_tensor(rec[f"{tag}_ii_{f}"], device=dev)
               for f in grid})
        _zero_launches()
        bt = bt_mod.VaRBacktest(data, base.adapter, base.copula,
                                base.copula_fit, base.model_fits, inputs,
                                num_points=WIDE_N_TIMED, device="cuda")
        ops = bt.sweep_operands()
        if (ops.U is not None or ops.flags is None or ops.days != WIDE_DAYS_T
                or _launches(cq3.contract3_row_flags) != 1):
            raise AssertionError(f"the full-T {est} n={WIDE_N_TIMED} "
                                 "operands did not take the rebuild route "
                                 "with one flag table")
        return bt, ops

    def timed_sweep(label, ops, b, w):
        """A sweep on both routes: bit-equal, call ms (CUDA events) in
        turns, the truncated route's device ms (torch.profiler), its plain
        twin's time and error, and its bounds: the cells this sweep's
        bounds need (`walk_cells`) and the full cube."""
        full_ops = ops._replace(flags=None)
        got = cq3.masked_contract3_rebuild(ops, b, w)
        if not torch.equal(got, cq3.masked_contract3_rebuild(full_ops, b,
                                                              w)):
            raise AssertionError(f"rebuild {label}: the truncated and "
                                 "full-row walks gave other bits")
        ms = cuda_ms(torch, {
            "truncated": lambda: cq3.masked_contract3_rebuild(ops, b, w),
            "full_row": lambda: cq3.masked_contract3_rebuild(full_ops, b,
                                                             w)},
            reps=REPS_WIDE)
        prof = device_profile(torch, lambda: cq3.masked_contract3_rebuild(
            ops, b, w), reps=2)
        dev_ms = prof["kernels"]["masked_contract3_rebuild"]["device_ms"]
        cells, fold, used_rows, used_slabs = walk_cells(ops.x, b, w)
        kw = dict(student=ops.spec.kind == "student",
                  garch=ops.p_cols is not None)
        shape = (ops.days, WIDE_N_TIMED, ops.w1.shape[0], b.shape[0])
        b_ms, by = rebuild_bound(*shape, walk=(cells, fold), **kw)
        row_ms, row_by = rebuild_bound(
            *shape, walk=(used_rows * WIDE_N_TIMED,
                          used_slabs * WIDE_N_TIMED), **kw)
        cube_ms = rebuild_bound(*shape, **kw)[0]
        want = cq3.masked_contract3_reference(ops, b, w)
        plain_ms = cuda_ms(torch, {
            "plain": lambda: cq3.masked_contract3_reference(ops, b, w)},
            reps=1, warmup=0)["plain"]
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= RTOL_REBUILD:
            raise AssertionError(f"rebuild {label}: {rel:.3e} relative off "
                                 "its plain twin")
        cube = ops.days * WIDE_N_TIMED ** 3
        out = {"truncated_ms": ms["truncated"], "full_row_ms":
               ms["full_row"], "device_ms": dev_ms, "profile": prof,
               "bound_ms": [b_ms, by], "full_row_bound_ms": [row_ms, row_by],
               "cube_bound_ms": cube_ms, "cells": cells,
               "fold_columns": fold, "rows_walked": used_rows,
               "cube_cells": cube, "plain_ms": plain_ms,
               "max_abs_err": err, "rel_err": rel}
        print(f"wide rebuild {label}, n={WIDE_N_TIMED}, T={ops.days}, "
              f"L={b.shape[0]}: truncated call {ms['truncated'][0]:.3f} ms "
              f"(min {ms['truncated'][1]:.3f}; CUDA events), device "
              + _ms(dev_ms) + f" ms (torch.profiler), {cells} cells walked "
              f"({cells / cube:.2%} of the cube), bound {b_ms:.3f} ms by "
              f"{by} ("
              + ("not measured" if dev_ms is None else f"{b_ms / dev_ms:.1%}")
              + f" of the device time); full-row call "
              f"{ms['full_row'][0]:.3f} ms (in turns), {used_rows} rows "
              f"walked whole, bound {row_ms:.3f} ms by {row_by} "
              f"({row_ms / ms['full_row'][0]:.1%} of the call); bit-equal; "
              f"the whole cube's bound {cube_ms:.3f} ms; plain twin "
              f"{plain_ms[0]:.3f} ms, {rel:.3e} relative off it ({smi})")
        return out

    full_report = {}
    for est in ("msm", "garch"):
        bt, ops = full_T(est)
        T, q = ops.days, ops.w1.shape[0]
        rep_e = full_report[est] = {"flag_launches":
                                    _launches(cq3.contract3_row_flags)}
        w1 = bt.weights.reshape(1, 3)
        if est == "msm":
            # the flag pass, once per backtest: against its plain twin, timed
            flags = cq3.contract3_row_flags(ops)
            want_f = cq3.contract3_row_flags_reference(ops)
            if not (torch.equal(flags, ops.flags) and
                    torch.equal(flags, want_f)):
                raise AssertionError("contract3_row_flags: off its plain "
                                     "twin at full T")
            f_ms = cuda_ms(torch, {"kernel": lambda: cq3.contract3_row_flags(
                ops)}, reps=REPS_WIDE, warmup=1)["kernel"]
            fp_ms = cuda_ms(torch, {
                "plain": lambda: cq3.contract3_row_flags_reference(ops)},
                reps=1, warmup=0)["plain"]
            f_prof = device_profile(torch, lambda: cq3.contract3_row_flags(
                ops), reps=1)
            f_dev = f_prof["kernels"]["contract3_row_flags"]["device_ms"]
            fb_ms, fb_by = flags_bound(T, WIDE_N_TIMED, q, True, False)
            rep_e["flags"] = {
                "kernel_ms": f_ms, "plain_ms": fp_ms, "device_ms": f_dev,
                "bytes": flags.numel(), "rows_flagged": int(flags.sum()),
                "bound_ms": [fb_ms, fb_by], "max_abs_err": 0.0}
            print(f"wide flag pass dim3 MSM n={WIDE_N_TIMED}, T={T}: call "
                  f"{f_ms[0]:.3f} ms (min {f_ms[1]:.3f}; CUDA events), device "
                  + _ms(f_dev) + f" ms (torch.profiler), {flags.numel()} "
                  f"bytes, {int(flags.sum())} rows flagged; equal to its "
                  f"plain twin ({fp_ms[0]:.3f} ms); bound {fb_ms:.3f} ms by "
                  f"{fb_by} ("
                  + ("not measured" if f_dev is None else
                     f"{fb_ms / f_dev:.1%}") + f" of the device time) ({smi})")
            # the stage-1 sweep of PR 11's timing
            stage1 = torch.tensor([-100.0, -3.0], dtype=torch.float64,
                                  device=dev).expand(1, T, 2).contiguous()
            rep_e["stage1"] = timed_sweep("stage-1 sweep dim3 MSM", ops,
                                          stage1, w1)
        # the query on the truncated route, its sweeps' bounds recorded
        calls, call_ms = [], []
        real = cs.masked_contract3_rebuild

        def recorder(ops_, bounds, weights, box_min=-5.0):
            calls.append((bounds.clone(), weights.clone()))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(ops_, bounds, weights, box_min)
            end.record()
            end.synchronize()
            call_ms.append(start.elapsed_time(end))
            return out

        cs.masked_contract3_rebuild = recorder
        try:
            rec_var = bt.calc_var(alpha)
        finally:
            cs.masked_contract3_rebuild = real
        queries = {}
        for route, flags_ in (("truncated", ops.flags), ("full_row", None),
                              ("truncated_again", ops.flags)):
            bt._ops = ops._replace(flags=flags_)
            before = _launches(cq3.masked_contract3_rebuild)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            var = bt.calc_var(alpha)
            torch.cuda.synchronize()
            queries[route] = (var, time.perf_counter() - t0,
                              _launches(cq3.masked_contract3_rebuild) - before)
        bt._ops = ops
        var_t = queries["truncated"][0]
        if not (np.array_equal(var_t, queries["full_row"][0]) and
                np.array_equal(var_t, rec_var) and
                np.array_equal(var_t, queries["truncated_again"][0])):
            raise AssertionError(f"full-T {est} calc_var: the truncated and "
                                 "full-row routes gave other series")
        if var_t.shape != (T,) or not np.all(np.isfinite(var_t)):
            raise AssertionError(f"full-T {est} calc_var: bad series")
        rep_e["query"] = {r: {"wall_s": v[1], "launches": v[2]}
                          for r, v in queries.items()}
        rep_e["query"]["sweep_ms"] = call_ms
        print(f"wide full-T {est} query, each rebuild sweep in order (ms, "
              "CUDA events, a synchronized run): "
              + ", ".join(f"{v:.2f}" for v in call_ms) + f" ({smi})")
        if est == "msm":
            # per sweep: the cells its bounds need, those a walk of one
            # thread per row would spend, and the formation share at the
            # flag pass's rate on this book
            f_cells = T * WIDE_N_TIMED ** 3
            f_ms = rep_e["flags"]["kernel_ms"][0]
            walks = []
            for (b_, w_), ms_ in zip(calls, call_ms):
                need = walk_cells(ops.x, b_, w_)[0]
                walks.append({"ms": ms_, "cells": need,
                              "warp_walk_cells": warp_walk_cells(ops.x, b_,
                                                                 w_),
                              "formation_share": formation_share(
                                  need, ms_, f_cells, f_ms)})
            rep_e["query"]["walks"] = walks
            print(f"wide full-T {est} query, each rebuild sweep's formation "
                  f"share (needed cells / (ms x the flag pass's "
                  f"{f_cells / f_ms:.4g} cells/ms)) and a thread-per-row "
                  "walk's cells over the needed: "
                  + ", ".join(
                      f"{v['formation_share']:.3f} (x"
                      f"{v['warp_walk_cells'] / max(v['cells'], 1):.2f})"
                      for v in walks) + f" ({smi})")
        print(f"wide full-T calc_var({alpha:g}) dim3 {est.upper()} "
              f"n={WIDE_N_TIMED}, T={T}: truncated "
              f"{queries['truncated'][1]:.3f} s (again "
              f"{queries['truncated_again'][1]:.3f} s), full-row "
              f"{queries['full_row'][1]:.3f} s (host clock, synchronized), "
              f"{queries['truncated'][2]} rebuild launches each; the two "
              f"series bit-equal ({smi})")
        # a late halving of that solve: its bounds on both routes
        band_b, band_w = calls[-4]
        rep_e["band"] = timed_sweep(f"band sweep dim3 {est.upper()} "
                                    f"(call {len(calls) - 3} of "
                                    f"{len(calls)})", ops,
                                    band_b.contiguous(),
                                    band_w.contiguous())
        rep_e["band"]["bounds_median"] = [
            float(band_b[..., 0].median()), float(band_b[..., 1].median())]
        del bt, ops
        torch.cuda.empty_cache()
    stage = full_report["msm"]["stage1"]
    flag_rep = full_report["msm"]["flags"]
    # the minimal-plugin route: JAX's host bisection over `integrals`
    bt_mod.register_adapter(MinimalGarch.name, MinimalGarch)
    days, n = int(rec["plugin_days"]), int(rec["plugin_points"])
    data, base = bases[(2, "garch")]
    cut = from_returns(data.returns[:1135 + days], data.tickers, 1135)
    _zero_launches()
    t0 = time.perf_counter()
    pb = bt_mod.create_var_backtest(
        cut, MinimalGarch.name, "student", num_points=n,
        model_fits_override=base.model_fits,
        copula_fit_override=base.copula_fit, device="cuda")
    var = pb.calc_var(alpha)
    levels = pb.calc_var_levels(tuple(rec["plugin_levels"]))
    plugin_s = time.perf_counter() - t0
    lc = {c.__name__: _launches(c) for c in counters}
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
              "full_T": full_report,
              "plugin": {"var_max_err": e_var, "levels_max_err": e_lv,
                         "launches": lc, "wall_s": plugin_s},
              "phase_s": phase_s}
    entry = {"launches": total["masked_contract3_rebuild"],
             "max_abs_err": stage["max_abs_err"],
             "ms": stage["truncated_ms"][0], "plain_ms": stage["plain_ms"][0],
             "bound_ms": stage["bound_ms"][0],
             "bound_by": stage["bound_ms"][1],
             "full_cube_bound_ms": stage["cube_bound_ms"],
             "full_row_ms": stage["full_row_ms"][0]}
    flags_entry = {"launches": total["contract3_row_flags"],
                   "max_abs_err": flag_rep["max_abs_err"],
                   "ms": flag_rep["kernel_ms"][0],
                   "plain_ms": flag_rep["plain_ms"][0],
                   "bound_ms": flag_rep["bound_ms"][0],
                   "bound_by": flag_rep["bound_ms"][1]}
    return report, entry, flags_entry


# the f32 engine's kernels against their f32 plain twins: the same float32
# cells (CUDA's expf / log1pf against torch's), summed in float64 and
# rounded once by the kernels, in float32 by the twins' products (n or
# n^2 terms): a few float32 ulps of the scale
RTOL_F32 = 1e-5


def f32_engine_phase(root, smi, w_batch, w_batch3, grid64, grid3_64,
                     f64_figures, peak3_64, f32_ranks, one_card):
    """The f32 engine (`engine="pallas"`), counted: the flagship MSM and
    GARCH and the dim-3 MSM and GARCH artifacts served through
    `bt.engine = "pallas"` after `load_artifacts` (calc_var(0.05)), the
    32 x 4 and 8 x 4 grids, and one full-T (T = 500) dim-3 MSM n = 300
    query on the f32 truncated rebuild route; every series held to its
    f64 counterpart (the records, the f64 grids of this run, the f64
    n = 300 series) within `root_plateau_bound(dx, weights)` on every day
    and the median-dx bound at the 0.9 quantile. Before it no f32 kernel
    may have launched (every earlier phase serves the f64 engine); on it
    every f32 kernel must launch and no f64 one. Then each f32 kernel
    against its f32 twin at the path's shapes (RTOL_F32 of the scale; K1
    bit-equal to the same count of f32 K2 sweeps and within the plateau
    bound of its twin; the rebuild bit-equal to the f32 table sweep and
    its full-row walk, the flags equal to their twin), timed (CUDA
    events, kernel and twin in turns) and traced (torch.profiler), beside
    their f64 figures, with their bounds at float32 bytes and the float32
    rate, and the f32 path's peak device memory (U in float32) beside the
    f64 one (`f64_figures`: {key: {"call_ms", "device_ms"}} of this run's
    f64 kernels and queries at the same keys; `peak3_64` the f64 dim-3
    path's peak above its start). Then, past the count, the GARCH grids
    (held to phase 10's f64 one-card grids, `one_card`) and the refined
    flagship levels (within ATOL_REFINED_F32 of the f64 refined record)
    on one card, and the day-sharded ranks' f32 paths (`f32_ranks`, from
    phase 10) held to these one-card f32 series: every series bit-equal,
    every f32 kernel of each path launched on each rank and no f64 one,
    each rank's U float32 its block's share of the one-card U float32 to
    the byte (size and (day, slab) fingerprint). Returns (report, the
    f32 kernels' entries of the kernels line)."""
    import numpy as np
    import torch

    from copula_var_tpu_torch.backtest import VaRBacktest
    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
    from copula_var_tpu_torch.ops import cuda_solver as cs
    from copula_var_tpu_torch.ops.solvers import (
        bracket_state_batched,
        full_iters,
        root_plateau_bound,
    )
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    F32 = torch.float32
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    counters = (cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
                cq3.contract3_weights, cq3.masked_contract3,
                cq3.contract3_row_flags, cq3.masked_contract3_rebuild)
    earlier = {c.__name__: _launches(c, f32=True) for c in counters}
    if any(earlier.values()):
        raise AssertionError(f"an f64 phase launched an f32 kernel: {earlier}")

    def zero():
        _zero_launches(f32=True)

    def read():
        return {c.__name__: (_launches(c), _launches(c, f32=True))
                for c in counters}

    def held(tag, got, want, dx, weights):
        """max |f32 - f64|, 0.9 quantile and their bounds, over rows with
        each row's weights; raises past them or on unequal NaN days."""
        got, want = np.atleast_2d(got), np.atleast_2d(want)
        weights = np.atleast_2d(weights)
        if got.shape != want.shape or not np.array_equal(np.isnan(got),
                                                         np.isnan(want)):
            raise AssertionError(f"f32 {tag}: shape or NaN days differ")
        worst = {"max": 0.0, "q90": 0.0, "bound": 0.0, "median_bound": 0.0}
        for r in range(got.shape[0]):
            w = weights[r % weights.shape[0]]
            d = np.abs(got[r] - want[r])[~np.isnan(want[r])]
            b = root_plateau_bound(dx, w)
            m = root_plateau_bound(np.median(dx, keepdims=True), w)
            if not (d.max() <= b and np.quantile(d, 0.9) <= m):
                raise AssertionError(
                    f"f32 {tag} row {r}: max {d.max():.3e} (bound {b:.3e}),"
                    f" 0.9 quantile {np.quantile(d, 0.9):.3e} (bound "
                    f"{m:.3e}) off the f64 series")
            worst = {"max": max(worst["max"], float(d.max())),
                     "q90": max(worst["q90"], float(np.quantile(d, 0.9))),
                     "bound": max(worst["bound"], b),
                     "median_bound": max(worst["median_bound"], m)}
        print(f"f32 {tag}: max |f32 - f64| {worst['max']:.3e} (plateau "
              f"bound {worst['bound']:.3e}), 0.9 quantile {worst['q90']:.3e} "
              f"(median-dx bound {worst['median_bound']:.3e}), "
              f"{int(np.sum(np.abs(got - want) > 0))} days moved")
        return worst

    levels = np.array(LEVELS)
    rec = np.load(os.path.join(root, "data", "flagship_var.npz"))
    rec3 = np.load(os.path.join(root, "data", "dim3_var.npz"))
    wide = np.load(os.path.join(root, "data", "wide_grid_var.npz"))
    alpha = float(rec["obj_var"])
    w3 = tuple(np.asarray(rec3["weights"], np.float64))

    # the f64 n = 300 series the f32 one is held to (outside the count)
    data300 = from_csv(os.path.join(root, "data", "dim3.csv"), 1135,
                       weights=tuple(wide["weights3"]))
    base300 = load_artifacts(os.path.join(root, "data",
                                          "dim3_artifacts_msm.npz"),
                             data300, device="cuda")
    tag300 = f"dim3_msm_n{WIDE_N_TIMED}"
    inputs300 = base300.integration_inputs._replace(
        **{f: torch.as_tensor(wide[f"{tag300}_ii_{f}"], device=dev)
           for f in ("x", "dx", "densities")})

    def bt300(engine):
        return VaRBacktest(data300, base300.adapter, base300.copula,
                           base300.copula_fit, base300.model_fits, inputs300,
                           num_points=WIDE_N_TIMED, device="cuda",
                           engine=engine)

    b64 = bt300("xla")
    var300_64 = b64.calc_var(alpha)
    del b64
    torch.cuda.empty_cache()

    # -- the f32 main path, counted ----------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    zero()
    bts, host, report = {}, {}, {"series": {}}
    # the one-card f32 series of the day-sharded ranks' keys
    f32_series = {}
    for dim, csv, prefix, rec_, w in (
            (2, "flagship.csv", "flagship_artifacts", rec, None),
            (3, "dim3.csv", "dim3_artifacts", rec3, w3)):
        for est in ("msm", "garch"):
            key = f"dim{dim}_{est}"
            t0 = time.perf_counter()
            data = from_csv(os.path.join(root, "data", csv), 1135, weights=w)
            bt = load_artifacts(os.path.join(root, "data",
                                             f"{prefix}_{est}.npz"),
                                data, device="cuda")
            bt.engine = "pallas"
            ops = bt.sweep_operands()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            var = bt.calc_var(alpha)
            t2 = time.perf_counter()
            host[key] = {"load_prep_s": t1 - t0, "calc_var_s": t2 - t1}
            if ops.x.dtype != F32 or (dim == 3 and ops.U is None):
                raise AssertionError(f"f32 {key}: not the f32 table route")
            report["series"][key] = held(
                f"{key} calc_var({alpha:g}) vs the f64 record", var,
                rec_[f"{est}_var"], bt.integration_inputs.dx.cpu().numpy(),
                bt.data.weights)
            f32_series[f"dim{dim}_f32/{est}/var"] = var
            bts[key] = bt
    for key, wb, want in (("dim2_msm", w_batch, grid64),
                          ("dim3_msm", w_batch3, grid3_64)):
        t0 = time.perf_counter()
        got = bts[key].calc_var_grid(wb, levels)
        host[f"{key}_grid_s"] = time.perf_counter() - t0
        f32_series[f"{key[:4]}_f32/msm/grid"] = got
        report["series"][f"{key}_grid"] = held(
            f"{key} {len(wb)}x{len(levels)} grid vs the f64 grid",
            got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]),
            bts[key].integration_inputs.dx.cpu().numpy(),
            np.repeat(wb, len(levels), axis=0))
    torch.cuda.synchronize()
    peak3 = torch.cuda.max_memory_allocated()
    b32 = bt300("pallas")
    t0 = time.perf_counter()
    ops300 = b32.sweep_operands()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    var300 = b32.calc_var(alpha)
    host["dim3_msm_n300"] = {"prep_s": t1 - t0,
                             "calc_var_s": time.perf_counter() - t1}
    if ops300.U is not None or ops300.flags is None or ops300.x.dtype != F32:
        raise AssertionError("f32 n=300: not the f32 truncated rebuild route")
    report["series"]["dim3_msm_n300"] = held(
        f"dim3 MSM n={WIDE_N_TIMED} T={ops300.days} calc_var vs the f64 "
        "truncated route", var300, var300_64,
        inputs300.dx.cpu().numpy(), data300.weights)
    launches = read()
    report["launches"] = launches
    print(f"f32 main path: launches (f64, f32) {launches}; host s {host}; "
          f"peak device memory of the f32 dim-2 and dim-3 backtests "
          f"{peak3 - base_bytes} bytes above the phase's start, U float32 "
          f"{[int(b.sweep_operands().U.numel() * 4) for k, b in bts.items() if k.startswith('dim3')]}"
          f" bytes (the f64 dim-3 path's peak {peak3_64} bytes, U float64 "
          f"4040000000 bytes each) ({smi})")
    for name, (n64, n32) in launches.items():
        if n64:
            raise AssertionError(f"f32 phase: the f64 {name} launched")
        if n32 <= 0:
            raise AssertionError(f"f32 phase: the f32 {name} never launched")
    report.update(host_s=host, peak_bytes=peak3 - base_bytes,
                  peak_bytes_f64_dim3=peak3_64)

    # -- the day-sharded ranks' f32 paths (phase 10) against one card ------
    # the rest of their one-card series, past the count: the GARCH grids
    # and the refined flagship levels
    for dim, wb in ((2, w_batch), (3, w_batch3)):
        key = f"dim{dim}_garch"
        got = bts[key].calc_var_grid(wb, levels)
        f32_series[f"dim{dim}_f32/garch/grid"] = got
        report["series"][f"{key}_grid"] = held(
            f"{key} {len(wb)}x{len(levels)} grid vs the f64 grid",
            got.reshape(-1, got.shape[-1]),
            one_card[f"dim{dim}/garch/grid"].reshape(-1, got.shape[-1]),
            bts[key].integration_inputs.dx.cpu().numpy(),
            np.repeat(wb, len(levels), axis=0))
    rec_r = np.load(os.path.join(root, "data", "flagship_refined_var.npz"))
    data2 = from_csv(os.path.join(root, "data", "flagship.csv"), 1135)
    for est in ("msm", "garch"):
        bt = load_artifacts(os.path.join(root, "data",
                                         f"flagship_artifacts_{est}.npz"),
                            data2, device="cuda", refine_root=True)
        bt.engine = "pallas"
        got = bt.calc_var_levels(tuple(rec_r["levels"]))
        d = float(np.max(np.abs(got - rec_r[f"{est}_levels"])))
        if not d <= ATOL_REFINED_F32:
            raise AssertionError(f"f32 dim2_{est} refined: {d:.3e} off the "
                                 f"f64 refined record (bound "
                                 f"{ATOL_REFINED_F32:g})")
        print(f"f32 dim2_{est} refined levels {tuple(rec_r['levels'])}: max "
              f"|f32 refined - f64 refined record| {d:.3e} (bound "
              f"{ATOL_REFINED_F32:g})")
        report["series"][f"dim2_{est}_refined"] = {"max": d}
        f32_series[f"dim2_f32/{est}/refined"] = got
        del bt
    u_one = {est: bts[f"dim3_{est}"].sweep_operands().U
             for est in ("msm", "garch")}
    u_bytes = {est: U.numel() * U.element_size() for est, U in u_one.items()}
    u_sums = {est: table_sums(U) for est, U in u_one.items()}
    T_u = u_one["msm"].shape[0]
    del u_one
    report["day_sharded_f32"] = {"ranks": []}
    for info in f32_ranks:
        r, got, lc = info["rank"], info["results"], info["launches"]
        b0, b1 = info["block"]
        for key, want in f32_series.items():
            if got[key].shape != want.shape or \
                    not np.array_equal(got[key], want):
                raise AssertionError(
                    f"f32 day-sharded rank {r} {key}: not bit-equal to the "
                    "one-card f32 series (max "
                    f"{float(np.max(np.abs(got[key] - want))):.3e})")
        for est in ("msm", "garch"):
            nb = int(got[f"dim3_f32/{est}/table_bytes"])
            if nb * T_u != u_bytes[est] * (b1 - b0) or not np.array_equal(
                    got[f"dim3_f32/{est}/table_sums"], u_sums[est][b0:b1]):
                raise AssertionError(
                    f"f32 day-sharded rank {r} dim3 {est}: U float32 of "
                    f"{nb} bytes is not days [{b0}, {b1}) of one card's "
                    f"{u_bytes[est]} bytes")
        d2, d3 = lc["dim2_f32/f32"], lc["dim3_f32/f32"]
        off = [k for k in ("contract3_weights", "masked_contract3",
                           "contract3_row_flags", "masked_contract3_rebuild")
               if d2[k]] + [k for k in ("sweep_table", "masked_sweep",
                                        "bisect_levels",
                                        "contract3_row_flags",
                                        "masked_contract3_rebuild")
                            if d3[k]]
        if any(any(lc[p].values()) for p in F32_PATHS) or off or \
                d2["sweep_table"] != 4 or d2["masked_sweep"] <= 0 or \
                d2["bisect_levels"] <= 0 or \
                d3["contract3_weights"] != 2 or d3["masked_contract3"] <= 0:
            raise AssertionError(f"f32 day-sharded rank {r}: not the f32 "
                                 f"kernels of its paths {lc}")
        print(f"f32 day-sharded rank {r} of {SHARDED_RANKS} (gloo, one "
              f"card): days [{b0}, {b1}) of {T_u}; f32 launches dim 2 {d2}, "
              f"dim 3 {d3}, f64 launches 0; peak device bytes above each "
              f"path's start {info['peak_bytes']}; U float32 "
              f"{int(got['dim3_f32/msm/table_bytes'])} bytes ({b1 - b0}/"
              f"{T_u} of one card's {u_bytes['msm']}); wall s "
              + ", ".join(f"{k} {v:.3f}" for k, v in info["wall_s"].items())
              + f" ({smi}; the ranks share one card: not a scaling figure)")
        report["day_sharded_f32"]["ranks"].append(
            {k: v for k, v in info.items() if k != "results"})
    print(f"f32 day-sharded: {len(f32_ranks)} ranks, each of {len(f32_series)}"
          " f32 series bit-equal to the one-card f32 series, U float32 of "
          "each rank its block's share of one card's to the byte")
    report["day_sharded_f32"].update(series=sorted(f32_series),
                                     table_bytes_one_card=u_bytes)

    # -- each f32 kernel against its f32 twin ------------------------------
    rng = np.random.default_rng(32)
    ops_m = bts["dim2_msm"].sweep_operands()
    ops3_m = bts["dim3_msm"].sweep_operands()
    T, T3 = ops_m.days, ops3_m.days

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(F32)

    def close(tag, got, want):
        fin = ~torch.isnan(want)
        if not torch.equal(fin, ~torch.isnan(got)):
            raise AssertionError(f"f32 {tag}: NaN cells differ")
        scale = float(want[fin].abs().max())
        err = float((got[fin] - want[fin]).abs().max())
        if not err <= RTOL_F32 * scale:
            raise AssertionError(f"f32 {tag}: |kernel - plain| {err:.3e} > "
                                 f"{RTOL_F32:g} x {scale:.3e}")
        print(f"parity f32 {tag}: max abs {err:.3e} rel {err / scale:.3e} "
              f"(bound rel {RTOL_F32:g})")
        return err

    errs = {}
    p_p, f_p = cq.sweep_table_reference(ops_m)
    if not torch.equal(f_p, ops_m.flags):
        raise AssertionError("f32 sweep_table: flags off the plain twin")
    errs["sweep_table"] = close("sweep_table dim2 MSM", ops_m.P, p_p)
    del p_p, f_p
    stage = np.stack([np.full(T, -100.0), np.full(T, -3.0)], -1)
    lo = rng.uniform(-8.0, -1.0, (3, T))
    bounds = t32(np.concatenate(
        [stage[None], np.stack([lo, lo + rng.uniform(0.0, 3.0, (3, T))],
                               -1)]))
    wrows = t32([[0.5, 0.5], [0.3, 0.7], [0.75, 0.25], [0.9, 0.1]])
    k = cq.masked_sweep(ops_m, bounds, wrows)
    errs["masked_sweep"] = close("masked_sweep dim2 MSM L=4", k,
                                 cq.masked_sweep_reference(ops_m, bounds,
                                                           wrows))
    if not torch.equal(k, cq.masked_sweep(ops_m, bounds, wrows)):
        raise AssertionError("f32 masked_sweep: a repeat gave other bits")
    cfg = (-3.0, -3.5, -2.0, -7.5, 0.0)
    n_iters = full_iters(1e-6, cfg[3], cfg[4])
    obj = t32(LEVELS)

    def k1_state(ops, w, ob):
        F1 = cq.masked_sweep(ops, bounds[:1].expand(len(ob), T, 2)
                             .contiguous(), w)
        return [s.contiguous() for s in bracket_state_batched(
            F1, ob, lambda b: cq.masked_sweep(ops, b.contiguous(), w), cfg,
            False)[:5]]

    st = k1_state(ops_m, wrows, obj)
    _, bisect32 = cs._routes(ops_m, False)
    rk = bisect32(ops_m, *st, obj, wrows, 1e-6, n_iters=n_iters)
    if not torch.equal(rk, cs.fixed_halvings(ops_m, *st, obj, wrows, n_iters,
                                             cq.masked_sweep)):
        raise AssertionError("f32 bisect_levels: K1 off the same count of "
                             "f32 K2 sweeps")
    rp = cs.fixed_halvings(ops_m, *st, obj, wrows, n_iters,
                           cq.masked_sweep_reference)
    errs["bisect_levels"] = float((rk - rp).abs().max())
    kb = root_plateau_bound(ops_m.dx.double(), [0.9])
    if not errs["bisect_levels"] <= kb:
        raise AssertionError(f"f32 bisect_levels: {errs['bisect_levels']:.3e}"
                             f" off its plain twin (bound {kb:.3e})")
    print(f"parity f32 bisect_levels dim2 MSM L=4, {n_iters} halvings: "
          f"bit-equal to {n_iters} f32 K2 sweeps; max abs "
          f"{errs['bisect_levels']:.3e} off the plain twin (plateau bound "
          f"{kb:.3e})")
    days = slice(0, TABLE_DAYS)
    n3 = ops3_m.x.shape[0]
    want3, flags3 = cq3.contract3_table_reference(ops3_m, days)
    if not torch.equal(ops3_m.flags[days], flags3):
        raise AssertionError("f32 contract3_weights: row flags off the plain "
                             "twin")
    errs["contract3_weights"] = close(
        f"contract3_weights dim3 MSM, {TABLE_DAYS} days",
        cq3.table_cells(ops3_m.U[days], n3), want3)
    stage3 = np.stack([np.full(T3, -100.0), np.full(T3, -3.0)], -1)
    lo3 = rng.uniform(-6.0, -0.5, (3, T3))
    b3 = t32(np.concatenate(
        [stage3[None], np.stack([lo3, lo3 + rng.uniform(0.3, 4.0, (3, T3))],
                                -1)]))
    w3r = t32(np.concatenate([np.asarray(w3)[None],
                              rng.dirichlet([2.0, 2.0, 2.0], size=3)]))
    k3 = cq3.masked_contract3(ops3_m, b3, w3r)
    errs["masked_contract3"] = close(
        "masked_contract3 dim3 MSM L=4", k3,
        cq3.masked_contract3_reference(ops3_m, b3, w3r))
    walked = ops3_m._replace(U=None, flags=cq3.contract3_row_flags(ops3_m))
    if not (torch.equal(k3, cq3.masked_contract3_rebuild(walked, b3, w3r))
            and torch.equal(k3, cq3.masked_contract3(ops3_m, b3, w3r))):
        raise AssertionError("f32 rebuild at n=100: off the f32 table sweep")
    flags300 = cq3.contract3_row_flags(ops300)
    if not (torch.equal(flags300, ops300.flags) and torch.equal(
            flags300, cq3.contract3_row_flags_reference(ops300))):
        raise AssertionError("f32 contract3_row_flags: off its plain twin")
    errs["contract3_row_flags"] = 0.0
    st300 = t32(np.stack([np.full(ops300.days, -100.0),
                          np.full(ops300.days, -3.0)], -1)[None])
    w300 = t32(np.asarray(data300.weights)[None])
    r300 = cq3.masked_contract3_rebuild(ops300, st300, w300)
    if not torch.equal(r300, cq3.masked_contract3_rebuild(
            ops300._replace(flags=None), st300, w300)):
        raise AssertionError("f32 rebuild n=300: the truncated and full-row "
                             "walks gave other bits")
    errs["masked_contract3_rebuild"] = close(
        f"masked_contract3_rebuild dim3 MSM n={WIDE_N_TIMED} stage-1", r300,
        cq3.masked_contract3_reference(ops300, st300, w300))
    print("parity f32 rebuild: bit-equal to the f32 table sweep at n=100 "
          "(L=4) and to its full-row walk at n=300; the f32 flags equal to "
          "their twin")

    # -- times (CUDA events, in turns) and device time (torch.profiler) ----
    L128 = ROWS_P * len(LEVELS)
    wr = t32(np.repeat(w_batch, len(LEVELS), axis=0))
    ar = t32(np.tile(levels, ROWS_P))
    st1 = bounds[:1].contiguous()
    st128 = k1_state(ops_m, wr, ar)
    s1 = [s[:1].contiguous() for s in st]
    calls = {
        "sweep_table": (lambda: cq.sweep_table(ops_m),
                        lambda: cq.sweep_table_reference(ops_m)),
        "sweep_L1": (lambda: cq.masked_sweep(ops_m, st1, wrows[:1]),
                     lambda: cq.masked_sweep_reference(ops_m, st1,
                                                       wrows[:1])),
        f"sweep_L{L128}": (
            lambda: cq.masked_sweep(ops_m, st1.expand(L128, T, 2)
                                    .contiguous(), wr),
            lambda: cq.masked_sweep_reference(
                ops_m, st1.expand(L128, T, 2).contiguous(), wr)),
        "bisect_L1": (
            lambda: bisect32(ops_m, *s1, obj[:1], wrows[:1], 1e-6,
                             n_iters=n_iters),
            lambda: cs.fixed_halvings(ops_m, *s1, obj[:1], wrows[:1],
                                      n_iters, cq.masked_sweep_reference)),
        f"bisect_L{L128}": (
            lambda: bisect32(ops_m, *st128, ar, wr, 1e-6, n_iters=n_iters),
            lambda: cs.fixed_halvings(ops_m, *st128, ar, wr, n_iters,
                                      cq.masked_sweep_reference)),
        "contract3_weights": (lambda: cq3.contract3_weights(ops3_m),
                              lambda: cq3.contract3_weights_reference(
                                  ops3_m)),
        "contract3_L1": (
            lambda: cq3.masked_contract3(ops3_m, b3[:1], w3r[:1]),
            lambda: cq3.masked_contract3_reference(ops3_m, b3[:1],
                                                   w3r[:1])),
        "rebuild_n300_L1": (
            lambda: cq3.masked_contract3_rebuild(ops300, st300, w300),
            lambda: cq3.masked_contract3_reference(ops300, st300, w300)),
        "flags_n300": (lambda: cq3.contract3_row_flags(ops300),
                       lambda: cq3.contract3_row_flags_reference(ops300)),
    }
    heavy = ("contract3_weights", "contract3_L1", "rebuild_n300_L1",
             "flags_n300", f"bisect_L{L128}")
    timing = {}
    for key, (kern, plain) in calls.items():
        kw = {"reps": 3, "warmup": 1} if key in heavy else {}
        timing[key] = cuda_ms(torch, {"kernel": kern}, **kw)
        timing[key].update(cuda_ms(
            torch, {"plain": plain},
            **({"reps": 1, "warmup": 0} if key.endswith("n300") else kw)))
    queries = {
        "calc_var_dim2_msm": lambda: bts["dim2_msm"].calc_var(alpha),
        "calc_var_dim2_garch": lambda: bts["dim2_garch"].calc_var(alpha),
        "grid_32x4": lambda: bts["dim2_msm"].calc_var_grid(w_batch, levels),
        "calc_var_dim3_msm": lambda: bts["dim3_msm"].calc_var(alpha),
        "calc_var_dim3_garch": lambda: bts["dim3_garch"].calc_var(alpha),
        "grid_8x4": lambda: bts["dim3_msm"].calc_var_grid(w_batch3, levels),
        "calc_var_dim3_msm_n300": lambda: b32.calc_var(alpha),
    }
    for key, fn in queries.items():
        timing[key] = cuda_ms(torch, {"query": fn},
                              **({"reps": 2, "warmup": 0}
                                 if key.endswith("n300") else
                                 {"reps": 3, "warmup": 1}))
    kern_of = {"sweep_table": "sweep_table", "sweep_L1": "masked_sweep",
               f"sweep_L{L128}": "masked_sweep",
               "bisect_L1": "bisect_levels",
               f"bisect_L{L128}": "bisect_levels",
               "contract3_weights": "contract3_weights",
               "contract3_L1": "masked_contract3",
               "rebuild_n300_L1": "masked_contract3_rebuild",
               "flags_n300": "contract3_row_flags"}
    profiles = {key: device_profile(torch, calls[key][0],
                                    reps=2 if key in heavy else REPS)
                for key in calls}
    profiles.update({key: device_profile(torch, fn, reps=1
                                         if key.endswith("n300") else 3)
                     for key, fn in queries.items()})
    q = ops_m.w1.shape[0]
    n = ops_m.x.shape[0]
    cells, fold, _, _ = walk_cells(ops300.x.double(), st300.double(),
                                   w300.double())
    q3 = ops3_m.w1.shape[0]
    bounds_ms = {
        "sweep_table": table_bound(T, n, q, 4),
        "sweep_L1": sweep_bound(T, n, q, 1, isz=4),
        f"sweep_L{L128}": sweep_bound(T, n, q, L128, isz=4),
        "bisect_L1": bisect_bound(T, n, q, 1, n_iters, 4),
        f"bisect_L{L128}": bisect_bound(T, n, q, L128, n_iters, 4),
        "contract3_weights": weights_bound(T3, n3, q3, True, False, 4),
        "contract3_L1": contract3_bound(
            T3, n3, 1, table_hits(ops3_m.x, b3[:1], w3r[:1]), isz=4),
        "rebuild_n300_L1": rebuild_bound(ops300.days, WIDE_N_TIMED,
                                         ops300.w1.shape[0], 1, True, False,
                                         walk=(cells, fold), isz=4),
        "flags_n300": flags_bound(ops300.days, WIDE_N_TIMED,
                                  ops300.w1.shape[0], True, False, isz=4),
    }
    def f64(key):
        fig = f64_figures.get(key)
        if fig is None:
            return "f64 not measured in this call"
        return (f"f64 call {_ms(fig['call_ms'])} ms, device "
                + _ms(fig["device_ms"], ".4f") + " ms")

    for key, (b_ms, by) in bounds_ms.items():
        dev_ms = profiles[key]["kernels"][kern_of[key]]["device_ms"]
        print(f"f32 {key}: kernel call {timing[key]['kernel'][0]:.3f} ms "
              f"(min {timing[key]['kernel'][1]:.3f}; CUDA events), device "
              + _ms(dev_ms, ".4f") + " ms (torch.profiler), plain twin "
              f"{timing[key]['plain'][0]:.3f} ms; bound {b_ms:.4f} ms by "
              f"{by} at float32 ("
              + ("not measured" if dev_ms is None else f"{b_ms / dev_ms:.1%}")
              + f" of the device time); {f64(key)} ({smi})")
    for key in queries:
        p = profiles[key]
        print(f"f32 query {key}: {timing[key]['query'][0]:.3f} ms per call "
              f"(CUDA events), host {p['wall_ms']:.3f} ms, device busy "
              f"{_ms(p['busy_ms'])} ms, {_ms(p['device_ops'], 'g')} device "
              "ops; " + ", ".join(
                  f"{k} {v['launches']:g} x " + _ms(v["device_ms"], ".4f")
                  + " ms" for k, v in p["kernels"].items() if v["launches"])
              + f"; {f64(key)} ({smi})")
    phase_s = time.perf_counter() - t_phase
    print(f"f32 phase: {phase_s:.3f} s ({smi})")
    report.update(max_abs_err=errs, timing_ms=timing, profile=profiles,
                  bounds_ms=bounds_ms, phase_s=phase_s,
                  walk_cells=cells, n_iters=n_iters)
    k23 = "copula_var_tpu/ops/pallas_quadrature.py"
    k4 = "copula_var_tpu/ops/pallas_quadrature3.py:92"
    rows = (("sweep_table", "quadrature.cu", f"{k23}:101; {k23}:32",
             "sweep_table"),
            ("masked_sweep", "quadrature.cu", f"{k23}:101", "sweep_L1"),
            ("bisect_levels", "quadrature.cu",
             "copula_var_tpu/ops/pallas_solver.py:93", "bisect_L1"),
            ("contract3_weights", "contract3.cu", k4, "contract3_weights"),
            ("masked_contract3", "contract3.cu", k4, "contract3_L1"),
            ("masked_contract3_rebuild", "contract3.cu", k4,
             "rebuild_n300_L1"),
            ("contract3_row_flags", "contract3.cu", k4, "flags_n300"))
    entries = [{"name": f"{name}_f32", "route": "cuda",
                "source": f"copula_var_tpu_torch/csrc/{src}",
                "replaces": rep_, "launches": launches[name][1],
                "max_abs_err": errs[name], "ms": timing[key]["kernel"][0],
                "plain_ms": timing[key]["plain"][0],
                "bound_ms": bounds_ms[key][0], "bound_by": bounds_ms[key][1],
                "library_ms": None}
               for name, src, rep_, key in rows]
    return report, entries


# -- fit phases run in child processes beside the main one ------------------

FIT_CHILD_TIMEOUT_S = 900  # a child fit phase still running by then fails


_LAUNCH_ZERO = {}  # (wrapper, f32) -> its launch count when last zeroed


def _launch_count(wrapper, f32):
    """`wrapper`'s f64 (or f32) kernel launches in this process."""
    import torch
    from copula_var_tpu_torch.ops import cuda_quadrature as cq

    return cq.launch_count(wrapper, torch.float32 if f32 else torch.float64)


def _zero_launches(f32=False):
    """Start every kernel wrapper's f64 launch count (with `f32` its f32
    count too) again from 0."""
    for c in _counters():
        for g in (False, True) if f32 else (False,):
            _LAUNCH_ZERO[c.__name__, g] = _launch_count(c, g)


def _launches(wrapper, f32=False):
    """`wrapper`'s f64 (or f32) kernel launches since its count was last
    zeroed."""
    return (_launch_count(wrapper, f32)
            - _LAUNCH_ZERO.get((wrapper.__name__, f32), 0))


def _counters():
    """Every kernel wrapper (each counts its launches)."""
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_quadrature3 as cq3
    from copula_var_tpu_torch.ops import cuda_solver as cs

    return (cq.sweep_table, cq.masked_sweep, cs.bisect_levels,
            cq3.contract3_weights, cq3.masked_contract3,
            cq3.contract3_row_flags, cq3.masked_contract3_rebuild,
            cs.solve_stages, cs.solve_stages3, cs.bisect3)


def fit_gaps(est, bt, meta):
    """{quantity: (gap, bound)} of the fitted state against meta."""
    import numpy as np

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


def mr_fit_phase(root, smi):
    """Phase 5's fit, counted: `config.run_backtest(data, cfg,
    device="cuda")` of the mean-reverting family with a Student-t copula
    at the record's perturb_scale (the rest at its defaults): the UKF EM,
    the copula fit and the integration inputs on the card, the fits held
    to the artifact's `meta`, the VaR to `data/flagship_mr_var.npz` at
    1e-9. Returns {"wall_s", "fit_gaps", "var_max_err", "launches"}."""
    import numpy as np

    from copula_var_tpu_torch.config import BacktestConfig, run_backtest
    from copula_var_tpu_torch.data import from_csv

    mr = "mean_reverting"
    rec_mr = np.load(os.path.join(root, "data", "flagship_mr_var.npz"))
    meta_mr = json.loads(str(np.load(os.path.join(
        root, "data", f"flagship_artifacts_{mr}.npz"))["meta"]))
    want_mr = rec_mr[f"{mr}_var"]
    counters = _counters()
    _zero_launches()
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
    launches_rb = {c.__name__: _launches(c) for c in counters}
    print(f"run_backtest {mr}: launches {launches_rb}")
    for name in ("sweep_table", "solve_stages", "bisect_levels"):
        if launches_rb[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 f"run_backtest {mr} path")
    if launches_rb["masked_contract3"] or launches_rb["contract3_weights"]:
        raise AssertionError(f"a dim-3 kernel launched on the run_backtest "
                             f"{mr} path")
    return {"wall_s": times_mr, "fit_gaps": gaps_mr,
            "var_max_err": float(diff_mr.max()), "launches": launches_rb}


def dim3_fit_phase(root, smi):
    """Phase 7, counted: `create_var_backtest(device="cuda")` for the
    dim-3 GARCH and MSM (k = 4, basin_iter = BASIN_ITER, seed 0)
    backtests with a Student-t copula from `data/dim3.csv`, the fits held
    to the dim-3 artifacts' `meta` (`fit_gaps`), the VaR to
    `data/dim3_var.npz` at 1e-9, one table U per backtest and K4 alone
    launched. Returns {"report": {est: ...}, "launches": {...}}."""
    import numpy as np
    import torch

    from copula_var_tpu_torch.backtest import create_var_backtest
    from copula_var_tpu_torch.data import from_csv

    rec3 = np.load(os.path.join(root, "data", "dim3_var.npz"))
    w3 = np.asarray(rec3["weights"], np.float64)
    alpha = float(np.load(os.path.join(root, "data",
                                       "flagship_var.npz"))["obj_var"])
    counters = _counters()
    _zero_launches()
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
    launches_fit3 = {c.__name__: _launches(c) for c in counters}
    print(f"dim3 fit path: launches {launches_fit3}")
    if launches_fit3["contract3_weights"] != len(fit3_report):
        raise AssertionError("contract3_weights did not build one table per "
                             "fitted dim-3 backtest")
    if launches_fit3["solve_stages3"] <= 0 or launches_fit3["bisect3"] <= 0:
        raise AssertionError("the fused dim-3 solve never launched on the "
                             "fitted dim-3 path")
    if launches_fit3["masked_sweep"] or launches_fit3["bisect_levels"] or \
            launches_fit3["sweep_table"] or launches_fit3["solve_stages"]:
        raise AssertionError("a dim-2 kernel launched on the fitted dim-3 "
                             "path")
    return {"report": fit3_report, "launches": launches_fit3}


def _fit_child(name, args, path):
    """A spawned child's body: this module's `name`(*args) on cuda:0, its
    result written to `path` as JSON."""
    import torch

    torch.cuda.set_device(0)
    result = globals()[name](*args)
    with open(path, "w") as f:
        json.dump(result, f)


def start_fit_child(name, args, out_dir):
    """Start this module's `name`(*args) in a spawned daemonic process
    (it cannot outlive this one) after the kernels are built -> (process,
    result path)."""
    import multiprocessing

    path = os.path.join(out_dir, f"{name}.json")
    proc = multiprocessing.get_context("spawn").Process(
        target=_fit_child, args=(name, args, path), daemon=True)
    proc.start()
    return proc, path


def join_fit_child(proc, path):
    """The result of a `start_fit_child` process; raises when it failed
    or did not end within FIT_CHILD_TIMEOUT_S."""
    proc.join(FIT_CHILD_TIMEOUT_S)
    name = os.path.basename(path)[:-len(".json")]
    if proc.is_alive():
        proc.terminate()
        proc.join()
        raise AssertionError(f"{name}: still running after "
                             f"{FIT_CHILD_TIMEOUT_S} s")
    if proc.exitcode != 0:
        raise AssertionError(f"{name}: failed with exit code "
                             f"{proc.exitcode} (its traceback is above)")
    with open(path) as f:
        return json.load(f)


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

    # the fit phases 5 (run_backtest) and 7 (dim 3), each in a child
    # process from now on, each joined where it stands below: the fits are
    # launch-bound host work, so they overlap phases 3-6 on the free cores
    fit_dir = tempfile.TemporaryDirectory()
    children = {name: start_fit_child(name, (root, smi), fit_dir.name)
                for name in ("mr_fit_phase", "dim3_fit_phase")}

    counters = _counters()

    def zero_counts():
        _zero_launches()

    def read_counts():
        return {c.__name__: _launches(c) for c in counters}

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
    for name in ("solve_stages", "bisect_levels"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if launches["sweep_table"] != len(bts):
        raise AssertionError("sweep_table did not build one table per dim-2 "
                             "backtest")
    if launches["masked_contract3"] or launches["contract3_weights"] or \
            launches["masked_contract3_rebuild"] or \
            launches["contract3_row_flags"]:
        raise AssertionError("a dim-3 kernel launched on the dim-2 path")

    # -- main path from the CSV, fitted on the card, counted -----------------
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
    for name in ("solve_stages", "bisect_levels"):
        if launches_fit[name] <= 0:
            raise AssertionError(f"{name} never launched on the fit path")
    if launches_fit["sweep_table"] != len(fit_bts):
        raise AssertionError("sweep_table did not build one table per "
                             "fitted backtest")
    if launches_fit["masked_contract3"] or launches_fit["contract3_weights"]:
        raise AssertionError("a dim-3 kernel launched on the fit path")
    del fit_bts

    # -- mean-reverting family: served, counted; then its run_backtest fit
    # (a child process since the build: `mr_fit_phase`) ---------------------
    mr = "mean_reverting"
    rec_mr = np.load(os.path.join(root, "data", "flagship_mr_var.npz"))
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
    launches_mr = read_counts()
    print(f"mean-reverting path (served): launches {launches_mr}")
    for name in ("sweep_table", "solve_stages", "bisect_levels"):
        if launches_mr[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 "mean-reverting path")
    if launches_mr["masked_contract3"] or launches_mr["contract3_weights"]:
        raise AssertionError("a dim-3 kernel launched on the mean-reverting "
                             "path")
    rb_mr = join_fit_child(*children["mr_fit_phase"])
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
    if launches3["solve_stages3"] <= 0 or launches3["bisect3"] <= 0:
        raise AssertionError("the fused dim-3 solve never launched on the "
                             "dim-3 main path")
    if launches3["masked_sweep"] or launches3["bisect_levels"] or \
            launches3["sweep_table"] or launches3["solve_stages"]:
        raise AssertionError("a dim-2 kernel launched on the dim-3 path")
    if launches3["masked_contract3_rebuild"] or \
            launches3["contract3_row_flags"]:
        raise AssertionError("the flagship dim-3 path left its table route")
    cfg = (-3.0, -3.5, -2.0, -7.5, 0.0)
    for est, bt in bts3.items():
        diff = np.abs(vars3[est] - rec3[f"{est}_var"])
        if np.max(diff) <= ATOL_VAR:
            continue
        # which bracket decision flipped: the plain solve on the same card
        r_plain, _ = cs.full_solve_reference(
            bt.sweep_operands(), bt._tensor([alpha]), bt.weights, cfg)
        plain = r_plain[0].cpu().numpy() + bt.data.ptf_mean
        for d in np.flatnonzero(diff > ATOL_VAR):
            print(f"dim3 {est} day {d}: kernel {vars3[est][d]!r}, plain "
                  f"{plain[d]!r}, record {rec3[f'{est}_var'][d]!r}")
        raise AssertionError(f"dim3 {est}: VaR off the record by "
                             f"{np.max(diff):.3e}")

    # -- the dim-3 path fitted from the CSV on the card, counted (a child
    # process since the build: `dim3_fit_phase`) ----------------------------
    fit3 = join_fit_child(*children["dim3_fit_phase"])
    fit3_report, launches_fit3 = fit3["report"], fit3["launches"]
    fit_dir.cleanup()

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
    for name in ("solve_stages", "bisect_levels"):
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
    if launches_r3["solve_stages3"] <= 0 or launches_r3["bisect3"] <= 0:
        raise AssertionError("the fused dim-3 solve never launched on the "
                             "refined dim-3 path")
    if launches_r3["masked_sweep"] or launches_r3["bisect_levels"] or \
            launches_r3["sweep_table"] or launches_r3["solve_stages"]:
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
    for name in ("sweep_table", "solve_stages", "bisect_levels"):
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
    sharded_report, one_card, one_card_peaks, f32_ranks = day_sharded_phase(
        root, smi, w_batch, w_batch3_s)

    # -- grid sharding (parallel/): a (1, 1) grid mesh over one NCCL rank,
    # then gloo ranks sharing the card, each on its outer grid rows -------
    grid_report = grid_sharded_phase(root, smi, w_batch, w_batch3_s,
                                     one_card, one_card_peaks)

    # -- wide grids: dim 2 past K1's day through K2 sweeps, dim 3 past the
    # table through the rebuild kernel, and the minimal plugin, counted ----
    wide_report, wide_entry, flags_entry = wide_grid_phase(root, smi)

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
    r_plain, nd_plain = cs.full_solve_reference(
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
            u_p, f_p = cq3.contract3_table_reference(ops3, days)
            if not torch.equal(ops3.flags[days], f_p):
                raise AssertionError(f"contract3_weights {est} {copula}: "
                                     "row flags off the plain twin")
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
            del u_k, u_p, f_p, close, fin
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
            if not torch.equal(ops_r.flags, ops3.flags[:, rows[0]:rows[1]]):
                raise AssertionError(f"contract3_weights {est} rows {rows}: "
                                     "not the whole table's flags")
            u_k = cq3.table_cells(ops_r.U[days], n3)
            u_p = cq3.contract3_table_reference(ops_r, days)[0]
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
    first = bts3["msm"].sweep_operands()
    u_again, flags_again = cq3.contract3_weights(first)
    if not (torch.equal(first.U, u_again)
            and torch.equal(first.flags, flags_again)):
        raise AssertionError("contract3_weights: a rebuild changed U or its "
                             "flags")
    del first, u_again, flags_again
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
    r_plain3, nd_plain3 = cs.full_solve_reference(
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

    def same_bits(a, b):
        nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(a)
        return torch.equal(nan, torch.isnan(b) if b.is_floating_point()
                           else nan) and torch.equal(a[~nan], b[~nan])

    # the fused dim-3 solve on the dim-3 MSM operands at the query's L = 1
    # and the serving batch's L = 32: solve_stages3 bit-equal to the
    # composed stages (K4 sweeps, bracket_state_batched, the widest
    # bracket) and its states within the sweep's bound of the plain twin;
    # bisect3 on that state bit-equal to the composed bisection
    # (bisect_fixed_count over K4 sweeps, the host's count) and to its
    # launch twin over K4 sweeps (each halving's bounds kept for the
    # bound), its roots within ATOL_ROOT of the plain twin's
    L3 = ROWS_P3 * len(LEVELS)
    n_it3 = cs.max_halvings(cfg, 1e-6)
    fused_rows3 = {1: (obj[2:3], bts3["msm"].weights.reshape(1, 3)
                       .contiguous()),
                   L3: (tens(a_rows3), tens(w_rows3))}
    fused_state3, hits3 = {}, {}
    err_stages3, err_bisect3 = 0.0, 0.0
    for L_, (a_, w_) in fused_rows3.items():
        kept_ = []

        def k4_kept(ops_, b_, w__, box_, kept_=kept_):
            kept_.append(b_.clone())
            return cq3.masked_contract3(ops_, b_, w__, box_)

        state_, _ = cs._stages(ops3_m, a_, w_, cfg, False, -5.0, k4_kept,
                               torch.float64)
        want_ = [s.contiguous() for s in state_] + [
            cs._widest(state_[0], state_[1])]
        got_ = cs.solve_stages3(ops3_m, a_, w_, cfg)
        for name_, g_, v_ in zip(("lower", "upper", "prev_res", "prev_up",
                                  "ustack", "nan_days", "widest"),
                                 got_, want_):
            if not same_bits(g_, v_):
                raise AssertionError(f"solve_stages3 L={L_}: {name_} not "
                                     "bit-equal to the composed route")
        plain_ = cs.solve_stages_reference(ops3_m, a_, w_, cfg)
        for name_, g_, v_ in zip(("ustack", "nan_days"), got_[4:6],
                                 plain_[4:6]):
            if not torch.equal(g_, v_):
                raise AssertionError(f"solve_stages3 L={L_}: {name_} off the "
                                     "plain twin")
        fin = torch.isfinite(plain_[2])
        scale_ = float(plain_[2][fin].abs().max())
        e_s = max(float((g_ - v_)[torch.isfinite(v_)].abs().max())
                  for g_, v_ in zip(got_[:4], plain_[:4]))
        if not e_s <= RTOL_SWEEP * scale_:
            raise AssertionError(f"solve_stages3 L={L_}: |kernel - plain| "
                                 f"{e_s:.3e} > {RTOL_SWEEP:g} x {scale_:.3e}")
        err_stages3 = max(err_stages3, e_s)
        st5 = [t.contiguous() for t in got_[:5]]
        wd = got_[6]
        k_host = cs.halvings(float(wd), 1e-6)
        def hits_(kept_=kept_, w_=w_):
            return sum(table_hits(ops3_m.x, b_, w_, day_chunk=T3, device=dev)
                       for b_ in kept_)

        stage_hits = hits_()
        kept_.clear()
        r_dev = cs.bisect3(ops3_m, *st5, a_, w_, 1e-6, widest=wd,
                           n_iters=n_it3)
        r_fixed = cs.bisect_fixed_count(ops3_m, *st5, a_, w_, 1e-6, k_host,
                                        cq3.masked_contract3)
        r_twin = cs.bisect3_reference(ops3_m, *st5, a_, w_, 1e-6, widest=wd,
                                      n_iters=n_it3, sweep=k4_kept)
        for name_, r_ in (("bisect_fixed_count over K4", r_fixed),
                          ("its launch twin over K4", r_twin)):
            if not same_bits(r_dev, r_):
                raise AssertionError(f"bisect3 L={L_}: roots not bit-equal "
                                     f"to {name_}")
        if not torch.equal(r_dev, cs.bisect3(ops3_m, *st5, a_, w_, 1e-6,
                                             widest=wd, n_iters=n_it3)):
            raise AssertionError(f"bisect3 L={L_}: a repeated launch changed "
                                 "the roots")
        r_plain = cs.bisect3_reference(ops3_m, *st5, a_, w_, 1e-6,
                                       widest=wd, n_iters=n_it3)
        fin = torch.isfinite(r_plain)
        if not torch.equal(fin, torch.isfinite(r_dev)):
            raise AssertionError(f"bisect3 L={L_}: NaN roots off the plain "
                                 "twin's")
        e_b = float((r_dev - r_plain)[fin].abs().max())
        if not e_b <= ATOL_ROOT:
            raise AssertionError(f"bisect3 L={L_}: |kernel - plain| "
                                 f"{e_b:.3e} > {ATOL_ROOT:g}")
        err_bisect3 = max(err_bisect3, e_b)
        hits3[L_] = (stage_hits, hits_(), len(kept_))
        fused_state3[L_] = (st5, wd)
        del kept_, state_, want_, got_, plain_, r_fixed, r_twin, r_plain
        print(f"parity solve_stages3 L={L_}: bit-equal to the composed "
              f"route, widest {float(wd):.17g} ({k_host} halvings, "
              f"{n_it3 + 1} launches), max abs {e_s:.3e} off the plain twin "
              f"(bound rel {RTOL_SWEEP:g}); bisect3: bit-equal to "
              f"bisect_fixed_count and to its launch twin over K4, repeat "
              f"bit-equal, max abs {e_b:.3e} off the plain twin (bound "
              f"{ATOL_ROOT:g})")

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
    # the fused stages on the flagship's operands at the query's L = 1 and
    # the grid's L = 128: bit-equal to the composed route (the K2 stage
    # sweeps, bracket_state_batched and the widest bracket), K1 counting
    # on the device bit-equal to K1 counting on the host, and the states
    # within the sweep's bound of the plain twin
    stage_rows = {1: (obj[2:3], bts["msm"].weights.reshape(1, 2)
                      .contiguous()), L128: (ar, wr)}
    err_stages = 0.0
    for L_, (a_, w_) in stage_rows.items():
        F1_ = cq.masked_sweep(ops_m, st1.expand(L_, T, 2).contiguous(), w_,
                              -5.0)
        want_ = bracket_state_batched(
            F1_, a_, lambda b, w_=w_: cq.masked_sweep(ops_m, b.contiguous(),
                                                      w_, -5.0), cfg, False)
        want_ = [s.contiguous() for s in want_[:6]] + [
            cs._widest(want_[0], want_[1])]
        got_ = cs.solve_stages(ops_m, a_, w_, cfg)
        for name_, g_, v_ in zip(("lower", "upper", "prev_res", "prev_up",
                                  "ustack", "nan_days", "widest"),
                                 got_, want_):
            if not same_bits(g_, v_):
                raise AssertionError(f"solve_stages L={L_}: {name_} not "
                                     "bit-equal to the composed route")
        r_host = cs.bisect_levels(ops_m, *want_[:5], a_, w_, 1e-6)
        r_dev = cs.bisect_levels(ops_m, *got_[:5], a_, w_, 1e-6,
                                 widest=got_[6])
        if not same_bits(r_dev, r_host):
            raise AssertionError(f"bisect_levels L={L_}: the device count's "
                                 "roots differ from the host count's")
        plain_ = cs.solve_stages_reference(ops_m, a_, w_, cfg)
        for name_, g_, v_ in zip(("ustack", "nan_days"), got_[4:6],
                                 plain_[4:6]):
            if not torch.equal(g_, v_):
                raise AssertionError(f"solve_stages L={L_}: {name_} off the "
                                     "plain twin")
        fin = torch.isfinite(plain_[2])
        scale_ = float(plain_[2][fin].abs().max())
        e_ = max(float((g_ - v_)[torch.isfinite(v_)].abs().max())
                 for g_, v_ in zip(got_[:4], plain_[:4]))
        if not e_ <= RTOL_SWEEP * scale_:
            raise AssertionError(f"solve_stages L={L_}: |kernel - plain| "
                                 f"{e_:.3e} > {RTOL_SWEEP:g} x {scale_:.3e}")
        err_stages = max(err_stages, e_)
        print(f"parity solve_stages L={L_}: bit-equal to the composed "
              f"route, widest {float(got_[6]):.17g} "
              f"({cs.halvings(float(got_[6]), 1e-6)} halvings), K1's roots "
              f"from the device count bit-equal; max abs {e_:.3e} off the "
              f"plain twin (bound rel {RTOL_SWEEP:g})")
    timing[f"bisect_L{L128}"] = cuda_ms(torch, {
        "kernel": lambda: cs.bisect_levels(ops_m, *st128, ar, wr, 1e-6),
        "plain": lambda: cs.bisect_levels_reference(ops_m, *st128, ar, wr,
                                                    1e-6)}, reps=3, warmup=1)
    for L_, (a_, w_) in stage_rows.items():
        timing[f"stages_L{L_}"] = cuda_ms(torch, {
            "kernel": lambda a_=a_, w_=w_: cs.solve_stages(ops_m, a_, w_,
                                                           cfg),
            "plain": lambda a_=a_, w_=w_: cs.solve_stages_reference(
                ops_m, a_, w_, cfg)}, **({} if L_ == 1
                                         else {"reps": 3, "warmup": 1}))
    w_main = bts["msm"].weights
    timing["full_L1"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve(ops_m, obj[2:3], w_main, cfg),
        "plain": lambda: cs.full_solve_reference(ops_m, obj[2:3], w_main,
                                                 cfg)})
    timing[f"full_rows{ROWS_P * len(LEVELS)}"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve(ops_m, ar, wr, cfg),
        "plain": lambda: cs.full_solve_reference(ops_m, ar, wr, cfg)},
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
    for L_, (a_, w_) in fused_rows3.items():
        st5, wd = fused_state3[L_]
        timing[f"stages3_L{L_}"] = cuda_ms(torch, {
            "kernel": lambda a_=a_, w_=w_: cs.solve_stages3(ops3_m, a_, w_,
                                                            cfg),
            "plain": lambda a_=a_, w_=w_: cs.solve_stages_reference(
                ops3_m, a_, w_, cfg)}, reps=REPS_DIM3_PLAIN, warmup=1)
        timing[f"bisect3_L{L_}"] = cuda_ms(torch, {
            "kernel": lambda a_=a_, w_=w_, st5=st5, wd=wd: cs.bisect3(
                ops3_m, *st5, a_, w_, 1e-6, widest=wd, n_iters=n_it3),
            "plain": lambda a_=a_, w_=w_, st5=st5, wd=wd: cs.bisect3_reference(
                ops3_m, *st5, a_, w_, 1e-6, widest=wd, n_iters=n_it3)},
            **({"reps": REPS_DIM3_PLAIN, "warmup": 1} if L_ == 1
               else {"reps": 2, "warmup": 0}))
    w3_main = bts3["msm"].weights
    timing["dim3_full_L1"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve(ops3_m, obj[2:3], w3_main, cfg),
        "plain": lambda: cs.full_solve_reference(
            ops3_m, obj[2:3], w3_main, cfg)}, reps=REPS_DIM3_PLAIN, warmup=1)
    # the refine_root trap pass per call (plain PyTorch), beside the
    # unrefined solve of the same rows above (full_L1, full_rows128,
    # dim3_full_L1)
    roots1, _ = cs.full_solve(ops_m, obj[2:3], w_main, cfg)
    roots128, _ = cs.full_solve(ops_m, ar, wr, cfg)
    roots3, _ = cs.full_solve(ops3_m, obj[2:3], w3_main, cfg)
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
        f"sweep_L{L128}": device_profile(torch, lambda: cq.masked_sweep(
            ops_m, st1.expand(L128, T, 2).contiguous(), wr, -5.0)),
        "stages_L1": device_profile(torch, lambda: cs.solve_stages(
            ops_m, *stage_rows[1], cfg)),
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
        f"contract3_L{L3}": device_profile(torch, lambda: cq3.masked_contract3(
            ops3_m, st3.expand(L3, T3, 2).contiguous(), tens(w_rows3[:L3]),
            -5.0), reps=3),
        "stages3_L1": device_profile(torch, lambda: cs.solve_stages3(
            ops3_m, *fused_rows3[1], cfg)),
        "bisect3_L1": device_profile(torch, lambda: cs.bisect3(
            ops3_m, *fused_state3[1][0], *fused_rows3[1], 1e-6,
            widest=fused_state3[1][1], n_iters=n_it3)),
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
        "full_L1": device_profile(torch, lambda: cs.full_solve(
            ops_m, obj[2:3], w_main, cfg)),
        f"full_rows{L128}": device_profile(
            torch, lambda: cs.full_solve(ops_m, ar, wr, cfg), reps=3),
        "dim3_full_L1": device_profile(torch, lambda: cs.full_solve(
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
            "host_calc_var_s": solve_mr,
            "run_backtest_wall_s": rb_mr["wall_s"],
            "fit_gaps": rb_mr["fit_gaps"], "var_max_err": rb_mr["var_max_err"],
            "launches": launches_mr,
            "run_backtest_launches": rb_mr["launches"]},
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
    bounds_ms = {
        "sweep_table": table_bound(T, n, q),
        "sweep_L1": sweep_bound(T, n, q, 1),
        f"sweep_L{L128}": sweep_bound(T, n, q, L128),
        "bisect_L1": bisect_bound(T, n, q, 1, iters[1]),
        f"bisect_L{L128}": bisect_bound(T, n, q, L128, iters[L128]),
        "stages_L1": stages_bound(T, n, 1),
        f"stages_L{L128}": stages_bound(T, n, L128),
        "contract3_weights": weights_bound(
            T3, n3, q3, ops3_m.spec.kind == "student",
            ops3_m.p_cols is not None),
        "contract3_L1": contract3_bound(
            T3, n3, 1, table_hits(ops3_m.x, st3[None], tens(w3[None]))),
        f"contract3_L{L3}": contract3_bound(
            T3, n3, L3, table_hits(ops3_m.x, st3.expand(L3, T3, 2),
                                   tens(w_rows3[:L3]))),
        **{f"stages3_L{L_}": stages3_bound(T3, n3, L_, h_[0])
           for L_, h_ in hits3.items()},
        **{f"bisect3_L{L_}": bisect3_bound(T3, n3, L_, h_[1], h_[2])
           for L_, h_ in hits3.items()},
        f"sweep_rows{r25}_L1": sweep_bound(T, n, q, 1, rows=r25),
        f"contract3_rows{r3_25}_L1": contract3_bound(
            T3, n3, 1, table_hits(ops3_m.x, b3_1, w3_1, rows=(0, r3_25)),
            rows=r3_25),
    }
    # the profile holding each shape's kernel at that L (the serving
    # batches' fused stages run at L = 128, the dim-3 fused solve at 32)
    prof_key = {"sweep_table": ("sweep_table", "sweep_table"),
                "sweep_L1": ("sweep_L1", "masked_sweep"),
                f"sweep_L{L128}": (f"sweep_L{L128}", "masked_sweep"),
                "bisect_L1": ("bisect_L1", "bisect_levels"),
                f"bisect_L{L128}": (f"bisect_L{L128}", "bisect_levels"),
                "stages_L1": ("stages_L1", "solve_stages"),
                f"stages_L{L128}": ("grid_32x4", "solve_stages"),
                "contract3_weights": ("contract3_weights",
                                      "contract3_weights"),
                "contract3_L1": ("contract3_L1", "masked_contract3"),
                f"contract3_L{L3}": (f"contract3_L{L3}", "masked_contract3"),
                "stages3_L1": ("stages3_L1", "solve_stages3"),
                f"stages3_L{L3}": ("dim3_grid_8x4", "solve_stages3"),
                "bisect3_L1": ("bisect3_L1", "bisect3"),
                f"bisect3_L{L3}": ("dim3_grid_8x4", "bisect3"),
                f"sweep_rows{r25}_L1": (f"sweep_rows{r25}_L1",
                                        "masked_sweep"),
                f"contract3_rows{r3_25}_L1": (f"contract3_rows{r3_25}_L1",
                                              "masked_contract3")}
    # a call's device time: the mean launch's times its launches per call
    # (bisect3: n_it3 + 1 launches, the other wrappers one)
    for key, (b_ms, by) in bounds_ms.items():
        prof, kern = prof_key[key]
        k_ = profiles[prof]["kernels"][kern]
        dev_ms = (None if k_["device_ms"] is None
                  else k_["device_ms"] * k_["launches"])
        print(f"bound {key}: {b_ms:.4f} ms by {by}; kernel call "
              f"{timing[key]['kernel'][0]:.3f} ms, device "
              + ("not measured (no trace of the kernel)" if dev_ms is None
                 else f"{dev_ms:.4f} ms in {k_['launches']:g} launches, "
                      f"{b_ms / dev_ms:.1%} of the bound"))
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

    # -- the f32 engine (engine="pallas"), counted -------------------------
    # the f64 figures it prints beside its own, at its keys
    f64_figures = {key: {"call_ms": timing[key]["kernel"][0],
                         "device_ms": profiles[pk]["kernels"][kern][
                             "device_ms"]}
                   for key, (pk, kern) in prof_key.items()
                   if not key.startswith(("sweep_rows", "contract3_rows",
                                          "contract3_L"))
                   or key == "contract3_L1"}
    for key, pk in (("calc_var_dim2_msm", "calc_var_msm"),
                    ("calc_var_dim2_garch", "calc_var_garch"),
                    ("grid_32x4", "grid_32x4"),
                    ("calc_var_dim3_msm", "dim3_calc_var_msm"),
                    ("calc_var_dim3_garch", "dim3_calc_var_garch"),
                    ("grid_8x4", "dim3_grid_8x4")):
        f64_figures[key] = {"call_ms": profiles[pk]["wall_ms"],
                            "device_ms": profiles[pk]["busy_ms"]}
    wide_msm = wide_report["full_T"]["msm"]
    f64_figures["rebuild_n300_L1"] = {
        "call_ms": wide_msm["stage1"]["truncated_ms"][0],
        "device_ms": wide_msm["stage1"]["device_ms"]}
    f64_figures["flags_n300"] = {
        "call_ms": wide_msm["flags"]["kernel_ms"][0],
        "device_ms": wide_msm["flags"]["device_ms"]}
    f64_figures["calc_var_dim3_msm_n300"] = {
        "call_ms": wide_msm["query"]["truncated"]["wall_s"] * 1e3,
        "device_ms": None}
    f32_report, f32_entries = f32_engine_phase(
        root, smi, w_batch, w_batch3, grid, grid3, f64_figures,
        peak3 - base3, f32_ranks, one_card)
    # each f32 kernel's launches on each day-sharded rank's f32 paths
    for e in f32_entries:
        e["day_sharded_f32_launches_per_rank"] = [
            sum(info["launches"][f"{p}/f32"][e["name"][:-len("_f32")]]
                for p in F32_PATHS) for info in f32_ranks]
    report["f32_engine"] = f32_report
    report["bounds_ms"] = bounds_ms
    report["refine"] = refine_report
    report["quirks"] = quirk_report
    report["dim4"] = dim4_report
    report["day_sharded"] = sharded_report
    report["grid_sharded"] = grid_report
    report["grid_parity"] = grid_parity
    report["wide_grid"] = wide_report
    report["halvings"] = iters
    report["fused_dim3"] = {
        "launches_per_bisect3_call": n_it3 + 1,
        "stage_hits": {L_: h_[0] for L_, h_ in hits3.items()},
        "bisect_hits": {L_: h_[1] for L_, h_ in hits3.items()},
        "bisect_sweeps": {L_: h_[2] for L_, h_ in hits3.items()},
        "max_abs_err": {"solve_stages3": err_stages3,
                        "bisect3": err_bisect3}}
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
        # the stage sweeps (K2's slabs) and bracket_state_batched's
        # selects; its figures at the query's L = 1, and at the grid's
        # L = 128 beside them
        dict(entry("solve_stages", "quadrature.cu",
                   f"{k23}:101; copula_var_tpu/ops/solvers.py:124",
                   launches["solve_stages"], err_stages, "stages_L1"),
             ms_L128=timing[f"stages_L{L128}"]["kernel"][0],
             plain_ms_L128=timing[f"stages_L{L128}"]["plain"][0],
             bound_ms_L128=bounds_ms[f"stages_L{L128}"][0],
             bound_by_L128=bounds_ms[f"stages_L{L128}"][1]),
        entry("contract3_weights", "contract3.cu", k4,
              launches3["contract3_weights"], err_u, "contract3_weights"),
        # 0 launches on the main path (the fused dim-3 solve takes it);
        # the composed routes still launch it: each day-sharded rank's
        dict(entry("masked_contract3", "contract3.cu", k4,
                   launches3["masked_contract3"], err3, "contract3_L1"),
             day_sharded_launches_per_rank=[
                 info["launches"]["dim3"]["masked_contract3"]
                 for info in sharded_report["gloo_world"]["ranks"]]),
        # the fused dim-3 solve: its figures at the query's L = 1, and at
        # the serving batch's L = 32 beside them; bisect3's launches are
        # launcher calls, each n_it3 + 1 kernel launches
        *(dict(entry(name_, "contract3.cu", rep_, launches3[name_], err_,
                     f"{key_}_L1"),
               **{f"{f_}_L{L3}": v_ for f_, v_ in (
                   ("ms", timing[f"{key_}_L{L3}"]["kernel"][0]),
                   ("plain_ms", timing[f"{key_}_L{L3}"]["plain"][0]),
                   ("bound_ms", bounds_ms[f"{key_}_L{L3}"][0]),
                   ("bound_by", bounds_ms[f"{key_}_L{L3}"][1]))})
          for name_, rep_, err_, key_ in (
              ("solve_stages3",
               f"{k4}; copula_var_tpu/ops/solvers.py:124", err_stages3,
               "stages3"),
              ("bisect3", f"{k4}; copula_var_tpu/backtest.py:2328",
               err_bisect3, "bisect3"))),
        # their launches: the wide-grid phase's dim-3 series (the only
        # path that takes the rebuild route); their times: the full-T n =
        # 300 stage-1 sweep (its bound the cells the sweep's bounds need,
        # the full cube's beside it) and flag pass
        dict({"name": "masked_contract3_rebuild", "route": "cuda",
              "source": "copula_var_tpu_torch/csrc/contract3.cu",
              "replaces": k4, "library_ms": None,
              "grid_launches_per_rank":
                  grid_launches["masked_contract3_rebuild"]}, **wide_entry),
        dict({"name": "contract3_row_flags", "route": "cuda",
              "source": "copula_var_tpu_torch/csrc/contract3.cu",
              "replaces": k4, "library_ms": None,
              "grid_launches_per_rank":
                  grid_launches["contract3_row_flags"]}, **flags_entry),
    ] + f32_entries
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
