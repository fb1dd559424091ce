#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`copula_var_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port still builds and serves.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: name, capability, `nvidia-smi` name and power limit;
  2. build: compile the CUDA kernels from `copula_var_tpu_torch/csrc`;
  3. main path, counted: `from_csv` -> `load_artifacts(device="cuda")` ->
     `calc_var(0.05)` for the flagship MSM and GARCH artifacts (2 assets,
     T = 500 days, 100-point grid, Student-t copula), held against
     `data/flagship_var.npz` at atol 1e-9 with the recorded coverage
     statistics recomputed; then a serving batch, `calc_var_grid` with
     32 portfolios x 4 levels (128 rows). Every kernel launch counter is
     zeroed before and read after; each kernel must have launched;
  4. parity: each kernel against its plain PyTorch twin on the card, at
     the flagship shapes (q = 5 and q = 1, stage and random bounds,
     unequal weights), and the serving batch against the plain solve;
  5. timings: CUDA events after warm-up, median and min of REPS reps,
     kernel and plain twin taken in turns;
  6. device profile: torch.profiler over REPS calls of a sweep, a
     bisection, `calc_var` and the serving batch: host ms per call, the
     device's busy ms, and each kernel's device ms per launch.

Prints the kernels' JSON record on the line before the last, and as the
last line `{"ok": true, "device": {...}}`. Exits non-zero, with no result
line, when torch sees no CUDA device or the port's sources are missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPS = 10
ROWS_P = 32  # serving batch: portfolios x LEVELS
LEVELS = (0.01, 0.025, 0.05, 0.1)
ATOL_VAR = 1e-9  # tests/test_flagship.py holds the f64 record to this
# kernel sweep vs plain sweep: the two sum ~n^2 float64 terms in
# different orders (kernel: masked U = V .* (wfc W1) per warp; plain:
# W0 (V .* M) W1^T then . FC), so they agree to a few ulps of the scale
RTOL_SWEEP = 1e-12
# kernel bisection vs plain bisection: identical masks and bookkeeping;
# a root could move only if a slab's rounding flipped res < obj
ATOL_ROOT = 1e-9


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


def device_profile(torch, fn, reps=REPS):
    """Per call of `fn`, traced by torch.profiler after one warm-up call:
    host wall ms, device busy ms (the union of the device's activity
    intervals), and for each of the port's kernels its launches and mean
    device ms per launch (None when the trace holds none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    kernels = {}
    for k in ("masked_sweep", "bisect_levels"):
        us = [b - a for a, b, name in spans if f"{k}_kernel" in name]
        kernels[k] = {"launches": len(us) / reps,
                      "device_ms": sum(us) / len(us) / 1e3 if us else None}
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3 / reps,
            "kernels": kernels}


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
    from copula_var_tpu_torch.data import from_csv
    from copula_var_tpu_torch.ops import _build
    from copula_var_tpu_torch.ops import cuda_quadrature as cq
    from copula_var_tpu_torch.ops import cuda_solver as cs
    from copula_var_tpu_torch.ops.solvers import bracket_state_batched
    from copula_var_tpu_torch.utils.artifacts import load_artifacts

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
    _build.build(force=True)
    _build.load()
    print(f"build: {_build.build_seconds:.2f} s "
          f"({_build.library_path().relative_to(root)})")
    for line in _build.build_log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"  {line.strip()}")

    # -- main path, counted ------------------------------------------------
    rec = np.load(os.path.join(root, "data", "flagship_var.npz"))
    alpha = float(rec["obj_var"])
    rng = np.random.default_rng(0)
    w_batch = rng.dirichlet([2.0, 2.0], size=ROWS_P)
    levels = np.array(LEVELS)
    cq.masked_sweep.launches = 0
    cs.bisect_levels.launches = 0
    t_main = time.perf_counter()
    bts, prep_s, solve_s = {}, {}, {}
    for est in ("msm", "garch"):
        t0 = time.perf_counter()
        data = from_csv(os.path.join(root, "data", "flagship.csv"),
                        n_insample=int(rec["n_insample"]))
        bt = load_artifacts(
            os.path.join(root, "data", f"flagship_artifacts_{est}.npz"),
            data, device="cuda",
        )
        bt.sweep_operands()
        t1 = time.perf_counter()
        var = bt.calc_var(alpha)
        solve_s[est] = time.perf_counter() - t1
        prep_s[est] = t1 - t0
        want = rec[f"{est}_var"]
        if var.shape != want.shape or not np.all(np.isfinite(var)):
            raise AssertionError(f"{est}: bad VaR series {var.shape}")
        err = float(np.max(np.abs(var - want)))
        if err > ATOL_VAR:
            raise AssertionError(f"{est}: VaR off the record by {err:.3e}")
        ptf = data.portfolio_out_sample()
        rate = stats.exception_rate(ptf, var)
        kup = stats.kupiec_pof(ptf, var, alpha).p_value
        if abs(rate - float(rec[f"{est}_exception_rate"])) > 1e-12 or \
                abs(kup - float(rec[f"{est}_kupiec_p"])) > 1e-9:
            raise AssertionError(f"{est}: coverage statistics moved")
        print(f"main path {est}: max |VaR - record| = {err:.3e} "
              f"(bound {ATOL_VAR:g}), exception rate {rate:.4f}, Kupiec p "
              f"{kup:.4f}; load+prep {prep_s[est]:.3f} s, calc_var "
              f"{solve_s[est]:.3f} s (host clock)")
        bts[est] = bt
    t0 = time.perf_counter()
    grid = bts["msm"].calc_var_grid(w_batch, levels)
    grid_s = time.perf_counter() - t0
    if grid.shape != (ROWS_P, len(LEVELS), 500) or not np.all(np.isfinite(grid)):
        raise AssertionError(f"calc_var_grid: bad output {grid.shape}")
    launches = {"masked_sweep": cq.masked_sweep.launches,
                "bisect_levels": cs.bisect_levels.launches}
    print(f"main path: {time.perf_counter() - t_main:.3f} s, serving batch "
          f"{ROWS_P}x{len(LEVELS)} {grid_s:.3f} s, launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    # -- parity: kernels vs plain twins on the card ---------------------------
    def tens(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    wrows = tens([[0.5, 0.5], [0.3, 0.7], [0.75, 0.25], [0.9, 0.1]])
    obj = tens(LEVELS)
    cfg = (-3.0, -3.5, -2.0, -7.5, 0.0)
    err_sweep, err_root = 0.0, 0.0
    states = {}
    for est, bt in bts.items():
        ops = bt.sweep_operands()
        T = ops.V.shape[0]
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
        err_root = max(err_root, e_r)
        print(f"parity {est} (q={ops.w1.shape[0]}): masked_sweep max abs "
              f"{e:.3e} rel {e / scale:.3e} (bound rel {RTOL_SWEEP:g}); "
              f"bisect_levels max abs {e_r:.3e} (bound {ATOL_ROOT:g})")
    ops_m = bts["msm"].sweep_operands()
    w_rows = np.repeat(w_batch, len(LEVELS), axis=0)
    a_rows = np.tile(levels, ROWS_P)
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

    # -- timings on the card --------------------------------------------------
    T = ops_m.V.shape[0]
    timing = {}
    for est, bt in bts.items():  # day-tensor prep is plain PyTorch
        timing[f"prep_{est}"] = cuda_ms(torch, {
            "plain": lambda bt=bt: bt.adapter.day_tensors(
                bt.integration_inputs, bt.copula_spec)})
    st1 = torch.stack([torch.full((T,), -100.0, device=dev),
                       torch.full((T,), -3.0, device=dev)], -1).double()
    for L in (1, ROWS_P * len(LEVELS)):
        b = st1.expand(L, T, 2).contiguous()
        w = tens(w_rows[:L]) if L > 1 else wrows[:1].contiguous()
        timing[f"sweep_L{L}"] = cuda_ms(torch, {
            "kernel": lambda b=b, w=w: cq.masked_sweep(ops_m, b, w, -5.0),
            "plain": lambda b=b, w=w: cq.masked_sweep_reference(ops_m, b, w,
                                                                -5.0)})
    ops_b, st_b = states["msm"]
    s1 = [s[:1].contiguous() for s in st_b]
    timing["bisect_L1"] = cuda_ms(torch, {
        "kernel": lambda: cs.bisect_levels(ops_b, *s1, obj[:1], wrows[:1],
                                           1e-6),
        "plain": lambda: cs.bisect_levels_reference(ops_b, *s1, obj[:1],
                                                    wrows[:1], 1e-6)})
    w_main = bts["msm"].weights
    timing["full_L1"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve_levels(ops_m, obj[2:3], w_main, cfg),
        "plain": lambda: cs.full_solve_levels_reference(ops_m, obj[2:3],
                                                        w_main, cfg)})
    wr, ar = tens(w_rows), tens(a_rows)
    timing[f"full_rows{ROWS_P * len(LEVELS)}"] = cuda_ms(torch, {
        "kernel": lambda: cs.full_solve_portfolios(ops_m, ar, wr, cfg),
        "plain": lambda: cs.full_solve_portfolios_reference(ops_m, ar, wr,
                                                            cfg)})
    for name, res in timing.items():
        print(f"time {name}: " + ", ".join(
            f"{k} median {v[0]:.3f} ms min {v[1]:.3f} ms"
            for k, v in res.items()))

    # -- device time inside those calls (torch.profiler) ----------------------
    profiles = {
        "sweep_L1": device_profile(torch, lambda: cq.masked_sweep(
            ops_m, st1[None].contiguous(), wrows[:1].contiguous(), -5.0)),
        "bisect_L1": device_profile(torch, lambda: cs.bisect_levels(
            ops_b, *s1, obj[:1], wrows[:1], 1e-6)),
        "calc_var_msm": device_profile(torch, lambda: bts["msm"].calc_var(alpha)),
        "calc_var_garch": device_profile(
            torch, lambda: bts["garch"].calc_var(alpha)),
        "grid_32x4": device_profile(
            torch, lambda: bts["msm"].calc_var_grid(w_batch, levels)),
    }
    for name, p in profiles.items():
        print(f"profile {name}: host {p['wall_ms']:.3f} ms/call, device busy "
              f"{p['busy_ms']:.3f} ms/call; " + ", ".join(
                  f"{k} {v['launches']:g} launches x "
                  + ("not measured" if v["device_ms"] is None
                     else f"{v['device_ms']:.4f} ms")
                  for k, v in p["kernels"].items()))
    print("report " + json.dumps({
        "card": smi, "reps": REPS, "build_s": _build.build_seconds,
        "day_tensor_bytes": int(ops_m.V.numel() * 8),
        "host_prep_s": prep_s, "host_calc_var_s": solve_s,
        "host_grid_s": grid_s, "timing_ms": timing, "profile": profiles,
    }))

    kernels = [
        {"name": "masked_sweep", "route": "cuda",
         "source": "copula_var_tpu_torch/csrc/quadrature.cu",
         "replaces": "copula_var_tpu/ops/pallas_quadrature.py:101",
         "launches": launches["masked_sweep"], "max_abs_err": err_sweep,
         "ms": timing["sweep_L1"]["kernel"][0],
         "plain_ms": timing["sweep_L1"]["plain"][0]},
        {"name": "bisect_levels", "route": "cuda",
         "source": "copula_var_tpu_torch/csrc/quadrature.cu",
         "replaces": "copula_var_tpu/ops/pallas_solver.py:93",
         "launches": launches["bisect_levels"], "max_abs_err": err_root,
         "ms": timing["bisect_L1"]["kernel"][0],
         "plain_ms": timing["bisect_L1"]["plain"][0]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
