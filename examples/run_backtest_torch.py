"""End-to-end example of the PyTorch + CUDA port (`copula_var_tpu_torch`):
the reference `main.py` pipeline on the card.

Runs two out-of-sample VaR backtests over the same 2-asset dataset,
Student copula + GARCH and Student copula + MSM, through
`config.run_backtest`, prints each series' exception rate and optionally
plots both against the realized portfolio returns (`plots.py`). The
counterpart of `examples/run_backtest.py`; it imports only the port.

Data: a local price file with --csv, else a seeded synthetic 2-asset
dataset (a GARCH and an MSM series) simulated on the device. There is no
--tickers: downloading needs the network.

--device picks where everything runs: "cuda" (the default, the kernels)
or "cpu" (the plain twins). --engine "pallas" serves the f32 engine on one
device (roots within one grid cell x |w0| of the f64 "xla" default's);
"sharded" (f64) and "sharded_pallas" (the f32 engine) split the days, and
"grid_sharded" the outer grid rows, over a mesh of one process per card,
under torchrun:

    python examples/run_backtest_torch.py --quick --device cpu
    python examples/run_backtest_torch.py --csv data/flagship.csv --plot var.png
    python examples/run_backtest_torch.py --csv data/flagship.csv --engine pallas
    torchrun --nproc-per-node 4 examples/run_backtest_torch.py --engine sharded
    torchrun --nproc-per-node 4 examples/run_backtest_torch.py \
        --engine sharded_pallas

--save writes the VaR series and the portfolio returns to an .npz.
"""

import argparse
import os
import sys

# runnable as `python examples/run_backtest_torch.py` without installing
# the package: python puts examples/ (not the repo root) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ENGINES = ("xla", "pallas", "sharded", "sharded_pallas", "grid_sharded")
SHARDED = ("sharded", "sharded_pallas", "grid_sharded")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--csv", default=None, help="CSV of adjusted closes")
    ap.add_argument("--n-insample", type=int, default=1135)
    ap.add_argument("--num-points", type=int, default=100)
    ap.add_argument("--k", type=int, default=4, help="MSM components")
    ap.add_argument("--obj-var", type=float, default=0.05)
    ap.add_argument("--synthetic-days", type=int, default=1635)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic dataset")
    ap.add_argument("--plot", default=None, help="output PNG path")
    ap.add_argument("--save", default=None, help="output .npz path")
    ap.add_argument("--quick", action="store_true",
                    help="tiny problem + cheap optimizers (smoke run)")
    ap.add_argument("--engine", default="xla", choices=ENGINES,
                    help="xla: one device, f64; pallas: one device, the "
                         "f32 engine; sharded: the days split over the "
                         "ranks of a torchrun world, f64; sharded_pallas: "
                         "the same with the f32 engine; grid_sharded: the "
                         "outer grid rows split over them")
    return ap.parse_args(argv)


def load_data(args):
    """The returns: --csv, else the seeded synthetic GARCH + MSM pair."""
    from copula_var_tpu_torch import data as data_mod

    if args.csv:
        return data_mod.from_csv(args.csv, args.n_insample)
    n_total = 260 if args.quick else args.synthetic_days
    n_in = 220 if args.quick else args.n_insample
    return data_mod.synthetic_dataset(args.seed, n_total, n_in,
                                      spec=("garch", "msm"),
                                      device=args.device)


def config(args, est, n_insample):
    """The BacktestConfig of one family, as `examples/run_backtest.py`
    builds it (--quick: a small grid and cheap optimizers)."""
    from copula_var_tpu_torch.config import BacktestConfig

    cfg = BacktestConfig(
        estimation_type=est,
        copula_type="student",
        n_insample=n_insample,
        num_points=24 if args.quick else args.num_points,
        engine=args.engine,
    )
    cfg.solver.obj_var = args.obj_var
    cfg.msm.k = 2 if args.quick else args.k
    if args.quick:
        cfg.msm.basin_iter = 10
        cfg.garch.p_max = cfg.garch.q_max = 1
        cfg.garch.newton_max_iter = 40
    return cfg


def main(argv=None):
    args = parse_args(argv)
    from copula_var_tpu_torch.config import run_backtest
    from copula_var_tpu_torch.parallel import distributed

    if args.engine in SHARDED:
        distributed.initialize(device=args.device)  # env:// under torchrun
    lead = distributed.process_info()["process_index"] == 0
    data = load_data(args)
    if lead:
        print(f"data: {data.dim} assets, N={data.n_insample} in-sample, "
              f"T={data.out_sample_n} out-of-sample, device {args.device}")

    results = {}
    for est in ("garch", "msm"):
        bt, var = run_backtest(data, config(args, est, data.n_insample),
                               device=args.device)
        results[est] = var
        if lead:
            print(f"{est}: prep {bt.prep_seconds:.1f}s solve "
                  f"{bt.solve_seconds:.1f}s VaR mean {var.mean():.3f}")

    ptf = data.portfolio_out_sample()
    if lead:
        for est, var in results.items():
            exc = float(np.mean(ptf < var))
            print(f"{est} exceptions at {args.obj_var:.0%}: {exc:.3f}")
        if args.save:
            np.savez(args.save, portfolio=ptf, **results)
            print("series saved to", args.save)
        if args.plot:
            from copula_var_tpu_torch import plots

            fig = plots.var_vs_returns(
                {"MSM": results["msm"], "GARCH": results["garch"]}, ptf,
                title="VaR and Portfolio Returns Over Time")
            fig.savefig(args.plot, dpi=120)
            print("plot saved to", args.plot)
    if args.engine in SHARDED:
        distributed.shutdown()
    return results


if __name__ == "__main__":
    main()
