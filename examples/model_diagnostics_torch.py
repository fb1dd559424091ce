"""Model diagnostics of the PyTorch + CUDA port (`copula_var_tpu_torch`):
the reference's manual `__main__` checks as one offline script
(`markov_switching_multifractal/test.py` + `plots.py`, `garch/test.py`,
`calc_marginals.py:41-83`), the counterpart of
`examples/model_diagnostics.py`; it imports only the port.

Simulates each model family with known parameters on the device,
refits, evaluates the held-out likelihood, and writes diagnostic PNGs
(`plots.py`). The simulators draw from torch's generator, so the series
are not the JAX script's.

    python examples/model_diagnostics_torch.py --device cpu --quick
    python examples/model_diagnostics_torch.py --outdir diag
"""

import argparse
import os
import sys

# runnable as `python examples/model_diagnostics_torch.py` without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--outdir", default="copula_var_diag")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--holdout", type=int, default=500,
                    help="held-out tail length for likelihood evaluation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="short series and cheap optimizers (smoke run)")
    args = ap.parse_args(argv)
    if args.quick:
        args.n, args.holdout = min(args.n, 400), min(args.holdout, 100)
    os.makedirs(args.outdir, exist_ok=True)
    dev = args.device

    from copula_var_tpu_torch import plots
    from copula_var_tpu_torch.models import fit as mfit
    from copula_var_tpu_torch.models import garch, msm, ukf

    def save(fig, name):
        fig.savefig(os.path.join(args.outdir, name), dpi=110)

    # --- MSM: simulate -> fit -> held-out LL -> state-prob stackplot ----
    k_comp, m0, sigma, b, gamma = 4, 0.3, 1.0, 18.0, 0.5
    ret, vol, eps, comps = msm.simulate(args.seed, k_comp, m0, sigma, b,
                                        gamma, args.n, device=dev)
    r = ret.cpu().numpy()
    fit = mfit.fit_msm(r[: -args.holdout], k_comp,
                       basin_iter=10 if args.quick else 40, device=dev)
    hold = ret[-args.holdout:]
    ll_hold = float(msm.log_likelihood(k_comp, fit.m_0, fit.sigma, fit.b,
                                       fit.gamma, hold))
    ll_true = float(msm.log_likelihood(k_comp, m0, sigma, b, gamma, hold))
    print(f"MSM fit: m0={fit.m_0:.3f} b={fit.b:.1f} gamma={fit.gamma:.3f} "
          f"sigma={fit.sigma:.3f}")
    print(f"MSM held-out LL: fitted {ll_hold:.1f} vs true-params "
          f"{ll_true:.1f}")
    head = ret[:400]
    states, _, _, _ = msm.filter_states(k_comp, fit.m_0, fit.sigma, fit.b,
                                        fit.gamma, head)
    save(plots.msm_state_probabilities(states), "msm_states.png")
    marg, eps_f, _ = msm.marginals(k_comp, fit.m_0, fit.sigma, fit.b,
                                   fit.gamma, head)
    save(plots.marginals_and_innovations(marg, eps_f, eps[:400]),
         "msm_marginals.png")

    # --- GARCH: simulate -> BIC fit -> residual plot --------------------
    y, s2, _ = garch.simulate(args.seed + 1, 0.02, [0.08], [0.9], args.n,
                              device=dev)
    gfit = mfit.fit_garch(y.cpu().numpy(), p_max=2, q_max=2,
                          max_iter=40 if args.quick else 100, device=dev)
    print(f"GARCH BIC pick: (p,q)=({gfit.p},{gfit.q}) omega={gfit.omega:.4f} "
          f"alpha={np.round(gfit.alpha, 3)} beta={np.round(gfit.beta, 3)}")
    eps_g = garch.standardized_residuals(y, gfit.omega, gfit.alpha,
                                         gfit.beta)
    save(plots.residual_series(eps_g, "GARCH standardized residuals"),
         "garch_residuals.png")

    # --- UKF: simulate -> EM fit -> vol-path overlay --------------------
    X, vol_u, r_u = ukf.simulate(args.seed + 2, 0.95, 0.0, 0.2, args.n,
                                 device=dev)
    ufit = mfit.fit_ukf_em(r_u.cpu().numpy(),
                           max_iter=20 if args.quick else 60, device=dev)
    print(f"UKF EM fit: a={ufit.a:.3f} l={ufit.l:.3f} q={ufit.q:.3f}")
    vols = ukf.vol_path(r_u, ufit.a, ufit.l, ufit.q)
    plt = plots._plt()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(vol_u[:500].cpu().numpy(), label="true vol")
    ax.plot(vols[:500].cpu().numpy(), label="UKF estimate", linestyle="--")
    ax.legend()
    ax.set_title("UKF stochastic-volatility tracking")
    save(fig, "ukf_vol.png")

    print("diagnostics written to", args.outdir)


if __name__ == "__main__":
    main()
