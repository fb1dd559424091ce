"""Diagnostic plots (counterpart of `copula_var_tpu/plots.py`).

The reference's manual visual checks as library functions returning
matplotlib figures (Agg-safe, no `plt.show()`): VaR against realized
portfolio returns (`main.py:6-21`), the filtered MSM state probabilities
against a simulated truth (`markov_switching_multifractal/plots.py:
116-140`), marginals and standardized innovations
(`calc_marginals.py:41-83`), and a residual series (`garch/test.py:
7-47`). Every series may be a numpy array or a tensor on any device.
matplotlib is imported inside `_plt()`, at the first plot: the port
itself does not need it.
"""

from __future__ import annotations

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(a):
    """A host numpy array of a numpy array, a tensor or a sequence."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def var_vs_returns(var_series_dict, portfolio_returns,
                   title="VaR and Portfolio Returns"):
    """Overlay one or more VaR series against realized portfolio returns
    (`main.py:6-21`). var_series_dict: {label: (T,) series}."""
    plt = _plt()
    portfolio_returns = _np(portfolio_returns)
    fig, ax = plt.subplots(figsize=(10, 6))
    x = np.arange(len(portfolio_returns))
    for label, series in var_series_dict.items():
        ax.plot(x, _np(series), label=f"{label} VaR", alpha=0.8)
    ax.plot(x, portfolio_returns, label="Portfolio Returns", linestyle=":",
            alpha=0.7)
    if len(var_series_dict) == 1:
        (series,) = var_series_dict.values()
        exc = portfolio_returns < _np(series)
        ax.scatter(x[exc], portfolio_returns[exc], color="red", s=14,
                   zorder=5, label="exceptions")
    ax.set_title(title)
    ax.set_xlabel("Time")
    ax.set_ylabel("Value")
    ax.legend()
    ax.grid(True)
    return fig


def msm_state_probabilities(state_probs, true_state_index=None,
                            title="MSM filtered state probabilities"):
    """Stackplot of the Hamilton-filtered state distribution over time,
    optionally with the simulated true state index overlaid
    (`plots.py:116-140`). state_probs: (N, 2^k)."""
    plt = _plt()
    state_probs = _np(state_probs)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.stackplot(np.arange(state_probs.shape[0]), state_probs.T, alpha=0.8)
    if true_state_index is not None:
        ax2 = ax.twinx()
        ax2.plot(_np(true_state_index), color="black", lw=0.8,
                 label="true state")
        ax2.set_ylabel("true state index")
        ax2.legend(loc="upper right")
    ax.set_title(title)
    ax.set_xlabel("Time")
    ax.set_ylabel("P(state)")
    return fig


def marginals_and_innovations(marginals, eps, innovations=None,
                              title="Marginals and innovations"):
    """Two-panel diagnostic: predictive marginals, and filtered
    standardized returns vs (optional) true innovations
    (`calc_marginals.py:41-83`)."""
    plt = _plt()
    fig, axs = plt.subplots(2, 1, figsize=(10, 8))
    axs[0].plot(_np(marginals), label="Marginals")
    axs[0].set_title("Predictive marginals")
    axs[0].legend()
    axs[1].plot(_np(eps), label="eps", color="blue")
    if innovations is not None:
        axs[1].plot(_np(innovations), label="Innovations", color="orange",
                    linestyle="--")
    axs[1].set_title("Standardized returns")
    axs[1].legend()
    fig.tight_layout()
    return fig


def residual_series(eps, title="Standardized residuals"):
    """Residual time-series diagnostic (`garch/test.py:24-47`)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(_np(eps), lw=0.7)
    ax.set_title(title)
    ax.set_xlabel("Time")
    ax.grid(True)
    return fig
