"""Markov-Switching Multifractal (MSM) volatility model on float64 tensors
(counterpart of `copula_var_tpu/models/msm.py`: state space, transition,
vol states, the Hamilton filter and its log-likelihood, the predictive
marginals, densities and forecasts, and the simulator).

Every function broadcasts the parameters `m_0`, `sigma`, `b`, `gamma`
(batch shape Bp) against `returns` (batch shape Br, then N). The filter
runs on the broadcast batch: a row of candidates on one series (the fit),
rolling windows under one parameter set (the forecasts), or both. When
the parameters' last batch axis is 1 and the returns' is not (windows
under one set per asset), the dense transition is applied as one batched
matrix product per step without copying the matrix per row.

The filter is a Python loop over time whose every step is a few batched
tensor ops, so launches scale with the N steps and not with the rows.

State indexing matches `itertools.product([m_0, 2-m_0], repeat=k)`:
component 0 is the most-significant bit, bit value 1 selects `2 - m_0`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from copula_var_tpu_torch.device import generator
from copula_var_tpu_torch.ops.special import norm_cdf, norm_pdf

# Above this k the dense 2^k x 2^k matvec loses to the factored form.
_DENSE_K_MAX = 6


class MsmParams(NamedTuple):
    """m_0 in (0, 2), sigma > 0, b > 1, gamma in (0, 1)."""

    m_0: torch.Tensor
    sigma: torch.Tensor
    b: torch.Tensor
    gamma: torch.Tensor


def _as(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def state_components(k: int, m_0) -> torch.Tensor:
    """(..., 2^k, k) multiplier combinations, itertools.product order
    (`calc_prob.py:86-89`)."""
    m_0 = torch.as_tensor(m_0, dtype=torch.float64)
    idx = torch.arange(2**k, device=m_0.device)
    shifts = torch.arange(k - 1, -1, -1, device=m_0.device)
    bits = (idx[:, None] >> shifts[None, :]) & 1
    m = m_0[..., None, None]
    return torch.where(bits == 1, 2.0 - m, m)


def component_stay_probs(k: int, b, gamma) -> torch.Tensor:
    """p_j = 1 - gamma_j / 2 with gamma_j = 1 - (1-gamma)^(b^j)
    (`calc_prob.py:93-95`). Shape (..., k)."""
    b = torch.as_tensor(b, dtype=torch.float64)
    gamma = _as(gamma, b)
    j = torch.arange(k, dtype=b.dtype, device=b.device)
    gamma_j = 1.0 - (1.0 - gamma[..., None]) ** (b[..., None] ** j)
    return 1.0 - gamma_j / 2.0


def transition_matrix(k: int, b, gamma) -> torch.Tensor:
    """Dense (..., 2^k, 2^k) transition matrix: the k-fold Kronecker
    product of [[p_j, q_j], [q_j, p_j]] (`calc_prob.py:97-101`)."""
    p = component_stay_probs(k, b, gamma)
    batch = p.shape[:-1]
    mat = torch.ones(batch + (1, 1), dtype=p.dtype, device=p.device)
    for j in range(k):
        pj = p[..., j, None, None]
        f = torch.cat([torch.cat([pj, 1.0 - pj], -1),
                       torch.cat([1.0 - pj, pj], -1)], -2)
        a = mat.shape[-1]
        mat = (mat[..., :, None, :, None] * f[..., None, :, None, :]
               ).reshape(batch + (2 * a, 2 * a))
    return mat


def kron_transition_matvec(p_factors, v):
    """Apply the Kronecker-structured transition to v (..., 2^k) in
    O(k 2^k): per component j (most-significant first), the symmetric
    2x2 contraction [[p_j, 1-p_j], [1-p_j, p_j]] on bit j. p_factors
    (..., k) broadcasts against v's batch."""
    k = p_factors.shape[-1]
    batch = torch.broadcast_shapes(p_factors.shape[:-1], v.shape[:-1])
    t = v.expand(batch + v.shape[-1:])
    for j in range(k):
        a = p_factors[..., j, None, None]
        c = 1.0 - a
        t = t.reshape(batch + (2**j, 2, 2 ** (k - 1 - j)))
        t0, t1 = t[..., 0, :], t[..., 1, :]
        t = torch.stack([a * t0 + c * t1, c * t0 + a * t1], -2)
    return t.reshape(batch + (2**k,))


def vol_states(k: int, m_0, sigma) -> torch.Tensor:
    """sigma_s = sigma * sqrt(prod of state multipliers)
    (`calc_prob.py:103-108`). Shape (..., 2^k)."""
    comps = state_components(k, m_0)
    return _as(sigma, comps)[..., None] * torch.sqrt(torch.prod(comps, -1))


def conditional_probs(returns, vols) -> torch.Tensor:
    """Normal density of each return under each state vol, (..., N, 2^k)
    (`calc_prob.py:110-120`)."""
    return norm_pdf(returns[..., :, None], std=vols[..., None, :])


def _transition_apply(k: int, b, gamma, dense: bool, rows_share: bool):
    if dense:
        P = transition_matrix(k, b, gamma)
        if rows_share:  # (..., R, S) @ (..., S, S): one product per group
            Ps = P.squeeze(-3)
            return lambda v: torch.matmul(v, Ps)
        # symmetric: P @ v == v @ P
        return lambda v: torch.matmul(v[..., None, :], P)[..., 0, :]
    p = component_stay_probs(k, b, gamma)
    return lambda v: kron_transition_matvec(p, v)


def _scan(k, m_0, sigma, b, gamma, returns, dense, keep_states,
          guard=True):
    """The filter over the broadcast batch. Returns (states (..., N, S)
    or only the last state (..., S), cond (..., N, S), norms (..., N)).
    guard=False drops the hold of the previous state where a normalizer
    is not positive: the likelihood is -inf there either way, and every
    other step is bit-identical, with half the ops per step to record
    and differentiate."""
    if dense is None:
        dense = k <= _DENSE_K_MAX
    m_0 = _as(m_0, returns)
    pshape = torch.broadcast_shapes(m_0.shape, _as(sigma, returns).shape,
                                    _as(b, returns).shape,
                                    _as(gamma, returns).shape)
    batch = torch.broadcast_shapes(pshape, returns.shape[:-1])
    rows_share = (len(pshape) > 0 and pshape[-1] == 1 and batch[-1] != 1
                  and len(pshape) == len(batch))
    n_states = 2**k
    vols = vol_states(k, m_0, sigma)
    cond = conditional_probs(returns, vols).expand(
        batch + (returns.shape[-1], n_states))
    apply_P = _transition_apply(k, _as(b, returns), _as(gamma, returns),
                                dense, rows_share)
    prev = torch.full(batch + (n_states,), 1.0 / n_states,
                      dtype=cond.dtype, device=cond.device)
    one = cond.new_tensor(1.0)
    states, norms = [], []
    # unbind, not cond[..., t, :]: an indexed step's backward would build
    # a zero gradient of all of cond, O(N^2) over the scan
    for c_t in torch.unbind(cond, -2):
        unnorm = apply_P(prev) * c_t
        norm = unnorm.sum(-1)
        if guard:
            ok = (norm > 0.0)[..., None]
            prev = torch.where(
                ok, unnorm / torch.where(ok, norm[..., None], one), prev)
        else:
            prev = unnorm / norm[..., None]
        norms.append(norm)
        if keep_states:
            states.append(prev)
    out = torch.stack(states, -2) if keep_states else prev
    return out, cond, torch.stack(norms, -1)


def filter_states(k: int, m_0, sigma, b, gamma, returns, *, dense=None):
    """Hamilton filter (`calc_state_prob_numba`, `calc_prob.py:7-32`).

    Returns (state_probs (..., N, 2^k), cond_probs (..., N, 2^k),
    log_norms (..., N), valid (...) bool). log_norms[i] = log((P
    pi_{i-1}) . c_i) with pi_{-1} uniform, -inf where the normalizer is
    not positive; there the state keeps its previous value, and `valid`
    is False (the reference's -1.0 sentinel array)."""
    states, cond, norms = _scan(k, m_0, sigma, b, gamma, returns, dense,
                                keep_states=True)
    return states, cond, _log_norms(norms), torch.all(norms > 0.0, -1)


def _log_norms(norms):
    return torch.where(norms > 0.0,
                       torch.log(torch.clamp_min(norms, 1e-300)),
                       torch.full_like(norms, -torch.inf))


def log_likelihood(k: int, m_0, sigma, b, gamma, returns, *, dense=None):
    """MSM log-likelihood: sum_{i=1}^{N-1} log((P pi_{i-1}) . c_i)
    (`calc_prob.py:35-47`); -inf on any non-positive term or filter
    failure (`calc_prob.py:134-142`)."""
    _, _, norms = _scan(k, m_0, sigma, b, gamma, returns, dense,
                        keep_states=False, guard=False)
    ll = torch.sum(_log_norms(norms)[..., 1:], -1)
    ok = torch.all(norms > 0.0, -1) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -torch.inf))


def state_marginals(k: int, m_0, sigma, returns):
    """(cond_marginals (..., N, 2^k), eps (..., N, 2^k)): Phi(r_t /
    sigma_s) and the standardized returns (`calc_prob.py:122-132`)."""
    vols = vol_states(k, _as(m_0, returns), sigma)
    eps = returns[..., :, None] / vols[..., None, :]
    return norm_cdf(eps), eps


def marginals(k: int, m_0, sigma, b, gamma, returns, *, dense=None):
    """Predictive marginals with the reference's alignment shift
    (`calc_marginals.py:7-18`): F_t = sum_s pi_t(s) Phi(r_{t-1}/sigma_s)
    via state_probs[1:] x cond_marginals[:-1]. Returns (marginals
    (..., N-1), eps (..., N), vol_states (..., 2^k))."""
    states, _, _, _ = filter_states(k, m_0, sigma, b, gamma, returns,
                                    dense=dense)
    cond_marg, eps_mat = state_marginals(k, m_0, sigma, returns)
    eps = torch.sum(states * eps_mat, -1)
    marg = torch.sum(states[..., 1:, :] * cond_marg[..., :-1, :], -1)
    return marg, eps, vol_states(k, _as(m_0, returns), sigma)


def densities(k: int, m_0, sigma, b, gamma, returns, *, dense=None):
    """Predictive densities, same shift (`calc_marginals.py:21-30`).
    Shape (..., N-1)."""
    states, cond, _, _ = filter_states(k, m_0, sigma, b, gamma, returns,
                                       dense=dense)
    return torch.sum(states[..., 1:, :] * cond[..., :-1, :], -1)


def forecast_state_distribution(k: int, m_0, sigma, b, gamma, returns, *,
                                dense=None):
    """Last filtered state distribution pi_T (`calc_marginals.py:33-38`).
    Shape (..., 2^k)."""
    last, _, _ = _scan(k, m_0, sigma, b, gamma, returns, dense,
                       keep_states=False)
    return last


def log_likelihood_batch(k: int, m_0, sigma, b, gamma, returns):
    """Log-likelihood of one series (N,) under a leading batch of
    candidates (C,) -> (C,)."""
    return log_likelihood(k, m_0, sigma, b, gamma, returns)


def forecast_windows(k: int, m_0, sigma, b, gamma, windows):
    """Forecast distribution over rolling windows (T, N) under one
    parameter set -> (T, 2^k); a parameter batch (A, 1) with windows
    (A, T, N) gives (A, T, 2^k)."""
    return forecast_state_distribution(k, m_0, sigma, b, gamma, windows)


def simulate(seed, k: int, m_0, sigma, b, gamma, n: int, device="cuda"):
    """Simulate an MSM series (`generate_data.py:23-57`). Returns
    (returns (..., n), vol (..., n), eps (..., n), components
    (..., n + 1, k)).

    The components start uniform over {m_0, 2 - m_0}; each step,
    component j flips to 2 - m with probability gamma_j / 2; vol_t =
    sigma sqrt(prod comps_t) over rows 1 .. n; returns = vol N(0, 1).
    `seed` is an int or a `torch.Generator` (whose device is used);
    parameters may carry a batch shape. The stream is torch's, not
    JAX's."""
    gen = generator(seed, device)
    ref = torch.zeros((), dtype=torch.float64, device=gen.device)
    m_0, sigma, b, gamma = (_as(v, ref) for v in (m_0, sigma, b, gamma))
    batch = torch.broadcast_shapes(m_0.shape, sigma.shape, b.shape,
                                   gamma.shape)
    j = torch.arange(k, dtype=ref.dtype, device=ref.device)
    gamma_j = 1.0 - (1.0 - gamma[..., None]) ** (b[..., None] ** j)
    init = torch.rand(batch + (k,), generator=gen, dtype=ref.dtype,
                      device=ref.device) < 0.5
    flips = torch.rand(batch + (n, k), generator=gen, dtype=ref.dtype,
                       device=ref.device) < (gamma_j / 2.0)[..., None, :]
    # a component's bit is its initial bit XOR the parity of its flips
    bits = init[..., None, :] ^ (torch.cumsum(flips.to(torch.int64), -2)
                                 % 2).bool()
    bits = torch.cat([init[..., None, :], bits], -2)
    m = m_0[..., None, None]
    comps = torch.where(bits, 2.0 - m, m)
    vol = sigma[..., None] * torch.sqrt(torch.prod(comps[..., 1:, :], -1))
    eps = torch.randn(batch + (n,), generator=gen, dtype=ref.dtype,
                      device=ref.device)
    return vol * eps, vol, eps, comps
