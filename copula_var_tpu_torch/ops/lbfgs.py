"""Batched box-constrained L-BFGS (counterpart of
`copula_var_tpu/ops/lbfgs.py::box_lbfgs_batch`).

B independent bounded solves advance in lockstep: every loss and
gradient evaluation is one call on all B rows. The box is the JAX
version's smooth tanh map onto the open box (lo, hi); a non-finite loss
maps to a PENALTY plateau with zero gradient, so the line search backs
off exactly as the reference's 1e10 convention does. The JAX version
runs optax L-BFGS with a zoom line search under vmap;
`torch.optim.LBFGS` is neither batched nor bounded, so this module
writes its own: memory 10, a strong-Wolfe zoom line search (Nocedal and
Wright, algorithms 3.5 and 3.6, cubic steps with a bisection safeguard),
exact gradients from autograd. It is held to the JAX optimum, not to
optax's trajectory.

Host reads: one per line-search evaluation and one per iteration, for
the loops' exits; none inside the loss.
"""

from __future__ import annotations

import torch

PENALTY = 1e10
MEMORY = 10
_C1, _C2 = 1e-4, 0.9  # strong-Wolfe constants (optax's zoom defaults)
_LS_STEPS = 30  # evaluations per line search


def _to_box(s, lo, hi):
    c = 0.5 * (lo + hi)
    r = 0.5 * (hi - lo)
    return c + r * torch.tanh(s)


def _from_box(x, lo, hi, margin=1e-6):
    c = 0.5 * (lo + hi)
    r = 0.5 * (hi - lo)
    z = torch.clamp((x - c) / r, -1.0 + margin, 1.0 - margin)
    return torch.atanh(z)


def _two_loop(g, S, Y, rho, gamma):
    """L-BFGS direction -H g from the memory (B, m, d), newest pair in
    slot 0; empty slots carry rho = 0 and contribute nothing."""
    q = g
    alphas = []
    for i in range(S.shape[1]):
        a = rho[:, i] * (S[:, i] * q).sum(-1)
        q = q - a[:, None] * Y[:, i]
        alphas.append(a)
    r = gamma[:, None] * q
    for i in reversed(range(S.shape[1])):
        b = rho[:, i] * (Y[:, i] * r).sum(-1)
        r = r + S[:, i] * (alphas[i] - b)[:, None]
    return -r


def _cubic_step(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi):
    """Minimizer of the cubic through both ends (Nocedal and Wright 3.59),
    or the midpoint when it is not finite or lies within a tenth of the
    interval of either end."""
    d1 = d_lo + d_hi - 3.0 * (f_lo - f_hi) / (a_lo - a_hi)
    d2 = torch.sign(a_hi - a_lo) * torch.sqrt(d1 * d1 - d_lo * d_hi)
    a_c = a_hi - (a_hi - a_lo) * (d_hi + d2 - d1) / (d_hi - d_lo + 2.0 * d2)
    left = torch.minimum(a_lo, a_hi)
    width = (a_hi - a_lo).abs()
    ok = (torch.isfinite(a_c) & (a_c > left + 0.1 * width)
          & (a_c < left + 0.9 * width))
    return torch.where(ok, a_c, 0.5 * (a_lo + a_hi))


def _line_search(vg, s, f0, g0, d, todo):
    """Strong-Wolfe zoom line search along d for the rows in `todo`
    (bool (B,)). Returns (alpha, f, g) per row: the accepted step, or the
    best step that met sufficient decrease (alpha 0 when none did)."""
    B = s.shape[0]
    dphi0 = (g0 * d).sum(-1)
    zero = torch.zeros_like(f0)
    # bracketing ("prev") and zoom ("lo", "hi") ends; "lo" always meets
    # sufficient decrease and is the fallback
    a_lo, f_lo, d_lo, g_lo = zero, f0, dphi0, g0
    a_hi, f_hi, d_hi = zero, f0, dphi0
    a_try = torch.ones_like(f0)
    zoom = torch.zeros(B, dtype=torch.bool, device=s.device)
    done = ~todo
    out_a, out_f, out_g = zero, f0, g0
    for step in range(_LS_STEPS):
        if bool(done.all()):
            break
        a = torch.where(zoom, _cubic_step(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi),
                        a_try)
        f, g = vg(s + a[:, None] * d)
        dphi = (g * d).sum(-1)
        high = f > f0 + _C1 * a * dphi0
        curv = dphi.abs() <= -_C2 * dphi0
        live = ~done
        # bracketing phase: a too long -> zoom on [lo, a]
        b_hi = live & ~zoom & (high | ((step > 0) & (f >= f_lo)))
        b_ok = live & ~zoom & ~b_hi & curv
        b_flip = live & ~zoom & ~b_hi & ~b_ok & (dphi >= 0)  # zoom on [a, lo]
        b_grow = live & ~zoom & ~b_hi & ~b_ok & ~b_flip
        # zoom phase
        z_hi = live & zoom & (high | (f >= f_lo))
        z_ok = live & zoom & ~z_hi & curv
        z_lo = live & zoom & ~z_hi & ~z_ok
        z_swap = z_lo & (dphi * (a_hi - a_lo) >= 0)

        accept = b_ok | z_ok
        out_a = torch.where(accept, a, out_a)
        out_f = torch.where(accept, f, out_f)
        out_g = torch.where(accept[:, None], g, out_g)
        # new hi: a (b_hi, z_hi), the old lo (b_flip, z_swap)
        to_a = b_hi | z_hi
        to_lo = b_flip | z_swap
        a_hi = torch.where(to_a, a, torch.where(to_lo, a_lo, a_hi))
        f_hi = torch.where(to_a, f, torch.where(to_lo, f_lo, f_hi))
        d_hi = torch.where(to_a, dphi, torch.where(to_lo, d_lo, d_hi))
        # new lo: a (b_flip, b_grow, z_lo)
        new_lo = b_flip | b_grow | z_lo
        a_lo = torch.where(new_lo, a, a_lo)
        f_lo = torch.where(new_lo, f, f_lo)
        d_lo = torch.where(new_lo, dphi, d_lo)
        g_lo = torch.where(new_lo[:, None], g, g_lo)
        a_try = torch.where(b_grow, 2.0 * a, a_try)
        zoom = zoom | b_hi | b_flip
        done = done | accept
    fall = ~done & todo
    out_a = torch.where(fall, a_lo, out_a)
    out_f = torch.where(fall, f_lo, out_f)
    out_g = torch.where(fall[:, None], g_lo, out_g)
    return out_a, out_f, out_g


def box_lbfgs_batch(loss_fn, lo, hi, x0, *args, batched_args=(),
                    max_iter=200, tol=1e-8, fwd_grad=False):
    """Minimize `loss_fn(x, *args, *batched_args)` from each row of x0
    (B, d) subject to lo < x < hi. `loss_fn` maps rows x (B, d) to (B,),
    each row's value depending on its own row of x and of every tensor in
    `batched_args` only; `args` are shared. Returns (x_star (B, d),
    f_star (B,)).

    Stopping rules per row, as the JAX version: iteration 0 always runs;
    a row stops once it has made `max_iter` updates, when its gradient
    norm falls below `tol`, or after 3 straight iterations whose loss
    changed by at most 10 eps max(1, |f|). Non-finite losses map to
    PENALTY and non-finite gradients to 0.

    `fwd_grad` is accepted for the JAX signature; there it picks forward
    mode to dodge TPU tile padding of scan residuals. Gradients here come
    from reverse-mode autograd either way.
    """
    del fwd_grad
    x0 = torch.as_tensor(x0, dtype=torch.float64)
    dev = x0.device
    lo = torch.as_tensor(lo, dtype=x0.dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=x0.dtype, device=dev)
    eps = torch.finfo(x0.dtype).eps
    B, dim = x0.shape

    def vg(s):
        with torch.enable_grad():
            s_ = s.detach().requires_grad_(True)
            v = loss_fn(_to_box(s_, lo, hi), *args, *batched_args)
            v = torch.where(torch.isfinite(v), v, torch.full_like(v, PENALTY))
            (g,) = torch.autograd.grad(v.sum(), s_, allow_unused=True)
        g = torch.zeros_like(s) if g is None else g
        return v.detach(), torch.where(torch.isfinite(g), g,
                                       torch.zeros_like(g))

    s = _from_box(x0, lo, hi)
    f, g = vg(s)
    S = torch.zeros(B, MEMORY, dim, dtype=x0.dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros(B, MEMORY, dtype=x0.dtype, device=dev)
    gamma = torch.ones(B, dtype=x0.dtype, device=dev)
    has_mem = torch.zeros(B, dtype=torch.bool, device=dev)
    f_prev = torch.full_like(f, torch.inf)
    stall = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for it in range(max_iter):
        if it > 0:
            active = active & (g.norm(dim=-1) >= tol) & (stall < 3)
            if not bool(active.any()):
                break
        stall_n = torch.where(
            (f - f_prev).abs() <= 10.0 * eps * torch.clamp_min(f.abs(), 1.0),
            stall + 1, torch.zeros_like(stall))
        gnorm = g.norm(dim=-1)
        scale = torch.where(has_mem, gamma,
                            1.0 / torch.clamp_min(gnorm, 1.0))
        d = _two_loop(g, S, Y, rho, scale)
        descent = (d * g).sum(-1) < 0
        d = torch.where(descent[:, None], d, -scale[:, None] * g)
        a, f_new, g_new = _line_search(vg, s, f, g, d, active & (gnorm > 0))
        s_new = s + a[:, None] * d
        sk, yk = s_new - s, g_new - g
        sy, yy = (sk * yk).sum(-1), (yk * yk).sum(-1)
        keep = active & (sy > 0) & torch.isfinite(sy)
        S = torch.where(keep[:, None, None],
                        torch.cat([sk[:, None], S[:, :-1]], 1), S)
        Y = torch.where(keep[:, None, None],
                        torch.cat([yk[:, None], Y[:, :-1]], 1), Y)
        rho = torch.where(keep[:, None],
                          torch.cat([(1.0 / sy)[:, None], rho[:, :-1]], 1),
                          rho)
        gamma = torch.where(keep, sy / yy, gamma)
        has_mem = has_mem | keep
        upd = active
        s = torch.where(upd[:, None], s_new, s)
        f_prev = torch.where(upd, f, f_prev)
        f = torch.where(upd, f_new, f)
        g = torch.where(upd[:, None], g_new, g)
        stall = torch.where(upd, stall_n, stall)
    return _to_box(s, lo, hi), f
