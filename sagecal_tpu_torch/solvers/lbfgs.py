"""Full-batch limited-memory BFGS (port of the full-batch half of
``sagecal_tpu/solvers/lbfgs.py``).

Two-loop recursion with circular (s, y) storage, the Fletcher line
search with cubic interpolation (the reference's full-batch default)
and Armijo backtracking. Cost and gradient are plain callables; the SAGE
refine passes ``torch.autograd.grad`` of its cost. The loops are Python
loops whose branch tests read scalars back from the device — the same
decisions the JAX ``while_loop``/``cond`` bodies make. The minibatch
variant with persistent memory is ROADMAP queue A item 8.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

_EPS = 1e-15


class LBFGSMemory(NamedTuple):
    """Curvature pairs: s, y [M, m]; rho [M]; next slot and fill count."""

    s: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor
    head: int
    nfilled: int


def lbfgs_memory_init(m: int, M: int, like: torch.Tensor) -> LBFGSMemory:
    z = like.new_zeros((M, m))
    return LBFGSMemory(s=z, y=z.clone(), rho=like.new_zeros((M,)), head=0,
                       nfilled=0)


def mult_hessian(g, mem: LBFGSMemory):
    """Two-loop recursion: H_k g with implicit H0 = gamma I."""
    M = mem.s.shape[0]
    q = g
    idxs = [(mem.head - 1 - j) % M for j in range(M)]
    alphas = []
    for j in range(M):
        if j < mem.nfilled:
            a = mem.rho[idxs[j]] * torch.dot(mem.s[idxs[j]], q)
        else:
            a = torch.zeros((), dtype=g.dtype, device=g.device)
        q = q - a * mem.y[idxs[j]]
        alphas.append(a)
    if mem.nfilled > 0:
        s_n, y_n = mem.s[idxs[0]], mem.y[idxs[0]]
        gamma = torch.dot(s_n, y_n) / torch.clamp(torch.dot(y_n, y_n),
                                                  min=_EPS)
    else:
        gamma = 1.0
    r = gamma * q
    for j in range(M - 1, -1, -1):
        if j < mem.nfilled:
            bta = mem.rho[idxs[j]] * torch.dot(mem.y[idxs[j]], r)
        else:
            bta = torch.zeros((), dtype=g.dtype, device=g.device)
        r = r + (alphas[j] - bta) * mem.s[idxs[j]]
    return r


def linesearch_backtrack(cost_func: Callable, xk, pk, gk, alpha0,
                         c: float = 1e-4, max_steps: int = 15):
    """Armijo backtracking: halve alpha until f(x + a p) <= f(x) +
    c a p.g (NaN counts as failure)."""
    f0 = float(cost_func(xk))
    slope = c * float(torch.dot(pk, gk))
    alpha = float(alpha0)
    fnew = float(cost_func(xk + alpha * pk))
    i = 0
    while i < max_steps and (fnew != fnew or fnew > f0 + alpha * slope):
        alpha *= 0.5
        fnew = float(cost_func(xk + alpha * pk))
        i += 1
    return alpha


def linesearch_fletcher(cost_func, grad_func, xk, pk, gk=None,
                        alpha1: float = 10.0, sigma: float = 0.1,
                        rho: float = 0.01, t1: float = 9.0, t2: float = 0.1,
                        t3: float = 0.5):
    """Fletcher line search with cubic interpolation (reference lbfgs.c
    ``linesearch`` / ``linesearch_zoom`` / ``cubic_interp``, with the
    JAX package's deviations: exact directional derivatives and the
    cubic minimizer evaluated at z0). Host floats in float64."""
    eps = 1e-30

    def phi(a):
        return float(cost_func(xk + a * pk))

    def dphi(a):
        return float(torch.dot(grad_func(xk + a * pk), pk))

    phi_0 = phi(0.0)
    gphi_0 = float(torch.dot(gk, pk)) if gk is not None else dphi(0.0)
    tol = min(0.01 * phi_0, 1e-6)
    mu = (tol - phi_0) / (rho * gphi_0) if rho * gphi_0 != 0 else (
        float("inf") if tol - phi_0 != 0 else float("nan"))

    def cubic(a, b):
        f0, f1 = phi(a), phi(b)
        f0d, f1d = dphi(a), dphi(b)
        ba = b - a if abs(b - a) > eps else eps
        aa = 3.0 * (f0 - f1) / ba + (f1d - f0d)
        disc = aa * aa - f0d * f1d
        if not disc > 0.0:
            return a if f0 < f1 else b
        cc = disc ** 0.5
        den = f1d - f0d + 2.0 * cc
        z0 = b - (f1d + cc - aa) * ba / (den if abs(den) > eps else eps)
        lo, hi = min(a, b), max(a, b)
        in_bounds = lo <= z0 <= hi and z0 == z0 and abs(z0) != float("inf")
        fz0 = phi(z0) if in_bounds else f0 + f1
        if f0 < f1 and f0 < fz0:
            return a
        return b if f1 < fz0 else z0

    # phase 1: bracketing. code 0 continue, 1 found alphak, 2 zoom
    ci, alphai, alphai1, phi_i1 = 1, alpha1, 0.0, phi_0
    alphak, code, aj, bj = 1.0, 0, 0.0, 0.0
    while ci < 10 and code == 0:
        phi_i = phi(alphai)
        cond0 = phi_i < tol
        cond1 = (phi_i > phi_0 + alphai * gphi_0) or (ci > 1
                                                      and phi_i >= phi_i1)
        gphi_i = dphi(alphai)
        cond2 = abs(gphi_i) <= -sigma * gphi_0
        cond3 = gphi_i >= 0.0
        code = 1 if cond0 else (2 if cond1 else (1 if cond2 else
                                                 (2 if cond3 else 0)))
        if cond0 or (not cond1 and cond2):
            alphak = alphai
        if cond1:
            aj, bj = alphai1, alphai
        elif cond3:
            aj, bj = alphai, alphai1
        if code == 0:
            take_mu = mu <= (2.0 * alphai - alphai1)
            lo = 2.0 * alphai - alphai1
            hi = min(mu, alphai + t1 * (alphai - alphai1))
            alpha_adv = mu if take_mu else cubic(lo, hi)
            alphai1, alphai, phi_i1 = alphai, alpha_adv, phi_i
        ci += 1

    # phase 2: zoom, only when code == 2
    alphaj = 1.0
    if code == 2:
        for _ in range(10):
            alphaj = cubic(aj + t2 * (bj - aj), bj - t3 * (bj - aj))
            phi_j = phi(alphaj)
            phi_aj = phi(aj)
            no_suff = (phi_j > phi_0 + rho * alphaj * gphi_0) \
                or (phi_j >= phi_aj)
            gphi_j = dphi(alphaj)
            term_round = (aj - alphaj) * gphi_j <= 1e-9
            term_curv = abs(gphi_j) <= -sigma * gphi_0
            if no_suff:
                bj = alphaj
            else:
                if gphi_j * (bj - aj) >= 0.0:
                    bj = aj
                aj = alphaj
            if not no_suff and (term_round or term_curv):
                break

    alpha_out = alphak if code == 1 else (alphaj if code == 2 else alphai)
    finite_mu = mu == mu and abs(mu) != float("inf") and abs(mu) > 0
    return alpha_out if finite_mu else mu


def lbfgs_fit(cost_func, grad_func, p0, itmax: int = 20, M: int = 7,
              linesearch: str = "fletcher", return_iters: bool = False):
    """Full-batch LBFGS with fresh memory (reference lbfgs_fit)."""
    mem = lbfgs_memory_init(p0.shape[0], M, p0)
    x = p0
    g = grad_func(x)
    done = bool(torch.linalg.vector_norm(g) < _EPS)
    k = 0
    while k < itmax and not done:
        pk = -mult_hessian(g, mem)
        if linesearch == "backtrack":
            alphak = linesearch_backtrack(cost_func, x, pk, g, 1.0)
        else:
            alphak = linesearch_fletcher(cost_func, grad_func, x, pk, gk=g)
        bad_alpha = not (alphak == alphak and abs(alphak) != float("inf")) \
            or abs(alphak) < 1e-12
        x1 = x + alphak * pk
        g1 = grad_func(x1)
        g1nrm = float(torch.linalg.vector_norm(g1))
        sk = x1 - x
        yk = g1 - g
        lm0 = 1e-6
        if g1nrm > 1e3 * lm0:
            yk = yk + lm0 * sk
        ys = torch.dot(yk, sk)
        rhok = 1.0 / ys if float(ys.abs()) > _EPS else \
            torch.zeros_like(ys)
        finite_g1 = g1nrm == g1nrm and g1nrm != float("inf")
        if not bad_alpha and finite_g1:
            h = mem.head
            s, y, r = mem.s.clone(), mem.y.clone(), mem.rho.clone()
            s[h], y[h], r[h] = sk, yk, rhok
            mem = LBFGSMemory(s=s, y=y, rho=r, head=(h + 1) % M,
                              nfilled=min(mem.nfilled + 1, M))
        done = bad_alpha or not finite_g1 or g1nrm < _EPS
        if not bad_alpha:
            x, g = x1, g1
        k += 1
    return (x, k) if return_iters else x
