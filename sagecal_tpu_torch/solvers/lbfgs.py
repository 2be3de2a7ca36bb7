"""Limited-memory BFGS, full-batch and persistent-memory stochastic (port
of ``sagecal_tpu/solvers/lbfgs.py``).

Two-loop recursion with circular (s, y) storage, the Fletcher line
search with cubic interpolation (the reference's full-batch default)
and Armijo backtracking. Cost and gradient are plain callables; the SAGE
refine passes ``torch.autograd.grad`` of its cost. The loops are Python
loops whose branch tests read scalars back from the device — the same
decisions the JAX ``while_loop``/``cond`` bodies make.

The stochastic half (:func:`lbfgs_fit_minibatch`, the JAX
``_lbfgs_loop`` with ``stochastic=True``) carries an
:class:`LBFGSMemory` across minibatches: the curvature pairs, the global
iteration count ``niter`` and the online gradient mean and variance
behind the adaptive first step. It runs on lanes (:func:`
lbfgs_minibatch_lanes`): W independent problems whose cost is one [W]
vector, each lane with its own step, stop, slot, fill and count, frozen
once it stops, as the JAX ``vmap`` of the ``while_loop`` freezes it; one
problem is one lane.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

_EPS = 1e-15
#: Armijo halvings of the stochastic line search (lbfgs.c:444); after the
#: last one the step is taken untested
MAX_HALVINGS = 15


class LBFGSMemory(NamedTuple):
    """Curvature pairs: s, y [M, m]; rho [M]; next slot and fill count;
    for the stochastic path (the reference's persistent_data_t) also the
    iteration count across minibatches and the online gradient mean and
    (co)variance accumulator [m]. On lanes every field gains a leading
    [W] axis, and ``head``, ``nfilled`` and ``niter`` are host int arrays
    [W]; a single memory holds Python ints."""

    s: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor
    head: int
    nfilled: int
    niter: int = 0
    running_avg: torch.Tensor | None = None
    running_avg_sq: torch.Tensor | None = None


def lbfgs_memory_init(m: int, M: int, like: torch.Tensor) -> LBFGSMemory:
    """Empty memory of M pairs of m parameters, in ``like``'s dtype and
    device (lbfgs_persist_init)."""
    z = like.new_zeros((M, m))
    return LBFGSMemory(s=z, y=z.clone(), rho=like.new_zeros((M,)), head=0,
                       nfilled=0, niter=0, running_avg=like.new_zeros((m,)),
                       running_avg_sq=like.new_zeros((m,)))


def lbfgs_memory_reset(mem: LBFGSMemory) -> LBFGSMemory:
    """A fresh memory of the same shape (lbfgs_persist_reset, used on
    divergence)."""
    return lbfgs_memory_init(mem.s.shape[1], mem.s.shape[0], mem.s)


def stack_memories(mems) -> LBFGSMemory:
    """Single memories -> one memory on lanes."""
    return LBFGSMemory(
        *(torch.stack([getattr(m, f) for m in mems])
          for f in ("s", "y", "rho")),
        *(np.array([getattr(m, f) for m in mems], np.int64)
          for f in ("head", "nfilled", "niter")),
        *(torch.stack([getattr(m, f) for m in mems])
          for f in ("running_avg", "running_avg_sq")))


def lane_memory(mem: LBFGSMemory, w: int) -> LBFGSMemory:
    """Lane ``w`` of a memory on lanes, as a single memory."""
    return LBFGSMemory(mem.s[w], mem.y[w], mem.rho[w], int(mem.head[w]),
                       int(mem.nfilled[w]), int(mem.niter[w]),
                       mem.running_avg[w], mem.running_avg_sq[w])


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


def mult_hessian_lanes(g, mem: LBFGSMemory):
    """Two-loop recursion on lanes: H_k g [W, m] with each lane's own
    slots and fill count (host arrays); pairs no lane holds are skipped,
    since an empty slot adds nothing."""
    W, M = mem.s.shape[:2]
    dev = g.device
    # newest -> oldest: slot (head - 1 - j) mod M, a lane's pair j live
    # when j < its fill count
    order = (np.asarray(mem.head)[:, None] - 1 - np.arange(M)[None]) % M
    lanes = torch.arange(W, device=dev)[:, None]
    order_t = torch.as_tensor(order, device=dev)
    S, Y = mem.s[lanes, order_t], mem.y[lanes, order_t]      # [W, M, m]
    R = mem.rho[lanes, order_t]                              # [W, M]
    nf = np.asarray(mem.nfilled)
    live = torch.as_tensor(np.arange(M)[None] < nf[:, None], device=dev)
    n_live = int(nf.max())
    zero = g.new_zeros(())
    q = g
    alphas = []
    for j in range(n_live):
        a = torch.where(live[:, j], R[:, j] * (S[:, j] * q).sum(-1), zero)
        q = q - a[:, None] * Y[:, j]
        alphas.append(a)
    if n_live:
        s_n, y_n = S[:, 0], Y[:, 0]
        gamma = torch.where(
            torch.as_tensor(nf > 0, device=dev),
            (s_n * y_n).sum(-1) / torch.clamp((y_n * y_n).sum(-1), min=_EPS),
            torch.ones_like(zero))
        r = gamma[:, None] * q
    else:
        r = q
    for j in range(n_live - 1, -1, -1):
        bta = torch.where(live[:, j], R[:, j] * (Y[:, j] * r).sum(-1), zero)
        r = r + (alphas[j] - bta)[:, None] * S[:, j]
    return r


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def linesearch_backtrack_lanes(cost_func: Callable, xk, pk, gk, alpha0,
                               active, f0, c: float = 1e-4,
                               max_steps: int = MAX_HALVINGS, margins=None):
    """Armijo backtracking on lanes (``linesearch_backtrack`` under the
    JAX ``vmap``): each active lane halves its alpha until f(x + a p) <=
    f(x) + c a p.g (NaN counts as failure) or ``max_steps`` halvings;
    an accepted or inactive lane keeps its alpha. ``cost_func`` maps
    [W, m] to [W]; ``f0`` [W] is f(xk) (host), ``alpha0`` the host
    start [W]. The tests are made on the host in float64. ``margins``
    (a list per lane, or None) receives each test's relative margin
    (f(x + a p) - threshold) / |threshold|: positive halves, NaN is
    +inf. Returns (alpha [W] host, f(x + alpha p) [W] host)."""
    slope = c * _host((pk * gk).sum(-1))
    alpha = np.array(alpha0, np.float64)

    def trial(a):
        at = torch.as_tensor(a, dtype=xk.dtype, device=xk.device)
        return _host(cost_func(xk + at[:, None] * pk))

    fnew = trial(alpha)
    for _ in range(max_steps):
        thr = f0 + alpha * slope
        halve = active & (np.isnan(fnew) | (fnew > thr))
        if margins is not None:
            for w in np.flatnonzero(active):
                margins[w].append(np.inf if np.isnan(fnew[w]) else float(
                    (fnew[w] - thr[w]) / max(abs(thr[w]), 1e-300)))
        if not halve.any():
            break
        active = halve
        alpha = np.where(halve, alpha * 0.5, alpha)
        fnew = np.where(halve, trial(alpha), fnew)
    return alpha, fnew


def lbfgs_minibatch_lanes(cost_func, grad_func, x0, mem: LBFGSMemory,
                          itmax: int = 10, armijo=None):
    """Stochastic LBFGS over one minibatch on W lanes with persistent
    memory (the JAX ``_lbfgs_loop`` with ``stochastic=True`` under
    ``vmap``; reference lbfgs_fit_minibatch, lbfgs.c:717).

    ``cost_func`` maps x [W, m] to the lanes' costs [W] (a lane's cost
    depends on its own row only); ``grad_func`` maps x to [W, m]. Per
    lane and iteration, as the reference: on a new minibatch (the first
    iteration when ``niter`` > 0) the online gradient mean and variance
    update and give the first step alphabar = 10 / (1 + sum|var| /
    (max(niter - 1, 1) ||g||)) (1 on the first minibatch); ``niter``
    counts before that update; Armijo backtracking from alphabar; y +=
    1e-6 s when ||g1|| > 1e-3; no pair stored on a new minibatch, a bad
    alpha or a non-finite gradient. A lane stops on a bad alpha, a
    non-finite or vanishing gradient, or after ``itmax`` iterations, and
    is then frozen. ``armijo``: a list per lane that receives a list of
    test margins per iteration (:func:`linesearch_backtrack_lanes`).
    Returns (x [W, m], memory on lanes, iterations per lane [W] ints)."""
    W, M = mem.s.shape[:2]
    dev, dt = x0.device, x0.dtype
    S, Y, R = mem.s.clone(), mem.y.clone(), mem.rho.clone()
    head = np.array(mem.head, np.int64)
    nfilled = np.array(mem.nfilled, np.int64)
    niter = np.array(mem.niter, np.int64)
    ravg, ravg_sq = mem.running_avg, mem.running_avg_sq
    x = x0
    g = grad_func(x)
    done = _host(torch.linalg.vector_norm(g, dim=-1)) < _EPS
    fx = _host(cost_func(x))
    alphabar = np.ones(W)
    k = np.zeros(W, np.int64)
    it = 0
    while it < itmax and not done.all():
        act = ~done
        batch_changed = act & (niter > 0) & (it == 0)
        niter = niter + act
        if batch_changed.any():
            # online gradient variance -> adaptive first step (lbfgs.c:796)
            nit = torch.as_tensor(niter, dtype=dt, device=dev)
            gradnrm = torch.linalg.vector_norm(g, dim=-1)
            g_min_rold = g - ravg
            ravg_n = ravg + g_min_rold / nit[:, None]
            rsq_n = ravg_sq + g_min_rold * (g - ravg_n)
            ab = 10.0 / (1.0 + torch.abs(rsq_n).sum(-1)
                         / (torch.clamp(nit - 1.0, min=1.0)
                            * torch.clamp(gradnrm, min=_EPS)))
            bc = torch.as_tensor(batch_changed, device=dev)[:, None]
            ravg = torch.where(bc, ravg_n, ravg)
            ravg_sq = torch.where(bc, rsq_n, ravg_sq)
            alphabar = np.where(batch_changed, _host(ab), alphabar)
        pk = -mult_hessian_lanes(
            g, LBFGSMemory(S, Y, R, head, nfilled, niter))
        margins = [[] for _ in range(W)] if armijo is not None else None
        alpha, fnew = linesearch_backtrack_lanes(cost_func, x, pk, g,
                                                 alphabar, act, fx,
                                                 margins=margins)
        if armijo is not None:
            for w in np.flatnonzero(act):
                armijo[w].append(margins[w])
        bad_alpha = ~np.isfinite(alpha) | (np.abs(alpha) < 1e-12)
        move = act & ~bad_alpha
        mv = torch.as_tensor(move, device=dev)[:, None]
        at = torch.as_tensor(np.where(move, alpha, 0.0), dtype=dt,
                             device=dev)
        x1 = torch.where(mv, x + at[:, None] * pk, x)
        g1 = grad_func(x1)
        g1nrm_t = torch.linalg.vector_norm(g1, dim=-1)
        g1nrm = _host(g1nrm_t)
        sk = x1 - x
        yk = g1 - g
        # trust-region damping (lbfgs.c:871-875)
        lm0 = 1e-6
        yk = torch.where((g1nrm_t > 1e3 * lm0)[:, None], yk + lm0 * sk, yk)
        ys = (yk * sk).sum(-1)
        rhok = 1.0 / torch.where(torch.abs(ys) > _EPS, ys,
                                 torch.full_like(ys, float("inf")))
        store = move & ~batch_changed & np.isfinite(g1nrm)
        for w in np.flatnonzero(store):
            S[w, head[w]], Y[w, head[w]], R[w, head[w]] = sk[w], yk[w], \
                rhok[w]
            head[w] = (head[w] + 1) % M
            nfilled[w] = min(nfilled[w] + 1, M)
        done = done | (act & (bad_alpha | ~np.isfinite(g1nrm)
                              | (g1nrm < _EPS)))
        x = torch.where(mv, x1, x)
        g = torch.where(mv, g1, g)
        fx = np.where(move, fnew, fx)
        k = k + act
        it += 1
    return x, LBFGSMemory(S, Y, R, head, nfilled, niter, ravg, ravg_sq), k


def lbfgs_fit_minibatch(cost_func, grad_func, p0, mem: LBFGSMemory,
                        itmax: int = 10, armijo=None):
    """Stochastic LBFGS step over one minibatch with persistent memory
    (lbfgs_fit_minibatch, lbfgs.c:717): :func:`lbfgs_minibatch_lanes` on
    one lane. ``cost_func`` maps p [m] to a scalar. Returns (p, the
    updated memory, executed iterations)."""
    x, mem1, k = lbfgs_minibatch_lanes(
        lambda X: cost_func(X[0]).reshape(1),
        lambda X: grad_func(X[0])[None], p0[None], stack_memories([mem]),
        itmax, armijo=None if armijo is None else [armijo])
    return x[0], lane_memory(mem1, 0), int(k[0])
