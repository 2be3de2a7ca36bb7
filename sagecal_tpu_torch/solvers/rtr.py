"""Riemannian trust-region and Nesterov solvers on the Jones quotient
manifold (port of ``sagecal_tpu/solvers/rtr.py``).

Each (cluster, time-chunk) solution is a 2N x 2 complex matrix X; the
search space is the quotient of full-rank X by right-multiplication with
a 2x2 unitary:

- metric        g(eta, gamma) = 2 Re tr(eta^H gamma)
- horiz. proj.  eta - X Omega, Omega skew-Hermitian solving the 2x2
                Sylvester system (X^H X) Omega + Omega (X^H X)
                = X^H eta - eta^H X (a batched 4x4 complex solve)
- retraction    R_X(eta) = X + eta

All hybrid chunks of a cluster solve together: tangent vectors are
[K, 8N] reals with per-chunk scalars as [K] tensors. The Euclidean
gradient comes from ``torch.autograd.grad`` of the (weighted, optionally
Student's-t) cost. The tCG Hessian is the Gauss-Newton operator at the
outer point, assembled on the route ``lm.use_sweep`` picks from shapes:
from one fused sweep (``ops/sweep.py``), where under ``inner="cg"`` each
product is one blocks matvec (the matvec kernel on the card); or by the
XLA assembly (``normal_eq``), where under ``inner="cg"`` each product is
one ``gn_matvec`` [B] pass. Under ``inner="chol"`` either route gives a
dense [K, 8N, 8N] matrix and each product is one batched matrix-vector
product.

Host reads: the outer loop reads one [K] bool per iteration (the JAX
``while_loop`` condition) and one to decide whether any chunk accepted
(``lax.cond`` on it); tCG reads its [K] ``done`` mask each trip and
stops when every chunk is done, where the reference runs its fixed trip
count with masked updates: the same result in fewer Hessian products.
Consensus ADMM (``admm=(y, bz, rho)``, ``rtr.py:206-456`` of the JAX
package): the cost gains 2 y^T (p - bz) + rho ||p - bz||^2 per chunk
(``lm.admm_terms``; the un-halved convention of ``lm.py``) and every tCG
product its exact Hessian 2 rho v; the robust RTR and NSD pass it
through. Only the full Jones mode runs it.

Constrained Jones modes (``jones_mode`` diag or phase): the point lives
in the reduced space of ``normal_eq.params_from_jones`` (J from
``jones_from_params`` with the constrained entry Jones ``Jref``), the
Hessian operators take the mode (the sweep's md = 2 and 1 kernels, or
the XLA ``*_mode`` assembly), and the gauge projection removes the one
exact symmetry left, the global phase (:func:`project_tangent_mode`). In
phase mode the point starts at theta = 0, so the trust-region radius and
NSD's first step are seeded from the unit-phase scale sqrt(npar N).

With ``lanes`` (``ops.sweep.Lanes``, as in ``lm.lm_solve``) one call
solves an in-flight group's V cluster visits, each with its own
iteration cap and nu; the tCG products are then counted once per
executed product of the group, and per tile ([tiles]) when the visits
are a batch of solve intervals' (``Lanes.tiles`` > 1).

Reduced storage (``RTRConfig.dtype_policy`` bf16 or f16): x8 and wt are
rounded to the storage dtype at entry, the robust curvature weights
return to it, and the point, tangents, costs and nu are float32 (every
cost and weight sum in the accumulator dtype). NSD takes the rows in
whatever dtype its caller stored them, as in the JAX package.

Over row ranks (``RTRConfig.rows``/``NSDConfig.rows``, a
``parallel.RowGroup``; ``--shard-baselines``): each rank prices its own
rows, and the cost is summed over the ranks after it is formed, the
Euclidean gradient after ``torch.autograd`` has formed the rank's own
(the data-parallel rule: a sum inside the graph would hand each rank P
times the gradient, or its share alone). The Hessian operators sum as
their assemblies do (``ops/sweep.py:gn_blocks``, ``normal_eq``), the
preconditioner's baseline counts and the nu means too, so every rank
steps alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import dtypes
from sagecal_tpu_torch.ops import sweep as swp
from sagecal_tpu_torch.parallel import row_sum
from sagecal_tpu_torch.solvers import lm as lm_mod
from sagecal_tpu_torch.solvers import normal_eq as ne
from sagecal_tpu_torch.solvers import robust as rb


class RTRConfig(NamedTuple):
    itmax: int = 10            # outer TR iterations
    tcg_iters: int = 30        # max inner tCG iterations
    kappa: float = 0.1         # tCG linear convergence target
    theta: float = 1.0         # tCG superlinear exponent
    rho_accept: float = 0.0    # accept step if rho > this
    rho_regularize: float = 1e-12
    delta0_frac: float = 0.25  # Delta0 = frac * ||X0||_F per chunk
    delta_bar_frac: float = 2.0
    eps_grad: float = 1e-12    # relative gradient stop
    inner: str = "chol"        # tCG operator: dense ("chol") or matrix-free
    kernel: str = "pallas"     # "pallas" (fused sweep where it fits), "xla"
    jones_mode: str = "full"
    dtype_policy: str = "f32"  # storage dtype of the rows (dtypes.py)
    rows: object = None        # parallel.RowGroup of a sharded solve


class NSDConfig(NamedTuple):
    itmax: int = 20
    ls_tries: int = 10         # backtracking halvings per step
    alpha0: float = 0.1        # initial step relative to grad norm scale
    jones_mode: str = "full"
    rows: object = None        # parallel.RowGroup of a sharded solve


def _c(p, kmax, n_stations):
    """[K, 8N] real params -> [K, 2N, 2] complex manifold point."""
    return ne.jones_r2c(p.reshape(kmax, n_stations, 8)).reshape(
        kmax, 2 * n_stations, 2)


def _r(X, kmax, n_stations):
    """[K, 2N, 2] complex -> [K, 8N] real."""
    return ne.jones_c2r(X.reshape(kmax, n_stations, 2, 2)).reshape(kmax, -1)


def _dot(a, b):
    """Riemannian inner products per chunk: Re tr(eta^H gamma)."""
    return (a * b).sum(dim=-1)


def _projector(p, kmax, n_stations):
    """The horizontal projection at point p as a function of the tangent
    v [K, 8N]: the Sylvester matrix M = I (x) A + A^T (x) I of A = X^H X
    is built once per point."""
    X = _c(p, kmax, n_stations)
    Xh = X.conj().transpose(-1, -2)
    A = Xh @ X                                            # [K, 2, 2]
    I2 = torch.eye(2, dtype=A.dtype, device=A.device)
    M = (torch.einsum("ij,kab->kiajb", I2, A).reshape(-1, 4, 4)
         + torch.einsum("kij,ab->kiajb", A.transpose(-1, -2),
                        I2).reshape(-1, 4, 4))

    def proj(v):
        E = _c(v, kmax, n_stations)
        R = Xh @ E - E.conj().transpose(-1, -2) @ X
        rhs = R.transpose(-1, -2).reshape(-1, 4, 1)     # column-major vec
        Om = torch.linalg.solve_ex(M, rhs)[0].reshape(-1, 2, 2)
        return _r(E - X @ Om.transpose(-1, -2), kmax, n_stations)

    return proj


def project_tangent(p, v, kmax, n_stations):
    """Horizontal projection of tangent v at point p (both [K, 8N])."""
    return _projector(p, kmax, n_stations)(v)


def _projector_mode(p, kmax, n_stations, mode: str):
    """The gauge projection at point p for ``mode`` as a function of the
    tangent v [K, npar N] (``rtr.project_tangent_mode``): full the U(2)
    Sylvester projection of :func:`_projector`; for diag and phase the
    only exact continuous symmetry is the global phase e^{i phi} I, one
    real direction per chunk: phase subtracts the chunk's mean of v, diag
    the component along u[n, c] = (-Im j_ncc, Re j_ncc)."""
    if mode == "full":
        return _projector(p, kmax, n_stations)
    npar = ne.jones_npar(mode)
    if mode == "phase":
        def proj(v):
            vr = v.reshape(kmax, n_stations * npar)
            return (vr - vr.mean(dim=-1, keepdim=True)).reshape(kmax, -1)
        return proj
    J = ne.jones_from_params(p.reshape(kmax, n_stations, npar), "diag")
    d = torch.stack([J[..., 0, 0], J[..., 1, 1]], -1)     # [K, N, 2]
    u = torch.stack([-d.imag, d.real], -1).reshape(kmax, -1)
    den = torch.clamp((u * u).sum(dim=-1, keepdim=True), min=1e-30)

    def proj(v):
        vr = v.reshape(kmax, n_stations * npar)
        num = (u * vr).sum(dim=-1, keepdim=True)
        return (vr - (num / den) * u).reshape(kmax, -1)

    return proj


def project_tangent_mode(p, v, kmax, n_stations, mode: str):
    """Gauge projection of tangent v at point p per Jones mode
    (:func:`_projector_mode`)."""
    return _projector_mode(p, kmax, n_stations, mode)(v)


def _mode_p2j(mode: str, Jref, kmax, n_stations):
    """params [K, npar N] -> J [K, N, 2, 2] for a Jones mode
    (``rtr._mode_p2j``)."""
    npar = ne.jones_npar(mode)

    def p_to_J(p):
        return ne.jones_from_params(p.reshape(kmax, n_stations, npar), mode,
                                    Jref)

    return p_to_J


def station_precond(wt, sta1, sta2, chunk_id, kmax, n_stations,
                    npar: int = 8, lanes=None, rows=None):
    """iw diagonal preconditioner [K, npar N]: 1 / (# live baselines per
    station) per chunk, mean-normalized (per visit of a group), repeated
    over the station's params (rtr_solve.c fns_fcount); the counts over
    every rank of ``rows``."""
    if lanes is not None:
        wt = lanes.rows(wt)
    # baseline counts in the accumulator dtype (a bf16 sum goes inexact
    # past 256 rows a station)
    live = (dtypes.acc(wt).sum(dim=-1) > 0).to(dtypes.acc_dtype(wt.dtype))
    flat1 = chunk_id.long() * n_stations + sta1.long()
    flat2 = chunk_id.long() * n_stations + sta2.long()
    cnt = live.new_zeros((kmax * n_stations,))
    cnt.index_add_(0, flat1, live).index_add_(0, flat2, live)
    iw = 1.0 / torch.clamp(row_sum(cnt, rows, "precond"), min=1.0)
    if lanes is None:
        iw = iw / torch.clamp(iw.mean(), min=1e-30)
    else:
        iw = iw.view(lanes.V, -1)
        iw = torch.stack([iw[v] / torch.clamp(iw[v].mean(), min=1e-30)
                          for v in range(lanes.V)])
    return iw.reshape(kmax, n_stations).repeat_interleave(npar, dim=-1)


def make_cost(x8, coh, sta1, sta2, chunk_id, wt, kmax, n_stations,
              robust_nu=None, mode: str = "full", Jref=None, aug=None):
    """Per-chunk cost [K] of real params [K, npar N] of the Jones mode:
    Gaussian sum (w r)^2, or Student's t sum log(1 + (w r)^2 / nu)
    (robust_lbfgs.c:94); ``aug`` the ADMM terms (y, bz, rho) of
    ``lm.admm_terms`` add 2 y^T d + rho ||d||^2, d = p - bz
    (rtr_solve_robust_admm.c)."""
    p_to_J = _mode_p2j(mode, Jref, kmax, n_stations)

    def cost(p):
        J = p_to_J(p)
        e = dtypes.acc(ne.residual8(x8, J, coh, sta1, sta2, chunk_id) * wt)
        if robust_nu is None:
            per_row = (e * e).sum(dim=-1)
        else:
            per_row = torch.log1p(e * e / robust_nu).sum(dim=-1)
        ck = per_row.new_zeros((kmax,)).index_add_(0, chunk_id, per_row)
        if aug is not None:
            y, bz, rho = aug
            d = p - bz
            ck = ck + 2.0 * (y * d).sum(dim=-1) + rho * (d * d).sum(dim=-1)
        return ck

    return cost


def _tcg(hess_fn, rgrad, delta, cfg: RTRConfig, tiles: int = 1,
         frozen=None):
    """Batched Steihaug-Toint truncated CG (rtr_solve.c:886-1155).

    hess_fn: [K, D] -> [K, D]; ``frozen`` [K] chunks that start done (a
    batch's tiles whose solve has ended). Returns (eta [K, D], model
    decrease [K], executed Hessian products [tiles]: per tile of a batch
    whose chunks the K axis holds tile-major, the products in which one
    of its chunks was live)."""
    r0n = torch.sqrt(_dot(rgrad, rgrad))
    target = r0n * torch.clamp(r0n ** cfg.theta, max=cfg.kappa)
    K = rgrad.shape[0]
    eta = torch.zeros_like(rgrad)
    r = rgrad
    d = -rgrad
    r_r = r0n * r0n
    e_e = rgrad.new_zeros((K,))
    mdot = rgrad.new_zeros((K,))
    done = r0n <= 1e-30
    if frozen is not None:
        done = done | frozen
    one = torch.ones_like(r0n)
    trips = np.zeros(tiles, dtype=np.int64)
    for _ in range(cfg.tcg_iters):
        live = lm_mod.live_lanes(~done, tiles)
        if not live.any():
            break
        Hd = hess_fn(d)
        trips += live
        d_Hd = _dot(d, Hd)
        alpha = r_r / torch.where(d_Hd != 0, d_Hd, one)
        e_d = _dot(eta, d)
        d_d = _dot(d, d)
        # boundary crossing: ||eta + tau d|| = delta
        disc = torch.clamp(e_d * e_d + d_d * (delta * delta - e_e), min=0.0)
        tau = (-e_d + torch.sqrt(disc)) / torch.clamp(d_d, min=1e-30)
        hit = (d_Hd <= 0) | (e_e + 2 * alpha * e_d
                             + alpha * alpha * d_d >= delta * delta)
        step = torch.where(hit, tau, alpha)
        eta_new = eta + step[:, None] * d
        # model decrease of this move (r is the model gradient at eta)
        dm = -step * _dot(r, d) - 0.5 * step * step * d_Hd
        r_new = r + step[:, None] * Hd
        rr_new = _dot(r_new, r_new)
        beta = rr_new / torch.clamp(r_r, min=1e-30)
        d_new = -r_new + beta[:, None] * d
        upd = ~done
        done = done | hit | (torch.sqrt(rr_new) <= target)
        eta = torch.where(upd[:, None], eta_new, eta)
        r = torch.where(upd[:, None], r_new, r)
        d = torch.where(upd[:, None], d_new, d)
        r_r = torch.where(upd, rr_new, r_r)
        e_e = torch.where(upd, _dot(eta_new, eta_new), e_e)
        mdot = torch.where(upd, mdot + dm, mdot)
    return eta, mdot, trips


def _egrad(cost_fn, rows=None):
    """Euclidean gradient of sum(cost_fn(p)) by ``torch.autograd``: with
    ``rows`` ``cost_fn`` is the rank's own cost, and its gradient is
    summed over the ranks after autograd has formed it."""
    def egrad(p):
        with torch.enable_grad():
            pv = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(cost_fn(pv).sum(), pv)
        return row_sum(g, rows, "grad")
    return egrad


def _summed(cost_fn, rows):
    """``cost_fn`` (the rank's own per-chunk cost) summed over the ranks
    of ``rows`` (``cost_fn`` itself without a group)."""
    if rows is None:
        return cost_fn
    return lambda p: row_sum(cost_fn(p), rows, "cost")



@torch.no_grad()
def rtr_solve(x8, coh, sta1, sta2, chunk_id, wt, J0, n_stations: int,
              chunk_mask=None, config: RTRConfig = RTRConfig(),
              itmax_dynamic=None, robust_nu=None, row_period: int = 0,
              lists=None, lanes=None, admm=None):
    """Trust-region solve of all chunks of one cluster (rtr_solve.c:1208).

    Same call convention as ``lm.lm_solve`` (``lists`` the tile's
    ``swp.station_lists`` for the tCG matvec, ``lanes`` a group's
    folded layout with ``robust_nu`` [V]); ``robust_nu`` switches the
    objective to fixed-nu Student's t. Returns (J [K, N, 2, 2], info)
    with init_cost / final_cost [K], iters (outer iterations; [V] on a
    group) and tcg_iters (executed Hessian products; [tiles] on a batch
    of solve intervals). ``admm`` the optional consensus augmentation
    (y, bz, rho) (module docstring)."""
    kmax = J0.shape[0]
    V = 1 if lanes is None else lanes.V
    rows = config.rows
    lm_mod._no_admm(rows, admm)
    sweep = lm_mod.solve_route(config, kmax // V, row_period,
                               x8.shape[0] // V)
    st = dtypes.storage_dtype(config.dtype_policy, x8.dtype)
    x8 = dtypes.to_storage(x8, st)
    wt = dtypes.to_storage(wt, st)
    dev, dtype = x8.device, dtypes.acc_dtype(x8.dtype)
    N = n_stations
    mode = config.jones_mode
    aug = lm_mod.admm_terms(admm, kmax, dtype, dev, mode)
    p0, Jref = ne.mode_point(J0, mode)
    p0 = p0.reshape(kmax, -1).to(dtype)
    if chunk_mask is None:
        chunk_mask = torch.ones((kmax,), dtype=torch.bool, device=dev)
    # a sharded sweep sums the records of chunk_mask's chunks only (the
    # others hold no row)
    live_chunks = None if rows is None or not sweep else \
        torch.nonzero(chunk_mask).flatten()
    # the ADMM term's exact Hessian 2 rho v, in every tCG product
    rho2 = None if aug is None else (2.0 * aug[2])[:, None]
    # per-row views of a group's shared weights and per-visit nu
    wt_r, nu_r = wt, robust_nu
    if robust_nu is not None:
        robust_nu = torch.as_tensor(robust_nu, dtype=dtype, device=dev)
        nu_r = robust_nu if lanes is None else lanes.per_row(robust_nu)
    if lanes is not None:
        wt_r = lanes.rows(wt)

    p_to_J = _mode_p2j(mode, Jref, kmax, N)

    def folded(w):
        return w if lanes is None else lanes.rows(w)

    local_cost = make_cost(x8, coh, sta1, sta2, chunk_id, wt_r, kmax, N,
                           robust_nu=nu_r, mode=mode, Jref=Jref, aug=aug)
    cost_fn = _summed(local_cost, rows)
    egrad = _egrad(local_cost, rows)

    def hess(Hv, v):
        """2 H v (+ 2 rho v under ADMM), before the projection."""
        return Hv if rho2 is None else Hv + rho2 * v

    def rgrad_at(p):
        return project_tangent_mode(p, egrad(p), kmax, N, mode)

    def make_hess(p):
        """Gauss-Newton Hessian operator at the outer point ``p``; the
        robust cost's curvature enters through its PSD surrogate as
        sqrt-curvature row weights wt sqrt(nu) / (nu + e^2)."""
        Jm = p_to_J(p)
        if robust_nu is None:
            wt_eff = wt
        else:
            e = ne.residual8(x8, Jm, coh, sta1, sta2, chunk_id) * wt_r
            # the curvature weights in the storage dtype, so the
            # assembly stays on the reduced path
            wt_eff = dtypes.to_storage(
                dtypes.acc(wt_r) * torch.sqrt(nu_r)
                / (nu_r + dtypes.acc(e * e)), wt_r.dtype)
        proj = _projector_mode(p, kmax, N, mode)
        if config.inner == "cg":
            if sweep:
                fac, _, _ = swp.gn_blocks(x8, Jm, coh, sta1, sta2, chunk_id,
                                          wt_eff, N, kmax, row_period,
                                          jones=mode, lanes=lanes, rows=rows,
                                          live=live_chunks)
                plan = swp.matvec_plan(fac, sta1, sta2, N, lists=lists)

                def hv(v):
                    return proj(hess(2.0 * swp.matvec_apply(plan, v), v))
                return hv
            # matrix-free: each product one [B] pass over the factors
            fac, _, _ = ne.gn_factors_mode(x8, Jm, coh, sta1, sta2,
                                           chunk_id, folded(wt_eff), N, kmax,
                                           mode=mode, row_period=row_period,
                                           visits=V, rows=rows)
            if mode == "full":
                def hv(v):
                    return proj(hess(2.0 * ne.gn_matvec(
                        fac, v, sta1, sta2, chunk_id, kmax, N,
                        row_period=row_period, visits=V, rows=rows), v))
            else:
                def hv(v):
                    return proj(2.0 * ne.gn_matvec_mode(
                        fac, v, sta1, sta2, chunk_id, kmax, N, rows=rows))
            return hv
        if sweep:
            JTJ, _, _ = swp.normal_equations_fused(
                x8, Jm, coh, sta1, sta2, chunk_id, wt_eff, N, kmax,
                row_period, jones=mode, lanes=lanes, rows=rows,
                live=live_chunks)
        else:
            JTJ, _, _ = ne.normal_equations_mode(
                x8, Jm, coh, sta1, sta2, chunk_id, folded(wt_eff), N, kmax,
                mode=mode, row_period=row_period, visits=V, rows=rows)

        def hv(v):
            return proj(hess(2.0 * torch.einsum("kij,kj->ki", JTJ, v), v))
        return hv

    cost0 = cost_fn(p0)
    xnorm0 = torch.sqrt(_dot(p0, p0))
    if mode == "phase":
        # theta starts at 0: seed the radius from the unit-phase scale
        xnorm0 = torch.clamp(xnorm0, min=float(p0.shape[-1]) ** 0.5)
    delta_bar = config.delta_bar_frac * xnorm0
    delta = config.delta0_frac * xnorm0
    g = rgrad_at(p0)
    g0n = torch.sqrt(_dot(g, g))
    itmax, cap = lm_mod._lane_caps(config.itmax, itmax_dynamic, lanes)

    p, cost = p0, cost0
    stop = torch.zeros((kmax,), dtype=torch.bool, device=dev)
    k = 0
    its = np.zeros(V, dtype=np.int64)
    tiles = 1 if lanes is None else lanes.tiles
    tcg = np.zeros(tiles, dtype=np.int64)
    while k < itmax:
        lv = lm_mod.live_lanes(~stop & chunk_mask, V)
        if not lv.any():
            break
        its += lv
        frozen = None
        if tiles > 1:
            # a tile whose solve has ended takes no more tCG trips (its
            # steps are discarded), as its own solve takes none
            ended = ~lv.reshape(tiles, -1).any(axis=1)
            frozen = torch.as_tensor(np.repeat(ended, kmax // tiles),
                                     device=dev)
        eta, md, trips = _tcg(make_hess(p), g, delta, config, tiles, frozen)
        tcg += trips
        p_new = p + eta
        c_new = cost_fn(p_new)
        rho = (cost - c_new + config.rho_regularize) \
            / (md + config.rho_regularize)
        good = (md > 0) & torch.isfinite(p_new).all(dim=-1)
        accept = good & (rho > config.rho_accept) & ~stop & chunk_mask
        en = torch.sqrt(_dot(eta, eta))
        shrink = (rho < 0.25) | ~good
        grow = (rho > 0.75) & (en >= 0.99 * delta)
        delta = torch.where(shrink, 0.25 * delta,
                            torch.where(grow, torch.minimum(2.0 * delta,
                                                            delta_bar),
                                        delta))
        p = torch.where(accept[:, None], p_new, p)
        cost = torch.where(accept, c_new, cost)
        if bool(accept.any()):
            g = rgrad_at(p)
        gn = torch.sqrt(_dot(g, g))
        stop = stop | (gn <= config.eps_grad * torch.clamp(g0n, min=1e-30)) \
            | (delta <= 1e-12 * torch.clamp(xnorm0, min=1e-30)) \
            | (k + 1 >= cap)
        k += 1
    J = p_to_J(p)
    J = torch.where(chunk_mask[:, None, None, None], J,
                    (J0 if Jref is None else Jref).to(J.dtype))
    return J, {"init_cost": cost0, "final_cost": cost,
               "iters": int(its[0]) if lanes is None else its,
               "tcg_iters": int(tcg[0]) if tiles == 1 else tcg}


def _aecm(nulow, nuhigh, rows=None):
    """The robust RTR/NSD nu update (AECM, p = 2) as a ``robust.lane_nu``
    update (its mean over the ranks of ``rows``)."""
    return lambda w, m, n: rb.update_nu_aecm(rb.mean_logsumw(w, m, rows), n,
                                             p=2, nulow=nulow, nuhigh=nuhigh)


def rtr_solve_robust(x8, coh, sta1, sta2, chunk_id, wt_base, J0,
                     n_stations: int, nu0=2.0, nulow=2.0, nuhigh=30.0,
                     chunk_mask=None, config: RTRConfig = RTRConfig(),
                     wt_rounds: int = 2, itmax_dynamic=None,
                     row_period: int = 0, lists=None, lanes=None,
                     admm=None):
    """Student's-t robust RTR (rtr_solve_robust.c:1441; the ADMM variant
    rtr_solve_robust_admm.c:1425 with ``admm``): IRLS rounds of
    {fixed-nu robust RTR -> weight E-step -> AECM nu update, p = 2}.
    Returns (J, nu, info); nu is [V] on a group (``lanes``)."""
    mask = wt_base > 0
    nu = torch.as_tensor(nu0, dtype=dtypes.acc_dtype(x8.dtype),
                         device=x8.device)
    J = J0
    wt_r = wt_base if lanes is None else lanes.rows(wt_base)
    infos = []
    for _ in range(wt_rounds):
        J, info = rtr_solve(x8, coh, sta1, sta2, chunk_id, wt_base, J,
                            n_stations, chunk_mask, config,
                            itmax_dynamic=itmax_dynamic, robust_nu=nu,
                            row_period=row_period, lists=lists, lanes=lanes,
                            admm=admm)
        e = ne.residual8(x8, J, coh, sta1, sta2, chunk_id) * wt_r
        w = rb.update_weights(e, nu if lanes is None else lanes.per_row(nu))
        nu = rb.lane_nu(nu, w, mask, lanes,
                        _aecm(nulow, nuhigh, config.rows))
        infos.append(info)
    return J, nu, {"init_cost": infos[0]["init_cost"],
                   "final_cost": infos[-1]["final_cost"],
                   "iters": sum(i["iters"] for i in infos),
                   "tcg_iters": sum(i["tcg_iters"] for i in infos)}


@torch.no_grad()
def nsd_solve_robust(x8, coh, sta1, sta2, chunk_id, wt_base, J0,
                     n_stations: int, nu0=2.0, nulow=2.0, nuhigh=30.0,
                     chunk_mask=None, config: NSDConfig = NSDConfig(),
                     itmax_dynamic=None, lanes=None, admm=None):
    """Nesterov accelerated steepest descent with Student's-t cost
    (nsd_solve_nocuda_robust, rtr_solve_robust.c:1878; with ``admm`` the
    augmented cost of Dirac.h:1260-1314): momentum
    t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2, per-chunk backtracking line
    search on the projected, station-preconditioned gradient, and an
    AECM nu update every step. Returns (J, nu, info).

    The reference scans all ``config.itmax`` steps and freezes those past
    ``itmax_dynamic``; here only the live steps run, and the final cost
    is priced with the nu the frozen steps would carry. On a group
    (``lanes``; nu [V], one cap per visit) the steps run to the largest
    cap and a visit past its own keeps its point, momentum and nu. Under
    ``config.jones_mode`` diag or phase the steps run in the mode's
    reduced space, and in phase mode the first step length is seeded
    from the unit-phase scale sqrt(npar N)."""
    kmax = J0.shape[0]
    dev, dtype = x8.device, dtypes.acc_dtype(x8.dtype)
    N = n_stations
    mode = config.jones_mode
    npar = ne.jones_npar(mode)
    rows = config.rows
    lm_mod._no_admm(rows, admm)
    aug = lm_mod.admm_terms(admm, kmax, dtype, dev, mode)
    p, Jref = ne.mode_point(J0, mode)
    p = p.reshape(kmax, -1).to(dtype)
    p_to_J = _mode_p2j(mode, Jref, kmax, N)
    if chunk_mask is None:
        chunk_mask = torch.ones((kmax,), dtype=torch.bool, device=dev)
    # one nu per visit (a single visit without lanes)
    V = 1 if lanes is None else lanes.V
    nu = torch.as_tensor(nu0, dtype=dtype, device=dev).expand(V).clone()
    wt_r = wt_base if lanes is None else lanes.rows(wt_base)

    def per_row(s):
        return s if lanes is None else lanes.per_row(s)

    def cost_of(nu_):
        return make_cost(x8, coh, sta1, sta2, chunk_id, wt_r, kmax, N,
                         robust_nu=per_row(nu_), mode=mode, Jref=Jref,
                         aug=aug)

    iw = station_precond(wt_base, sta1, sta2, chunk_id, kmax, N,
                         npar=npar, lanes=lanes, rows=rows)
    mask = wt_base > 0
    caps = np.minimum(np.full(V, config.itmax) if itmax_dynamic is None
                      else np.asarray(itmax_dynamic, dtype=np.int64),
                      config.itmax)

    cost0 = _summed(cost_of(nu), rows)(p)
    p_prev = p
    t = torch.ones((), dtype=dtype, device=dev)
    nu_last = nu                  # the nu the last executed step priced
    for step in range(max(int(caps.max()), 0)):
        live_v = torch.as_tensor(step < caps, device=dev)
        live_c = live_v.repeat_interleave(kmax // V)
        local = cost_of(nu)
        cfn = _summed(local, rows)
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = p + ((t - 1.0) / tn) * (p - p_prev)
        g = project_tangent_mode(y, _egrad(local, rows)(y) * iw, kmax, N,
                                 mode)
        gn = torch.sqrt(_dot(g, g))
        best_c = cfn(y)
        ynorm = torch.sqrt(_dot(y, y))
        if mode == "phase":
            ynorm = torch.clamp(ynorm, min=float(npar * N) ** 0.5)
        alpha = config.alpha0 * ynorm / torch.clamp(gn, min=1e-30)
        best_p = y
        found = torch.zeros((kmax,), dtype=torch.bool, device=dev)
        for _ in range(config.ls_tries):
            cand = y - alpha[:, None] * g
            c_c = cfn(cand)
            better = (c_c < best_c) & ~found
            alpha = alpha * 0.5
            best_p = torch.where(better[:, None], cand, best_p)
            best_c = torch.where(better, c_c, best_c)
            found = found | better
        # momentum restarts where the line search failed
        p_new = torch.where((found & chunk_mask & live_c)[:, None], best_p,
                            p)
        e = ne.residual8(x8, p_to_J(p_new), coh, sta1, sta2,
                         chunk_id) * wt_r
        w = rb.update_weights(e, per_row(nu))
        nu_last = torch.where(live_v, nu, nu_last)
        nu = torch.where(live_v, rb.lane_nu(nu, w, mask, lanes,
                                            _aecm(nulow, nuhigh, rows)), nu)
        p_prev = torch.where(live_c[:, None], p, p_prev)
        p, t = p_new, tn
    # the reference's last scan step prices its output with the nu it
    # entered with: the last live step's when every step is live, the
    # updated nu when frozen steps follow
    full = torch.as_tensor(caps >= config.itmax, device=dev)
    final_cost = _summed(cost_of(torch.where(full, nu_last, nu)), rows)(p)
    J = p_to_J(p)
    J = torch.where(chunk_mask[:, None, None, None], J,
                    (J0 if Jref is None else Jref).to(J.dtype))
    return J, (nu[0] if lanes is None else nu), {
        "init_cost": cost0, "final_cost": final_cost,
        "iters": config.itmax if lanes is None else np.full(V, config.itmax)}
