"""SAGE expectation-maximization loop (port of the host-driven half of
``sagecal_tpu/solvers/sage.py``).

Per EM iteration every direction cluster is updated in sequence against
a shared residual: add the cluster's current model back, solve that
cluster per hybrid time chunk (LM, ``solvers/lm.py``), re-subtract. The
iteration budget is re-weighted by each cluster's cost reduction (80%
evenly, 20% by share) on weighted sweeps, and a joint LBFGS refine over
all npar N Mt parameters follows, with its gradient from
``torch.autograd.grad``. Under ``--jones diag|phase`` J0 is constrained to
the mode at entry, every cluster solve takes the mode, and the refine runs
in the mode's reduced space (J = ``normal_eq.jones_from_params`` of the
constrained J, autograd through that map), so a constrained J stays
constrained: its off-diagonals are exactly 0.

Solver modes follow ``sage._cluster_solve`` (lmfit.c:906-962): modes
0/2/3 run ordered-subsets LM on every EM iteration but the last, which
switches to plain LM / robust LM / OS robust LM; mode 1 is LM, mode 4
RTR, mode 5 robust RTR, mode 6 NSD. Robust modes track one nu per
cluster; their mean (clipped to [nulow, nuhigh]) prices the joint
refine's Student's-t cost sum log1p(r^2 / nu).

The visiting order comes from :class:`ClusterOrder` and the OS subset
draws from seeds folded per (EM iteration, cluster, IRLS round)
(``lm.OSConfig``): seeded ``torch.Generator`` shims in place of the JAX
key stream. With ``randomize`` off (``-R 0``) the order is the identity
and the subsets rotate, exactly as in the JAX package.

In-flight groups (``SageConfig.inflight`` > 1, ``--inflight``): a sweep
visits the clusters G at a time (:func:`_group_update`). The G member
solves run as one lane-batched solve (``ops.sweep.Lanes``: the multi-
visit sweep kernel on the card) against the group-entry residual, and
their joint update is tried at relaxations 1, 1/2, 1/4 (damped
block-Jacobi); a group no relaxation makes safe is rejected. The width
is clamped to M//4, and a cold start's first sweep to 2.
"""

from __future__ import annotations

from typing import NamedTuple

import time

import numpy as np
import torch

from sagecal_tpu_torch.config import SolverMode
from sagecal_tpu_torch.ops import sweep as swp
from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.solvers import lbfgs as lbfgs_mod
from sagecal_tpu_torch.solvers import lm as lm_mod
from sagecal_tpu_torch.solvers import normal_eq as ne
from sagecal_tpu_torch.solvers import robust as rb
from sagecal_tpu_torch.solvers import rtr as rtr_mod


class SageConfig(NamedTuple):
    max_emiter: int = 3
    max_iter: int = 10            # LM iterations per cluster solve (-g)
    max_lbfgs: int = 10           # joint refine iterations (-l)
    lbfgs_m: int = 7              # LBFGS memory (-m)
    solver_mode: int = int(SolverMode.RTR_OSRLM_RLBFGS)
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True
    inner: str = "chol"
    kernel: str = "pallas"
    jones_mode: str = "full"
    # row baseline period of the [tilesz, nbase] layout (fused sweep)
    nbase: int = 0
    # clusters solved concurrently per sweep step (--inflight; 1 = the
    # reference's sequence) and whether J0 is already near a solution
    # (a warm tile: no cold first-sweep width restriction)
    inflight: int = 1
    inflight_warm: bool = False


_OS_MODES = (int(SolverMode.OSLM_LBFGS),
             int(SolverMode.OSLM_OSRLM_RLBFGS),
             int(SolverMode.RLM_RLBFGS))


def _is_robust(mode: int) -> bool:
    return mode in (int(SolverMode.OSLM_OSRLM_RLBFGS),
                    int(SolverMode.RLM_RLBFGS),
                    int(SolverMode.RTR_OSRLM_RLBFGS),
                    int(SolverMode.NSD_RLBFGS))


class ClusterOrder:
    """Cluster visiting order per EM iteration: a random permutation
    from a ``torch.Generator`` seeded by (seed, iteration) on unweighted
    sweeps, descending cost reduction on weighted ones, the identity
    with randomize off. The permutations differ from the JAX key
    stream's; parity runs use ``-R 0``."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def order(self, ci: int, M: int, nerr, weighted: bool,
              randomize: bool) -> np.ndarray:
        if not randomize or M <= 1:
            return np.arange(M)
        if weighted:
            return np.argsort(-np.asarray(nerr.cpu()), kind="stable")
        g = torch.Generator().manual_seed(self.seed * 1000003 + 104729 + ci)
        return torch.randperm(M, generator=g).numpy()


def full_model8(J, coh, sta1, sta2, chunk_idx):
    """Sum of all clusters' corrupted models [B, 8]: J [M, K, N, 2, 2],
    coh [M, B, 2, 2], chunk_idx [M, B]."""
    out = rp.model8(coh[0], J[0], sta1, sta2, chunk_idx[0])
    for m in range(1, coh.shape[0]):
        out = out + rp.model8(coh[m], J[m], sta1, sta2, chunk_idx[m])
    return out


def _wres(x8, J, coh, sta1, sta2, chunk_idx, wt_base):
    """||(x - model) * w||_2 / (8 B)."""
    r = (x8 - full_model8(J, coh, sta1, sta2, chunk_idx)) * wt_base
    return torch.linalg.vector_norm(r) / (x8.shape[0] * 8)


def _cluster_solve(mode: int, xdummy, coh_m, sta1, sta2, cidx_m, cmask_m,
                   wt_base, J_m, n_stations: int, nu_cj, config: SageConfig,
                   itermax, itcap: int, os_cfg, last: bool, lists,
                   lanes=None):
    """One cluster's per-chunk solve by solver mode (``sage._cluster_solve``,
    lmfit.c:906-962); ``lists`` the tile's station lists for the matvec
    kernel (``inner="cg"``). Returns (Jn, nu_new, init_cost [K],
    final_cost [K], iters, cg_iters, tcg_iters). With ``lanes`` the
    arguments are an in-flight group's folded layout (``lm.lm_solve``):
    nu_cj [V], itermax an int array and os_cfg a list, one per visit;
    nu_new, iters and cg_iters are then per visit."""
    nbase = int(config.nbase)
    lm_cfg = lm_mod.LMConfig(itmax=itcap, inner=config.inner,
                             kernel=config.kernel,
                             jones_mode=config.jones_mode)

    def plain_lm(os=None):
        Jn, info = lm_mod.lm_solve(
            xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m, n_stations,
            chunk_mask=cmask_m, config=lm_cfg, itmax_dynamic=itermax,
            os=os, row_period=nbase, lists=lists, lanes=lanes)
        return (Jn, nu_cj, info["init_cost"], info["final_cost"],
                info["iters"], info["cg_iters"], 0)

    def robust_lm(os=None):
        Jn, nu_new, info = rb.robust_lm_solve(
            xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m, n_stations,
            nu0=nu_cj, nulow=config.nulow, nuhigh=config.nuhigh,
            chunk_mask=cmask_m, config=lm_cfg, wt_rounds=3,
            itmax_dynamic=itermax, os=os, row_period=nbase, lists=lists,
            lanes=lanes)
        return (Jn, nu_new, info["init_cost"], info["final_cost"],
                info["iters"], info["cg_iters"], 0)

    if mode in (int(SolverMode.RTR_OSLM_LBFGS),
                int(SolverMode.RTR_OSRLM_RLBFGS)):
        rtr_cfg = rtr_mod.RTRConfig(itmax=itcap, inner=config.inner,
                                    kernel=config.kernel,
                                    jones_mode=config.jones_mode)
        if mode == int(SolverMode.RTR_OSLM_LBFGS):
            Jn, info = rtr_mod.rtr_solve(
                xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m,
                n_stations, chunk_mask=cmask_m, config=rtr_cfg,
                itmax_dynamic=itermax, row_period=nbase, lists=lists,
                lanes=lanes)
            nu_new = nu_cj
        else:
            # 2 rounds: the reference robust RTR updates the weights
            # once before and once after the TR loop
            Jn, nu_new, info = rtr_mod.rtr_solve_robust(
                xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m,
                n_stations, nu0=nu_cj, nulow=config.nulow,
                nuhigh=config.nuhigh, chunk_mask=cmask_m, config=rtr_cfg,
                wt_rounds=2, itmax_dynamic=itermax, row_period=nbase,
                lists=lists, lanes=lanes)
        return (Jn, nu_new, info["init_cost"], info["final_cost"],
                info["iters"], 0, info["tcg_iters"])

    if mode == int(SolverMode.NSD_RLBFGS):
        nsd_cfg = rtr_mod.NSDConfig(itmax=2 * itcap,
                                    jones_mode=config.jones_mode)
        Jn, nu_new, info = rtr_mod.nsd_solve_robust(
            xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m, n_stations,
            nu0=nu_cj, nulow=config.nulow, nuhigh=config.nuhigh,
            chunk_mask=cmask_m, config=nsd_cfg, itmax_dynamic=2 * itermax,
            lanes=lanes)
        return (Jn, nu_new, info["init_cost"], info["final_cost"],
                info["iters"], 0, 0)

    if mode == int(SolverMode.LM_LBFGS) or os_cfg is None:
        return robust_lm() if _is_robust(mode) else plain_lm()
    # OS modes: OS-LM on every EM iteration but the last
    if not last:
        return plain_lm(os_cfg)
    if mode == int(SolverMode.OSLM_LBFGS):
        return plain_lm()
    if mode == int(SolverMode.RLM_RLBFGS):
        return robust_lm()
    return robust_lm(os_cfg)


#: widest group proven safe from an identity start (the cold first sweep)
_COLD_INFLIGHT = 2
#: the relaxations a group's joint update is tried at, in order
OMEGAS = (1.0, 0.5, 0.25)


def _eff_inflight(config: SageConfig, M: int) -> int:
    """Effective in-flight group width (``sage._eff_inflight``): the
    configured value clamped to M//4, so below M = 8 every width runs
    sequentially."""
    G = int(config.inflight)
    if G <= 1:
        return 1
    return max(1, min(G, M // 4))


def _inflight_widths(config: SageConfig, M: int) -> tuple[int, int]:
    """(first-sweep width, steady width): a cold start restricts the
    first EM sweep to _COLD_INFLIGHT (``sage._inflight_widths``)."""
    G = _eff_inflight(config, M)
    G0 = G if config.inflight_warm else min(G, _COLD_INFLIGHT)
    return G0, G


def _omega_trial(w: float, Jo_g, Jn_g, coh_g, cidx_g, sta1, sta2, xres,
                 model_old, wt_base, res_old, anchor):
    """One damped block-Jacobi step at relaxation ``w``
    (``sage._omega_trial``): J(w) = J_old + w (J_solved - J_old) applied
    jointly. Returns (ok, margin, xnew, J(w)): ok when the weighted
    residual L2^2 is at most the entry's (1 + 1e-9) or 1.05 x the sweep's
    anchor; margin = (threshold - rn) / threshold, read with ok in one
    device read."""
    Jr_g = Jo_g + w * (Jn_g - Jo_g)
    model_new = torch.stack([rp.model8(coh_g[v], Jr_g[v], sta1, sta2,
                                       cidx_g[v])
                             for v in range(Jr_g.shape[0])])
    xnew = xres + (model_old - model_new).sum(dim=0)
    rn = ((xnew * wt_base) ** 2).sum()
    ok = (rn <= res_old * (1.0 + 1e-9)) | (rn <= 1.05 * anchor)
    thr = torch.maximum(res_old * (1.0 + 1e-9), 1.05 * anchor)
    ok_h, margin = torch.stack([ok.to(rn.dtype),
                                (thr - rn) / thr]).tolist()
    return bool(ok_h), margin, xnew, Jr_g


def _group_solve(mode: int, xd_g, coh_g, cidx_g, cmask_g, J_g, nu_g, sta1,
                 sta2, wt_base, n_stations: int, config: SageConfig,
                 itermax, itcap: int, os_cfgs, last: bool, lists,
                 cid_shared: bool):
    """The G member solves of a group as one lane-batched solve, each
    against its own add-back ``xd_g`` [V, B, 8] (``jax.vmap(solve_one)``
    of ``sage._group_update``): coh_g [V, B, 2, 2], cidx_g [V, B],
    cmask_g [V, K], J_g [V, K, N, 2, 2], nu_g [V]; ``itermax`` and
    ``os_cfgs`` one per visit; ``cid_shared`` when every visit has the
    same chunk ids. Returns (Jn [V, K, N, 2, 2], nu [V], init_cost
    [V, K], final_cost [V, K], iters [V], cg_iters [V], tcg_iters)."""
    V, K = J_g.shape[0], J_g.shape[1]
    B = xd_g.shape[1]
    lanes = swp.Lanes(V, K, cidx_g[0] if cid_shared else cidx_g)
    off = torch.arange(V, device=cidx_g.device)[:, None] * K
    Jn, nu_new, ic, fc, its, cgs, tcgs = _cluster_solve(
        mode, xd_g.reshape(V * B, 8), coh_g.reshape(V * B, 2, 2),
        sta1.repeat(V), sta2.repeat(V), (cidx_g + off).reshape(V * B),
        cmask_g.reshape(V * K), wt_base, J_g.reshape((V * K,) + J_g.shape[2:]),
        n_stations, nu_g, config, np.asarray(itermax), itcap, os_cfgs, last,
        lists, lanes=lanes)
    nu_new = torch.as_tensor(nu_new, dtype=nu_g.dtype,
                             device=nu_g.device).expand(V)
    return (Jn.view(J_g.shape), nu_new, ic.view(V, K), fc.view(V, K),
            np.broadcast_to(its, (V,)), np.broadcast_to(cgs, (V,)),
            int(tcgs))


def _group_update(cjs, J, xres, nuM, nerr_acc, x8, coh, sta1, sta2,
                  chunk_idx, chunk_mask, wt_base, n_stations: int,
                  config: SageConfig, itermax, itcap: int, os_cfgs,
                  last: bool, lists, anchor, cid_shared: bool):
    """Visit a GROUP of clusters ``cjs`` concurrently (``sage._group_update``,
    sage.py:552). Every member solves against the residual as of group
    entry; the entering models fall out of the add-backs (no second model
    evaluation); the joint update is tried at the :data:`OMEGAS` and the
    first safe one is applied to J, the residual, nu and the cost
    reductions. A group no relaxation makes safe leaves the state as it
    was. A ragged last group simply has fewer members: no padded slot is
    solved (the reference pads with an out-of-range index instead, whose
    NaN lane rejects the group: ROADMAP queue C).

    Updates J, nuM and nerr_acc in place; returns (xres, record) with
    record = dict(omega, margins, solver_iters, cg_iters, tcg_iters),
    omega 0.0 for a rejected group and margins those of the trials
    made."""
    idx = torch.as_tensor(cjs, device=x8.device)
    coh_g, cidx_g, J_o = coh[idx], chunk_idx[idx], J[idx]
    xd_g = torch.stack([xres + rp.model8(coh[cj], J[cj], sta1, sta2,
                                         chunk_idx[cj]) for cj in cjs])
    Jn, nu_new, ic, fc, its, cgs, tcgs = _group_solve(
        int(config.solver_mode), xd_g, coh_g, cidx_g, chunk_mask[idx], J_o,
        nuM[idx].clone(), sta1, sta2, wt_base, n_stations, config, itermax,
        itcap, os_cfgs, last, lists, cid_shared)
    model_old = xd_g - xres[None]
    res_old = ((xres * wt_base) ** 2).sum()
    margins = []
    omega = 0.0
    for w in OMEGAS:
        ok, margin, xnew, Jr = _omega_trial(w, J_o, Jn, coh_g, cidx_g, sta1,
                                            sta2, xres, model_old, wt_base,
                                            res_old, anchor)
        margins.append(margin)
        if ok:
            omega = w
            break
    rec = {"omega": omega, "margins": margins,
           "solver_iters": int(its.sum()),
           "cg_iters": int(cgs.sum()), "tcg_iters": tcgs}
    if not omega:
        return xres, rec
    init_res, final_res = ic.sum(dim=-1), fc.sum(dim=-1)
    dcost = torch.where(
        init_res > 0,
        torch.clamp((init_res - final_res)
                    / torch.clamp(init_res, min=1e-30), min=0.0),
        torch.zeros_like(init_res))
    nerr_acc[idx] = dcost
    nuM[idx] = nu_new
    J[idx] = Jr
    return xnew, rec


def refine(x8, coh, sta1, sta2, chunk_idx, J, wt_base, n_stations: int,
           config: SageConfig, mean_nu=None):
    """Joint LBFGS refine of all clusters' Jones (``sage._jit_refine``):
    cost sum((x - model) w)^2, or with ``mean_nu`` the Student's-t cost
    sum log1p(((x - model) w)^2 / mean_nu), over the parameters of
    ``config.jones_mode`` (``sage._refine_cost_fn``: the constrained J is
    the reference point Jref). Returns (J, res, iters)."""
    M, kmax = J.shape[0], J.shape[1]
    mode = config.jones_mode
    shape = (M * kmax, n_stations, ne.jones_npar(mode))
    p0, Jref = ne.mode_point(J.reshape(M * kmax, n_stations, 2, 2), mode)
    p0 = p0.reshape(-1).to(x8.dtype).detach()

    def p_to_J(p):
        return ne.jones_from_params(p.reshape(shape), mode, Jref).reshape(
            M, kmax, n_stations, 2, 2)

    def objective(p):
        r = (x8 - full_model8(p_to_J(p), coh, sta1, sta2,
                              chunk_idx)) * wt_base
        if mean_nu is None:
            return (r * r).sum()
        return torch.log1p(r * r / mean_nu).sum()

    def cost_fn(p):
        with torch.no_grad():
            return objective(p)

    def grad_fn(p):
        with torch.enable_grad():
            pv = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(pv), pv)
        return g

    p1, k = lbfgs_mod.lbfgs_fit(cost_fn, grad_fn, p0, itmax=config.max_lbfgs,
                                M=config.lbfgs_m, return_iters=True)
    Jn = p_to_J(p1)
    return Jn, _wres(x8, Jn, coh, sta1, sta2, chunk_idx, wt_base), k


def sagefit_host(x8, coh, sta1, sta2, chunk_idx, chunk_mask, J0,
                 n_stations: int, wt_base, nu0=None,
                 config: SageConfig = SageConfig(), seed: int = 42,
                 os_id=None):
    """One solve interval of SAGE-EM calibration with the EM and
    cluster loops on the host.

    x8 [B, 8] channel-averaged data; coh [M, B, 2, 2] solve
    coherencies; chunk_idx [M, B]; chunk_mask [M, Kmax] bool; J0
    [M, Kmax, N, 2, 2]; wt_base [B, 8]; ``os_id`` the (ids [B], count)
    pair of ``lm.os_subset_ids`` for the OS modes 0/2/3. Returns (J,
    info) with res_0/res_1 = ||residual w||_2 / (8 B), mean_nu and the
    executed trips (solver_iters, cg_iters, tcg_iters, lbfgs_iters).

    With ``config.inflight`` > 1 the sweeps visit the clusters in groups
    (:func:`_group_update`; widths from :func:`_inflight_widths`, cut from
    the same visiting order) and info adds ``rejected_groups`` and
    ``groups``, one (sweep, members, omega, margins) record a group."""
    mode = int(config.solver_mode)
    if mode not in tuple(int(m) for m in SolverMode):
        raise ValueError(f"unknown solver mode -j {mode}")
    M = coh.shape[0]
    dtype = x8.dtype
    dev = x8.device
    if nu0 is None:
        nu0 = config.nulow
    total_iter = M * config.max_iter
    iter_bar = int(-(-0.8 * total_iter // M))
    itcap = int(config.max_iter) + iter_bar
    shim = ClusterOrder(seed)
    chunk_idx = chunk_idx.long()
    sta1, sta2 = sta1.long(), sta2.long()
    # the matvec kernel's station lists, built once for the tile
    lists = (swp.station_lists(sta1, sta2, int(config.nbase), n_stations)
             if config.inner == "cg" and dev.type == "cuda" else None)
    os_ids = None
    if os_id is not None and mode in _OS_MODES:
        os_ids = (torch.as_tensor(np.asarray(os_id[0]), device=dev).long(),
                  int(os_id[1]))

    if config.jones_mode != "full":
        # constrained modes start (and stay) on the constraint surface;
        # the initial residual prices the point the solvers see
        J0 = ne.jones_constrain(J0, config.jones_mode)
    xres = x8 - full_model8(J0, coh, sta1, sta2, chunk_idx)
    res_0 = torch.linalg.vector_norm(xres * wt_base) / (x8.shape[0] * 8)
    J = J0.clone()
    nerr = torch.zeros((M,), dtype=dtype, device=dev)
    nuM = torch.full((M,), float(nu0), dtype=dtype, device=dev)
    trips = {"solver_iters": 0, "cg_iters": 0, "tcg_iters": 0}
    G0, Gs = _inflight_widths(config, M)
    groups = []
    same_cid = None
    if Gs > 1:
        # [M, M] host bools, clusters i and j have equal chunk ids: a
        # group of such clusters shares them in its sweep (M row
        # comparisons; a sort over rows of B ids costs ~1 s on the card)
        same_cid = torch.stack([(chunk_idx == chunk_idx[i]).all(dim=-1)
                                for i in range(M)]).cpu().numpy()
    t_em = time.perf_counter()
    for ci in range(config.max_emiter):
        weighted = config.randomize and (ci % 2 == 1)
        last = ci == config.max_emiter - 1
        order = shim.order(ci, M, nerr, weighted, config.randomize)
        nerr_host = nerr.cpu().numpy() if weighted else None
        nerr_acc = torch.zeros((M,), dtype=dtype, device=dev)
        seed_ci = lm_mod.fold_in(seed, ci)

        def itermax_of(cj):
            if weighted:
                return int(np.asarray(
                    0.2 * nerr_host[cj] * total_iter).astype(np.int32)) \
                    + iter_bar
            return config.max_iter

        def os_of(cj):
            if os_ids is None:
                return None
            return lm_mod.OSConfig(
                os_id=os_ids[0], n_subsets=os_ids[1],
                seed=lm_mod.fold_in(seed_ci, cj),
                randomize=config.randomize)

        Gi = G0 if ci == 0 else Gs
        if Gi > 1:
            # sweep-entry anchor of the group-step safeguard
            anchor = ((xres * wt_base) ** 2).sum()
            for g in range(0, M, Gi):
                cjs = [int(c) for c in order[g:g + Gi]]
                xres, rec = _group_update(
                    cjs, J, xres, nuM, nerr_acc, x8, coh, sta1, sta2,
                    chunk_idx, chunk_mask, wt_base, n_stations, config,
                    [itermax_of(cj) for cj in cjs], itcap,
                    None if os_ids is None else [os_of(cj) for cj in cjs],
                    last, lists, anchor,
                    bool(same_cid[cjs[0], cjs].all()))
                for key in trips:
                    trips[key] += rec[key]
                groups.append((ci, cjs, rec["omega"], rec["margins"]))
        else:
            for cj in (int(c) for c in order):
                itermax = itermax_of(cj)
                os_cfg = os_of(cj)
                xdummy = xres + rp.model8(coh[cj], J[cj], sta1, sta2,
                                          chunk_idx[cj])
                Jn, nu_new, init_c, final_c, its, cgs, tcgs = _cluster_solve(
                    mode, xdummy, coh[cj], sta1, sta2, chunk_idx[cj],
                    chunk_mask[cj], wt_base, J[cj], n_stations,
                    nuM[cj].clone(), config, itermax, itcap, os_cfg, last,
                    lists)
                trips["solver_iters"] += int(its)
                trips["cg_iters"] += int(cgs)
                trips["tcg_iters"] += int(tcgs)
                nuM[cj] = nu_new
                init_res = init_c.sum()
                final_res = final_c.sum()
                dcost = torch.where(
                    init_res > 0,
                    torch.clamp((init_res - final_res) / init_res, min=0.0),
                    torch.zeros_like(init_res))
                nerr_acc[cj] = dcost
                J[cj] = Jn
                xres = xdummy - rp.model8(coh[cj], Jn, sta1, sta2,
                                          chunk_idx[cj])
        total = nerr_acc.sum()
        nerr = torch.where(total > 0,
                           nerr_acc / torch.clamp(total, min=1e-30),
                           nerr_acc)

    # the mean as the JAX package's compiled program takes it: XLA turns
    # the division by M into a multiply by 1/M (one ulp apart at M = 3)
    mean_nu = torch.clamp(nuM.sum() * (1.0 / M), config.nulow,
                          config.nuhigh)
    # host wall split: the solvers read the device every iteration and
    # the refine's line search every evaluation, so each span ends within
    # one small kernel of its device work
    t_refine = time.perf_counter()
    em_s = t_refine - t_em
    lbfgs_k = 0
    if config.max_lbfgs > 0:
        J, res_1, lbfgs_k = refine(x8, coh, sta1, sta2, chunk_idx, J,
                                   wt_base, n_stations, config,
                                   mean_nu=mean_nu if _is_robust(mode)
                                   else None)
    else:
        res_1 = _wres(x8, J, coh, sta1, sta2, chunk_idx, wt_base)
    res_1 = float(res_1)
    return J, {"res_0": res_0, "res_1": res_1, "mean_nu": mean_nu,
               "em_s": em_s, "refine_s": time.perf_counter() - t_refine,
               "nerr": nerr, **trips, "lbfgs_iters": lbfgs_k,
               "rejected_groups": sum(1 for g in groups if not g[2]),
               "groups": groups}
