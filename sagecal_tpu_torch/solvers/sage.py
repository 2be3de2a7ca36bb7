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

Batches of solve intervals (:func:`sagefit_host_tiles`, ``--tile-batch``):
T tiles solve together, each with its own visiting order, caps, OS draws
and nu. Every sweep step is one lane-batched solve over the T tiles'
visits (T G lanes under groups, each tile's relaxation its own), where
the JAX package vmaps the whole solve over tiles; the refine then runs
tile after tile. :func:`sagefit_host` is the same loop at T = 1.

Consensus ADMM (``admm=(Y, BZ, rho)``, ``sage.sagefit``'s ``admm`` in
the JAX package; sagefit_visibilities_admm, admm_solve.c:221): every
cluster visit solves the augmented Lagrangian with its cluster's slice
(Y[m], BZ[m], rho[m]) (``lm.admm_terms``; a group's visits each their
own), and the joint refine is skipped (the reference calls it with
max_lbfgs = 0, sagecal_slave.cpp:644-667).

:func:`bfgsfit` is the LBFGS-only joint fit of the per-channel bandpass
solve (``-b 1``): the refine alone, warm-started.

Reduced storage (``SageConfig.dtype_policy`` bf16 or f16): the data and
the row weights are rounded to the storage dtype at entry, the running
residual stays in it (each model added or subtracted rounded to it first,
``sage.py:544-547`` and ``:991-993`` of the JAX package), and every norm,
cost reduction and the EM state (nu, cost reductions, the refine's
parameters) is float32.

One subband's rows over ranks (``SageConfig.rows``, a
``parallel.RowGroup``; ``--shard-baselines``, ``parallel.py``): each rank
holds whole timeslots of the tile and every solver sums its row
contractions over the ranks (``lm.py``, ``rtr.py``, ``robust.py``); here
the residual norms (res_0, res_1, divided by the tile's real row count),
the in-flight groups' relaxation trials and sweep anchors, the refine's
cost and gradient (the gradient summed after autograd forms each rank's
own) and the clusters' shared-chunk-id table. Every host decision then
reads summed values, and J comes back the same on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import time

import numpy as np
import torch

from sagecal_tpu_torch import dtypes
from sagecal_tpu_torch.config import SolverMode
from sagecal_tpu_torch.ops import sweep as swp
from sagecal_tpu_torch.parallel import row_sum
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
    # --linsolv 0/1/2 (Cholesky, QR, SVD in the reference): carried for
    # parity and selecting nothing, as in the JAX package, whose damped
    # solves fold the QR/SVD fallbacks into one jittered Cholesky retry
    # (lm._solve_damped)
    linsolv: int = 1
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
    dtype_policy: str = "f32"     # --dtype-policy (dtypes.py)
    # the row group of a sharded solve (parallel.RowGroup)
    rows: object = None


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


def _wres2(xres, wt_base, rows=None):
    """The weighted residual L2^2, summed in the accumulator dtype (and
    over the ranks of ``rows``)."""
    return row_sum((dtypes.acc(xres * wt_base) ** 2).sum(), rows, "res")


def _norm8(r, rows):
    """||r||_2 / (8 B) of weighted residual rows ``r``: B the rows of
    ``r``, or with ``rows`` the tile's real rows, the squares summed over
    the ranks."""
    if rows is None:
        return torch.linalg.vector_norm(r) / (r.shape[0] * 8)
    return torch.sqrt(row_sum((r * r).sum(), rows, "res")) \
        / (rows.n_rows * 8)


def _wres(x8, J, coh, sta1, sta2, chunk_idx, wt_base, rows=None):
    """||(x - model) * w||_2 / (8 B) (the model sum in float32 or
    float64, so the residual is too)."""
    r = (x8 - full_model8(J, coh, sta1, sta2, chunk_idx)) * wt_base
    return _norm8(r, rows)


def _cluster_solve(mode: int, xdummy, coh_m, sta1, sta2, cidx_m, cmask_m,
                   wt_base, J_m, n_stations: int, nu_cj, config: SageConfig,
                   itermax, itcap: int, os_cfg, last: bool, lists,
                   lanes=None, admm=None):
    """One cluster's per-chunk solve by solver mode (``sage._cluster_solve``,
    lmfit.c:906-962); ``lists`` the tile's station lists for the matvec
    kernel (``inner="cg"``). Returns (Jn, nu_new, init_cost [K],
    final_cost [K], iters, cg_iters, tcg_iters). With ``lanes`` the
    arguments are an in-flight group's folded layout (``lm.lm_solve``):
    nu_cj [V], itermax an int array and os_cfg a list, one per visit;
    nu_new, iters and cg_iters are then per visit. ``admm`` the
    cluster's (y, bz, rho) slice, folded like the rest on a group."""
    nbase = int(config.nbase)
    lm_cfg = lm_mod.LMConfig(itmax=itcap, inner=config.inner,
                             kernel=config.kernel,
                             jones_mode=config.jones_mode,
                             dtype_policy=config.dtype_policy,
                             rows=config.rows)

    def plain_lm(os=None):
        Jn, info = lm_mod.lm_solve(
            xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m, n_stations,
            chunk_mask=cmask_m, config=lm_cfg, itmax_dynamic=itermax,
            os=os, row_period=nbase, lists=lists, lanes=lanes, admm=admm)
        return (Jn, nu_cj, info["init_cost"], info["final_cost"],
                info["iters"], info["cg_iters"], 0)

    def robust_lm(os=None):
        Jn, nu_new, info = rb.robust_lm_solve(
            xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m, n_stations,
            nu0=nu_cj, nulow=config.nulow, nuhigh=config.nuhigh,
            chunk_mask=cmask_m, config=lm_cfg, wt_rounds=3,
            itmax_dynamic=itermax, os=os, row_period=nbase, lists=lists,
            lanes=lanes, admm=admm)
        return (Jn, nu_new, info["init_cost"], info["final_cost"],
                info["iters"], info["cg_iters"], 0)

    if mode in (int(SolverMode.RTR_OSLM_LBFGS),
                int(SolverMode.RTR_OSRLM_RLBFGS)):
        rtr_cfg = rtr_mod.RTRConfig(itmax=itcap, inner=config.inner,
                                    kernel=config.kernel,
                                    jones_mode=config.jones_mode,
                                    dtype_policy=config.dtype_policy,
                                    rows=config.rows)
        if mode == int(SolverMode.RTR_OSLM_LBFGS):
            Jn, info = rtr_mod.rtr_solve(
                xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m,
                n_stations, chunk_mask=cmask_m, config=rtr_cfg,
                itmax_dynamic=itermax, row_period=nbase, lists=lists,
                lanes=lanes, admm=admm)
            nu_new = nu_cj
        else:
            # 2 rounds: the reference robust RTR updates the weights
            # once before and once after the TR loop
            Jn, nu_new, info = rtr_mod.rtr_solve_robust(
                xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m,
                n_stations, nu0=nu_cj, nulow=config.nulow,
                nuhigh=config.nuhigh, chunk_mask=cmask_m, config=rtr_cfg,
                wt_rounds=2, itmax_dynamic=itermax, row_period=nbase,
                lists=lists, lanes=lanes, admm=admm)
        return (Jn, nu_new, info["init_cost"], info["final_cost"],
                info["iters"], 0, info["tcg_iters"])

    if mode == int(SolverMode.NSD_RLBFGS):
        nsd_cfg = rtr_mod.NSDConfig(itmax=2 * itcap,
                                    jones_mode=config.jones_mode,
                                    rows=config.rows)
        Jn, nu_new, info = rtr_mod.nsd_solve_robust(
            xdummy, coh_m, sta1, sta2, cidx_m, wt_base, J_m, n_stations,
            nu0=nu_cj, nulow=config.nulow, nuhigh=config.nuhigh,
            chunk_mask=cmask_m, config=nsd_cfg, itmax_dynamic=2 * itermax,
            lanes=lanes, admm=admm)
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
                 model_old, wt_base, res_old, anchor, rows=None):
    """One damped block-Jacobi step at relaxation ``w``
    (``sage._omega_trial``): J(w) = J_old + w (J_solved - J_old) applied
    jointly. Returns (ok, margin, xnew, J(w)): ok when the weighted
    residual L2^2 is at most the entry's (1 + 1e-9) or 1.05 x the sweep's
    anchor; margin = (threshold - rn) / threshold, read with ok in one
    device read."""
    Jr_g = Jo_g + w * (Jn_g - Jo_g)
    model_new = torch.stack([rp.model8(coh_g[v], Jr_g[v], sta1, sta2,
                                       cidx_g[v], out_dtype=xres.dtype)
                             for v in range(Jr_g.shape[0])])
    xnew = xres + dtypes.to_storage(
        dtypes.acc(model_old - model_new).sum(dim=0), xres.dtype)
    rn = _wres2(xnew, wt_base, rows)
    ok = (rn <= res_old * (1.0 + 1e-9)) | (rn <= 1.05 * anchor)
    thr = torch.maximum(res_old * (1.0 + 1e-9), 1.05 * anchor)
    ok_h, margin = torch.stack([ok.to(rn.dtype),
                                (thr - rn) / thr]).tolist()
    return bool(ok_h), margin, xnew, Jr_g


def _group_solve(mode: int, xd_g, coh_g, cidx_g, cmask_g, J_g, nu_g, sta1,
                 sta2, wt_base, n_stations: int, config: SageConfig,
                 itermax, itcap: int, os_cfgs, last: bool, lists,
                 cid_shared: bool, tiles: int = 1, admm=None):
    """V cluster visits as one lane-batched solve, each against its own
    add-back ``xd_g`` [V, B, 8] (``jax.vmap(solve_one)`` of
    ``sage._group_update``; under ``--tile-batch`` the vmap over tiles):
    coh_g [V, B, 2, 2], cidx_g [V, B], cmask_g [V, K], J_g [V, K, N, 2, 2],
    nu_g [V]; ``wt_base`` [B, 8] shared by every visit or [V B, 8] folded
    per visit; ``itermax`` and ``os_cfgs`` one per visit; ``cid_shared``
    when every visit has the same chunk ids; ``tiles`` the solve intervals
    whose visits the lanes hold, tile-major (``swp.Lanes.tiles``). A lone
    visit (V = 1) is solved unfolded, on the single-visit sweep.
    ``admm`` the visits' (Y [V, K, N, 8], BZ, rho [V]) or None. Returns
    (Jn [V, K, N, 2, 2], nu [V], init_cost [V, K], final_cost [V, K],
    iters [V], cg_iters [V], tcg_iters [tiles])."""
    V, K = J_g.shape[0], J_g.shape[1]
    B = xd_g.shape[1]
    if V == 1:
        Jn, nu_new, ic, fc, its, cgs, tcgs = _cluster_solve(
            mode, xd_g[0], coh_g[0], sta1, sta2, cidx_g[0], cmask_g[0],
            wt_base, J_g[0], n_stations, nu_g[0], config, int(itermax[0]),
            itcap, None if os_cfgs is None else os_cfgs[0], last, lists,
            admm=None if admm is None else tuple(a[0] for a in admm))
    else:
        lanes = swp.Lanes(V, K, cidx_g[0] if cid_shared else cidx_g, tiles)
        off = torch.arange(V, device=cidx_g.device)[:, None] * K
        Jn, nu_new, ic, fc, its, cgs, tcgs = _cluster_solve(
            mode, xd_g.reshape(V * B, 8), coh_g.reshape(V * B, 2, 2),
            sta1.repeat(V), sta2.repeat(V), (cidx_g + off).reshape(V * B),
            cmask_g.reshape(V * K), wt_base,
            J_g.reshape((V * K,) + J_g.shape[2:]), n_stations, nu_g, config,
            np.asarray(itermax), itcap, os_cfgs, last, lists, lanes=lanes,
            admm=None if admm is None else (
                admm[0].reshape(V * K, -1), admm[1].reshape(V * K, -1),
                admm[2].repeat_interleave(K)))
    nu_new = torch.as_tensor(nu_new, dtype=nu_g.dtype,
                             device=nu_g.device).expand(V)
    return (Jn.view(J_g.shape), nu_new, ic.view(V, K), fc.view(V, K),
            np.broadcast_to(its, (V,)), np.broadcast_to(cgs, (V,)),
            np.broadcast_to(tcgs, (tiles,)))


class _Visits(NamedTuple):
    """One step's visits of a batch of T solve intervals, tile t visiting
    the G clusters ``cjs[t]`` (lane t G + j), and their lane-batched
    solve: ``tt``/``cc`` the lanes' tile and cluster indices, ``xd``
    the add-backs [V, B, 8], ``coh``/``cidx``/``J_old`` the lanes'
    operands, then :func:`_group_solve`'s outputs."""

    tt: torch.Tensor
    cc: torch.Tensor
    xd: torch.Tensor
    coh: torch.Tensor
    cidx: torch.Tensor
    J_old: torch.Tensor
    Jn: torch.Tensor
    nu: torch.Tensor
    init_cost: torch.Tensor
    final_cost: torch.Tensor
    iters: np.ndarray
    cg_iters: np.ndarray
    tcg_iters: np.ndarray


def _visit_lanes(cjs, J, xres, nuM, coh, sta1, sta2, chunk_idx, chunk_mask,
                 wt_base, n_stations: int, config: SageConfig, itermax,
                 itcap: int, os_cfgs, last: bool, lists, same_cid,
                 admm=None) -> _Visits:
    """Solve the visits ``cjs`` [T, G] (host ints) of T tiles as one
    lane-batched solve at V = T G: J [T, M, K, N, 2, 2], xres [T, B, 8],
    nuM [T, M], coh [T, M, B, 2, 2], wt_base [T, B, 8] (one tile's weights
    stay shared by its lanes); ``itermax`` and ``os_cfgs`` one per lane;
    ``same_cid`` the [M, M] host table of clusters with equal chunk ids,
    which decides whether the lanes share theirs; ``admm`` the tiles'
    (Y [T, M, K, N, 8], BZ, rho [T, M]) or None."""
    T, G = cjs.shape
    dev = xres.device
    tt_h, cc_h = np.repeat(np.arange(T), G), cjs.reshape(-1)
    tt, cc = (torch.as_tensor(a, device=dev) for a in (tt_h, cc_h))
    coh_g, cidx_g, J_o = coh[tt, cc], chunk_idx[cc], J[tt, cc]
    xd_g = torch.stack([xres[t] + rp.model8(coh[t, c], J[t, c], sta1, sta2,
                                            chunk_idx[c], out_dtype=xres.dtype)
                        for t, c in zip(tt_h.tolist(), cc_h.tolist())])
    if T == 1:
        wt_g = wt_base[0]
    else:
        wt_g = wt_base.repeat_interleave(G, dim=0).reshape(-1, 8)
    out = _group_solve(
        int(config.solver_mode), xd_g, coh_g, cidx_g, chunk_mask[cc], J_o,
        nuM[tt, cc], sta1, sta2, wt_g, n_stations, config, itermax,
        itcap, os_cfgs, last, lists, bool(same_cid[cc_h[0], cc_h].all()),
        tiles=T, admm=None if admm is None else tuple(a[tt, cc]
                                                      for a in admm))
    return _Visits(tt, cc, xd_g, coh_g, cidx_g, J_o, *out)


def _group_update(cjs, J, xres, nuM, nerr_acc, coh, sta1, sta2, chunk_idx,
                  chunk_mask, wt_base, n_stations: int, config: SageConfig,
                  itermax, itcap: int, os_cfgs, last: bool, lists, anchor,
                  same_cid, admm=None):
    """Visit a GROUP of clusters concurrently in each of T tiles: tile t
    the clusters ``cjs[t]`` ([T, G] host ints; ``sage._group_update``,
    sage.py:552, and its tile vmap ``_jit_group_update_tiles``; the state
    tile-major as :func:`_visit_lanes` takes it, one tile's for a single
    solve interval), the T G member solves one lane-batched solve. Every
    member solves against
    its tile's residual as of group entry; the entering models fall out
    of the add-backs (no second model evaluation); per tile the joint
    update is tried at the :data:`OMEGAS` against the tile's own entry
    residual and sweep anchor (``anchor`` [T]) and the first safe one is
    applied to J, the residual, nu and the cost reductions. A group no
    relaxation makes safe leaves its tile's state as it was. A ragged
    last group simply has fewer members: no padded slot is solved (the
    reference pads with an out-of-range index instead, whose NaN lane
    rejects the group: ROADMAP queue C).

    Updates J, xres, nuM and nerr_acc in place; returns one record a tile,
    dict(omega, margins, solver_iters, cg_iters, tcg_iters), omega 0.0 for
    a rejected group and margins those of the trials made."""
    T, G = cjs.shape
    vis = _visit_lanes(cjs, J, xres, nuM, coh, sta1, sta2, chunk_idx,
                       chunk_mask, wt_base, n_stations, config, itermax,
                       itcap, os_cfgs, last, lists, same_cid, admm)
    model_old = (vis.xd.view((T, G) + xres.shape[1:])
                 - xres[:, None]).view(vis.xd.shape)
    init_res, final_res = vis.init_cost.sum(dim=-1), vis.final_cost.sum(dim=-1)
    dcost = torch.where(
        init_res > 0,
        torch.clamp((init_res - final_res)
                    / torch.clamp(init_res, min=1e-30), min=0.0),
        torch.zeros_like(init_res))
    recs = []
    for t in range(T):
        sl = slice(t * G, (t + 1) * G)
        res_old = _wres2(xres[t], wt_base[t], config.rows)
        margins = []
        omega = 0.0
        for w in OMEGAS:
            ok, margin, xnew, Jr = _omega_trial(
                w, vis.J_old[sl], vis.Jn[sl], vis.coh[sl], vis.cidx[sl],
                sta1, sta2, xres[t], model_old[sl], wt_base[t], res_old,
                anchor[t], config.rows)
            margins.append(margin)
            if ok:
                omega = w
                break
        recs.append({"omega": omega, "margins": margins,
                     "solver_iters": int(vis.iters[sl].sum()),
                     "cg_iters": int(vis.cg_iters[sl].sum()),
                     "tcg_iters": int(vis.tcg_iters[t])})
        if omega:
            idx = vis.cc[sl]
            nerr_acc[t, idx] = dcost[sl]
            nuM[t, idx] = vis.nu[sl]
            J[t, idx] = Jr
            xres[t] = xnew
    return recs


def _cluster_update(cjs, J, xres, nuM, nerr_acc, coh, sta1, sta2,
                    chunk_idx, chunk_mask, wt_base, n_stations: int,
                    config: SageConfig, itermax, itcap: int, os_cfgs,
                    last: bool, lists, same_cid, admm=None):
    """One step of a sequential sweep in each of T tiles (``sage._jit_
    cluster_update`` and its tile vmap ``_jit_cluster_update_tiles``,
    sage.py:1551): tile t visits cluster ``cjs[t]`` ([T] host ints), the T
    visits one lane-batched solve (:func:`_visit_lanes` at G = 1; a single
    solve interval's visit unfolded). Each tile's J, nu and cost reduction
    are updated in place and its residual is its add-back less the solved
    cluster's model. Returns (xres, iters [T], cg_iters [T], tcg_iters
    [T])."""
    vis = _visit_lanes(cjs[:, None], J, xres, nuM, coh, sta1, sta2,
                       chunk_idx, chunk_mask, wt_base, n_stations, config,
                       itermax, itcap, os_cfgs, last, lists, same_cid, admm)
    init_res, final_res = vis.init_cost.sum(dim=-1), vis.final_cost.sum(dim=-1)
    nerr_acc[vis.tt, vis.cc] = torch.where(
        init_res > 0, torch.clamp((init_res - final_res) / init_res,
                                  min=0.0), torch.zeros_like(init_res))
    nuM[vis.tt, vis.cc] = vis.nu
    J[vis.tt, vis.cc] = vis.Jn
    xres = torch.stack([vis.xd[t] - rp.model8(vis.coh[t], vis.Jn[t], sta1,
                                              sta2, vis.cidx[t],
                                              out_dtype=xres.dtype)
                        for t in range(len(cjs))])
    return xres, vis.iters, vis.cg_iters, vis.tcg_iters


def refine_problem(x8, coh, sta1, sta2, chunk_idx, J, wt_base,
                   n_stations: int, config: SageConfig, mean_nu=None):
    """The joint refine's problem at J (``sage._refine_cost_fn``): (p0,
    p_to_J, cost_fn, grad_fn) over the parameters of
    ``config.jones_mode`` (the constrained J is the reference point
    Jref), the cost sum((x - model) w)^2, or with ``mean_nu`` the
    Student's-t sum log1p(((x - model) w)^2 / mean_nu), its gradient by
    ``torch.autograd``. With ``config.rows`` the cost is summed over the
    ranks, and so is the gradient, after autograd has formed the rank's
    own."""
    rows = config.rows
    M, kmax = J.shape[0], J.shape[1]
    mode = config.jones_mode
    shape = (M * kmax, n_stations, ne.jones_npar(mode))
    p0, Jref = ne.mode_point(J.reshape(M * kmax, n_stations, 2, 2), mode)
    p0 = p0.reshape(-1).to(dtypes.acc_dtype(x8.dtype)).detach()

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
            return row_sum(objective(p), rows, "refine")

    def grad_fn(p):
        with torch.enable_grad():
            pv = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(pv), pv)
        return row_sum(g, rows, "refine")

    return p0, p_to_J, cost_fn, grad_fn


def refine(x8, coh, sta1, sta2, chunk_idx, J, wt_base, n_stations: int,
           config: SageConfig, mean_nu=None):
    """Joint LBFGS refine of all clusters' Jones (``sage._jit_refine``)
    on :func:`refine_problem`. Returns (J, res, iters)."""
    p0, p_to_J, cost_fn, grad_fn = refine_problem(
        x8, coh, sta1, sta2, chunk_idx, J, wt_base, n_stations, config,
        mean_nu)
    p1, k = lbfgs_mod.lbfgs_fit(cost_fn, grad_fn, p0, itmax=config.max_lbfgs,
                                M=config.lbfgs_m, return_iters=True)
    Jn = p_to_J(p1)
    return Jn, _wres(x8, Jn, coh, sta1, sta2, chunk_idx, wt_base,
                     config.rows), k


def bfgsfit(x8, coh, sta1, sta2, chunk_idx, J0, n_stations: int,
            wt_base, config: SageConfig = SageConfig(), nu: float = 2.0):
    """LBFGS-only joint solve over all clusters (``sage.bfgsfit``;
    ``bfgsfit_visibilities``, lmfit.c:1127): the per-channel bandpass
    solver of ``-b 1`` (fullbatch_mode.cpp:442-488). :func:`refine` from
    ``J0`` (constrained to ``config.jones_mode``) with ``config.max_lbfgs``
    iterations of memory ``config.lbfgs_m``, on the Student's-t cost
    sum log1p(r^2 / nu) in the robust solver modes (the caller passes
    ``-L``) and sum r^2 otherwise. Returns (J, info) with res_0/res_1 =
    ||residual w||_2 / (8 B) at J0 and J, and lbfgs_iters. The data and
    weights are rounded to ``config.dtype_policy``'s storage dtype at
    entry."""
    x8 = dtypes.to_storage(x8, dtypes.storage_dtype(config.dtype_policy,
                                                    x8.dtype))
    wt_base = dtypes.to_storage(wt_base, x8.dtype)
    if config.jones_mode != "full":
        J0 = ne.jones_constrain(J0, config.jones_mode)
    res_0 = _wres(x8, J0, coh, sta1, sta2, chunk_idx, wt_base, config.rows)
    J, res_1, k = refine(
        x8, coh, sta1, sta2, chunk_idx, J0, wt_base, n_stations, config,
        mean_nu=nu if _is_robust(int(config.solver_mode)) else None)
    return J, {"res_0": float(res_0), "res_1": float(res_1),
               "lbfgs_iters": k}


def _budget(config: SageConfig, M: int):
    """(total_iter, iter_bar, itcap): the EM iteration budget of M
    clusters (lmfit.c:1085): weighted sweeps give each cluster iter_bar +
    its share of 0.2 total_iter; itcap bounds every solve's loop."""
    total_iter = M * config.max_iter
    iter_bar = int(-(-0.8 * total_iter // M))
    return total_iter, iter_bar, int(config.max_iter) + iter_bar


def _itermax(config: SageConfig, weighted: bool, nerr_host, cj: int,
             total_iter: int, iter_bar: int) -> int:
    """A cluster visit's iteration cap: max_iter, or on a weighted sweep
    iter_bar + int32(0.2 nerr[cj] total_iter) from the previous sweep's
    cost reductions (``nerr_host``, host floats)."""
    if weighted:
        return int(np.asarray(0.2 * nerr_host[cj] * total_iter).astype(
            np.int32)) + iter_bar
    return config.max_iter


def _os_config(config: SageConfig, os_ids, seed_ci: int, cj: int):
    """A cluster visit's ordered-subsets setting (draws seeded by the
    sweep's seed and the cluster), or None outside the OS modes."""
    if os_ids is None:
        return None
    return lm_mod.OSConfig(os_id=os_ids[0], n_subsets=os_ids[1],
                           seed=lm_mod.fold_in(seed_ci, cj),
                           randomize=config.randomize)


def _setup(config: SageConfig, M: int, sta1, sta2, chunk_idx,
           n_stations: int, os_id, dev):
    """What every solve of M clusters prepares once: (sta1, sta2,
    chunk_idx as int64; the matvec kernel's station lists under ``inner
    == "cg"`` on the card; the OS (ids, count) on the device in the OS
    modes, else None; the [M, M] host table of clusters with equal chunk
    ids, from which a group of visits learns that it shares them; over
    row ranks the rows that differ are counted on every rank)."""
    mode = int(config.solver_mode)
    if mode not in tuple(int(m) for m in SolverMode):
        raise ValueError(f"unknown solver mode -j {mode}")
    chunk_idx = chunk_idx.long()
    sta1, sta2 = sta1.long(), sta2.long()
    lists = (swp.station_lists(sta1, sta2, int(config.nbase), n_stations)
             if config.inner == "cg" and dev.type == "cuda" else None)
    os_ids = None
    if os_id is not None and mode in _OS_MODES:
        os_ids = (torch.as_tensor(np.asarray(os_id[0]), device=dev).long(),
                  int(os_id[1]))
    # M row comparisons (a sort over rows of B ids costs ~1 s on the card)
    differ = torch.stack([(chunk_idx != chunk_idx[i]).sum(dim=-1)
                          for i in range(M)])
    same_cid = (row_sum(differ, config.rows, "setup") == 0).cpu().numpy()
    return sta1, sta2, chunk_idx, lists, os_ids, same_cid


def _nerr(nerr_acc):
    """The next sweep's cost-reduction shares from a sweep's reductions
    (last axis the clusters)."""
    total = nerr_acc.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, nerr_acc / torch.clamp(total, min=1e-30),
                       nerr_acc)


def _finish(x8, coh, sta1, sta2, chunk_idx, J, wt_base, n_stations: int,
            config: SageConfig, nuM, refine_on: bool = True):
    """The end of one tile's solve: mean nu, then the joint refine (or
    the residual alone at -l 0 and under ADMM, ``refine_on`` False).
    Returns (J, res_1, mean_nu, lbfgs
    iterations, refine s)."""
    M = nuM.shape[0]
    # the mean as the JAX package's compiled program takes it: XLA turns
    # the division by M into a multiply by 1/M (one ulp apart at M = 3)
    mean_nu = torch.clamp(nuM.sum() * (1.0 / M), config.nulow,
                          config.nuhigh)
    # host wall: the refine's line search reads the device every
    # evaluation, so the span ends within one small kernel of its work
    t0 = time.perf_counter()
    lbfgs_k = 0
    if config.max_lbfgs > 0 and refine_on:
        J, res_1, lbfgs_k = refine(
            x8, coh, sta1, sta2, chunk_idx, J, wt_base, n_stations, config,
            mean_nu=mean_nu if _is_robust(int(config.solver_mode)) else None)
    else:
        res_1 = _wres(x8, J, coh, sta1, sta2, chunk_idx, wt_base,
                      config.rows)
    return J, float(res_1), mean_nu, lbfgs_k, time.perf_counter() - t0


def sagefit_host(x8, coh, sta1, sta2, chunk_idx, chunk_mask, J0,
                 n_stations: int, wt_base, nu0=None,
                 config: SageConfig = SageConfig(), seed: int = 42,
                 os_id=None, order=None, admm=None):
    """One solve interval of SAGE-EM calibration with the EM and
    cluster loops on the host: :func:`sagefit_host_tiles` at T = 1.

    x8 [B, 8] channel-averaged data; coh [M, B, 2, 2] solve
    coherencies; chunk_idx [M, B]; chunk_mask [M, Kmax] bool; J0
    [M, Kmax, N, 2, 2]; wt_base [B, 8]; ``os_id`` the (ids [B], count)
    pair of ``lm.os_subset_ids`` for the OS modes 0/2/3; ``order`` the
    visiting order (a :class:`ClusterOrder`, by default of ``seed``).
    Returns (J, info) with res_0/res_1 = ||residual w||_2 / (8 B),
    mean_nu and the executed trips (solver_iters, cg_iters, tcg_iters,
    lbfgs_iters).

    With ``config.inflight`` > 1 the sweeps visit the clusters in groups
    (:func:`_group_update`; widths from :func:`_inflight_widths`, cut from
    the same visiting order) and info adds ``rejected_groups`` and
    ``groups``, one (sweep, members, omega, margins) record a group.

    ``admm`` = (Y [M, Kmax, N, 8], BZ [M, Kmax, N, 8], rho [M]) reals:
    the consensus-ADMM solve (module docstring)."""
    J, info = sagefit_host_tiles(
        x8[None], coh[None], sta1, sta2, chunk_idx, chunk_mask, J0[None],
        n_stations, wt_base[None], nu0=nu0, config=config, seeds=[seed],
        os_id=os_id, orders=None if order is None else [order],
        admm=None if admm is None else tuple(
            torch.as_tensor(a, device=x8.device)[None] for a in admm))
    return J[0], {"res_0": info["res_0"][0], "res_1": float(info["res_1"][0]),
                  "mean_nu": info["mean_nu"][0], "em_s": info["em_s"],
                  "refine_s": info["refine_s"], "nerr": info["nerr"][0],
                  **{k: int(info[k][0]) for k in _TILE_TRIPS},
                  "groups": info["groups"][0]}


def tile_seeds(n_tiles: int, base: int = 42) -> list:
    """One seed per tile of a batch (``sage.tile_keys``, sage.py:1355):
    tile 0 keeps the single-tile default, so its draws are the unbatched
    solve's; tile t folds (base, 1000 + t). JAX keys cannot be
    reproduced, so these are seeds of the port's ``torch.Generator``
    shims (:class:`ClusterOrder`, ``lm.OSConfig``)."""
    return [int(base)] + [lm_mod.fold_in(base, 1000 + t)
                          for t in range(1, int(n_tiles))]


#: the per-tile trip counters of :func:`sagefit_host_tiles`
_TILE_TRIPS = ("solver_iters", "cg_iters", "tcg_iters", "lbfgs_iters",
               "rejected_groups")


def sagefit_host_tiles(x8, coh, sta1, sta2, chunk_idx, chunk_mask, J0,
                       n_stations: int, wt_base, nu0=None,
                       config: SageConfig = SageConfig(), seeds=None,
                       os_id=None, orders=None, admm=None):
    """SAGE-EM calibration of T independent solve intervals as one
    lane-batched solve, the EM and cluster loops on the host
    (``sage.sagefit_host_tiles``, sage.py:1367-1548).

    x8 [T, B, 8], coh [T, M, B, 2, 2], J0 [T, M, K, N, 2, 2] and wt_base
    [T, B, 8] per tile; sta1/sta2, chunk_idx and chunk_mask shared (the
    tiles of one dataset have the same baseline order); ``seeds`` one per
    tile (:func:`tile_seeds` by default) and ``orders`` optional visiting
    orders, one :class:`ClusterOrder`-like a tile (by default of its
    seed; tests feed the reference's permutations).

    Each tile visits the clusters in its own order (on weighted sweeps
    by its own cost reductions) with its own caps, OS draws and nu.
    Sweep step cj is one lane-batched solve of T lanes, tile t's lane
    the cluster ``order[t, cj]`` (``_jit_cluster_update_tiles``); under
    ``config.inflight`` a group step is one solve of T G lanes, each
    tile's joint update tried against its own entry residual and sweep
    anchor (``_jit_group_update_tiles``). On the card every such solve
    runs the multi-visit sweep kernel and its products the matvec kernel
    at T kmax chunks. A lane that stops is frozen, as the reference's
    while loops freeze it under vmap, so every tile's result is its own
    solve's. The joint refine runs tile after tile. :func:`sagefit_host`
    is the T = 1 case, whose lone sequential visits solve unfolded.

    ``admm`` the tiles' (Y [T, M, K, N, 8], BZ, rho [T, M]): each
    tile's consensus-ADMM solve, without the refine.

    Returns (J [T, M, K, N, 2, 2], info): res_0, mean_nu [T] and nerr
    [T, M] tensors; res_1 and the trips of ``_TILE_TRIPS`` [T] numpy
    arrays; ``groups`` one list a tile; the batch's ``em_s`` and
    ``refine_s`` and each tile's ``refine_tiles_s``."""
    T, M = coh.shape[0], coh.shape[1]
    seeds = tile_seeds(T) if seeds is None else [int(s) for s in seeds]
    shims = [ClusterOrder(s) for s in seeds] if orders is None \
        else list(orders)
    # the rows in the policy's storage dtype; the EM state in its
    # accumulator dtype
    x8 = dtypes.to_storage(x8, dtypes.storage_dtype(config.dtype_policy,
                                                    x8.dtype))
    wt_base = dtypes.to_storage(wt_base, x8.dtype)
    dtype, dev = dtypes.acc_dtype(x8.dtype), x8.device
    if nu0 is None:
        nu0 = config.nulow
    total_iter, iter_bar, itcap = _budget(config, M)
    sta1, sta2, chunk_idx, lists, os_ids, same_cid = _setup(
        config, M, sta1, sta2, chunk_idx, n_stations, os_id, dev)
    if config.jones_mode != "full":
        J0 = ne.jones_constrain(J0, config.jones_mode)
    # the prelude tile by tile
    xres = torch.stack([x8[t] - dtypes.to_storage(
        full_model8(J0[t], coh[t], sta1, sta2, chunk_idx), x8.dtype)
        for t in range(T)])
    res_0 = torch.stack([_norm8(dtypes.acc(xres[t] * wt_base[t]),
                                config.rows) for t in range(T)])
    J = J0.clone()
    nerr = torch.zeros((T, M), dtype=dtype, device=dev)
    nuM = torch.full((T, M), float(nu0), dtype=dtype, device=dev)
    trips = {k: np.zeros(T, dtype=np.int64) for k in _TILE_TRIPS}
    G0, Gs = _inflight_widths(config, M)
    groups = [[] for _ in range(T)]
    t_em = time.perf_counter()
    for ci in range(config.max_emiter):
        weighted = config.randomize and (ci % 2 == 1)
        last = ci == config.max_emiter - 1
        order = np.stack([shims[t].order(ci, M, nerr[t], weighted,
                                         config.randomize)
                          for t in range(T)])
        nerr_host = nerr.cpu().numpy() if weighted else None
        nerr_acc = torch.zeros((T, M), dtype=dtype, device=dev)
        seed_ci = [lm_mod.fold_in(s, ci) for s in seeds]

        def lanes_of(cjs):
            """Per-lane caps and OS settings of the visits cjs [T, G]."""
            caps = [_itermax(config, weighted,
                             None if nerr_host is None else nerr_host[t], cj,
                             total_iter, iter_bar)
                    for t in range(T) for cj in cjs[t]]
            oss = None if os_ids is None else [
                _os_config(config, os_ids, seed_ci[t], int(cj))
                for t in range(T) for cj in cjs[t]]
            return caps, oss

        Gi = G0 if ci == 0 else Gs
        if Gi > 1:
            # each tile's sweep-entry anchor of the group-step safeguard
            anchor = torch.stack([_wres2(xres[t], wt_base[t], config.rows)
                                  for t in range(T)])
            for g in range(0, M, Gi):
                cjs = order[:, g:g + Gi]
                caps, oss = lanes_of(cjs)
                recs = _group_update(
                    cjs, J, xres, nuM, nerr_acc, coh, sta1, sta2, chunk_idx,
                    chunk_mask, wt_base, n_stations, config, caps, itcap,
                    oss, last, lists, anchor, same_cid, admm)
                for t, rec in enumerate(recs):
                    for key in ("solver_iters", "cg_iters", "tcg_iters"):
                        trips[key][t] += rec[key]
                    trips["rejected_groups"][t] += not rec["omega"]
                    groups[t].append((ci, [int(c) for c in cjs[t]],
                                      rec["omega"], rec["margins"]))
        else:
            for step in range(M):
                cjs = order[:, step]
                caps, oss = lanes_of(cjs[:, None])
                xres, its, cgs, tcgs = _cluster_update(
                    cjs, J, xres, nuM, nerr_acc, coh, sta1, sta2, chunk_idx,
                    chunk_mask, wt_base, n_stations, config, caps, itcap,
                    oss, last, lists, same_cid, admm)
                trips["solver_iters"] += its
                trips["cg_iters"] += cgs
                trips["tcg_iters"] += tcgs
        nerr = _nerr(nerr_acc)
    em_s = time.perf_counter() - t_em

    # the refine tile after tile (a vmapped LBFGS is the per-tile LBFGS)
    res_1 = np.zeros(T)
    mean_nu = []
    refine_s = []
    for t in range(T):
        J[t], res_1[t], mnu, trips["lbfgs_iters"][t], secs = _finish(
            x8[t], coh[t], sta1, sta2, chunk_idx, J[t], wt_base[t],
            n_stations, config, nuM[t], refine_on=admm is None)
        mean_nu.append(mnu)
        refine_s.append(secs)
    return J, {"res_0": res_0, "res_1": res_1,
               "mean_nu": torch.stack(mean_nu), "nerr": nerr, **trips,
               "groups": groups, "em_s": em_s, "refine_s": sum(refine_s),
               "refine_tiles_s": refine_s}
