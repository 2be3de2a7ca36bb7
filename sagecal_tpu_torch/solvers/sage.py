"""SAGE expectation-maximization loop (port of the host-driven half of
``sagecal_tpu/solvers/sage.py``).

Per EM iteration every direction cluster is updated in sequence against
a shared residual: add the cluster's current model back, solve that
cluster per hybrid time chunk (LM, ``solvers/lm.py``), re-subtract. The
iteration budget is re-weighted by each cluster's cost reduction (80%
evenly, 20% by share) on weighted sweeps, and a joint LBFGS refine over
all 8 N Mt parameters follows, with its gradient from
``torch.autograd.grad``.

This slice ports the non-robust LM mode (``-j 1``). The visiting order
comes from :class:`ClusterOrder`, a seeded ``torch.Generator`` shim in
place of the JAX key stream: with ``randomize`` off (``-R 0``) it is the
identity order, exactly as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import time

import numpy as np
import torch

from sagecal_tpu_torch.config import SolverMode
from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.solvers import lbfgs as lbfgs_mod
from sagecal_tpu_torch.solvers import lm as lm_mod
from sagecal_tpu_torch.solvers import normal_eq as ne


class SageConfig(NamedTuple):
    max_emiter: int = 3
    max_iter: int = 10            # LM iterations per cluster solve (-g)
    max_lbfgs: int = 10           # joint refine iterations (-l)
    lbfgs_m: int = 7              # LBFGS memory (-m)
    solver_mode: int = int(SolverMode.LM_LBFGS)
    nulow: float = 2.0
    nuhigh: float = 30.0
    randomize: bool = True
    inner: str = "chol"
    kernel: str = "pallas"
    jones_mode: str = "full"
    # row baseline period of the [tilesz, nbase] layout (fused sweep)
    nbase: int = 0


_PORTED_MODES = (int(SolverMode.LM_LBFGS),)


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


def refine(x8, coh, sta1, sta2, chunk_idx, J, wt_base, n_stations: int,
           config: SageConfig):
    """Joint LBFGS refine of all clusters' Jones (``sage._jit_refine``,
    non-robust cost sum((x - model) w)^2). Returns (J, res, iters)."""
    M, kmax = J.shape[0], J.shape[1]
    shape = (M * kmax, n_stations, 8)
    p0 = ne.jones_c2r(J.reshape(M * kmax, n_stations, 2, 2)).reshape(-1)
    p0 = p0.to(x8.dtype).detach()

    def p_to_J(p):
        return ne.jones_r2c(p.reshape(shape)).reshape(
            M, kmax, n_stations, 2, 2)

    def cost_fn(p):
        with torch.no_grad():
            r = (x8 - full_model8(p_to_J(p), coh, sta1, sta2,
                                  chunk_idx)) * wt_base
            return (r * r).sum()

    def grad_fn(p):
        with torch.enable_grad():
            pv = p.detach().requires_grad_(True)
            r = (x8 - full_model8(p_to_J(pv), coh, sta1, sta2,
                                  chunk_idx)) * wt_base
            (g,) = torch.autograd.grad((r * r).sum(), pv)
        return g

    p1, k = lbfgs_mod.lbfgs_fit(cost_fn, grad_fn, p0, itmax=config.max_lbfgs,
                                M=config.lbfgs_m, return_iters=True)
    Jn = p_to_J(p1)
    return Jn, _wres(x8, Jn, coh, sta1, sta2, chunk_idx, wt_base), k


def sagefit_host(x8, coh, sta1, sta2, chunk_idx, chunk_mask, J0,
                 n_stations: int, wt_base, nu0=None,
                 config: SageConfig = SageConfig(), seed: int = 42):
    """One solve interval of SAGE-EM calibration with the EM and
    cluster loops on the host.

    x8 [B, 8] channel-averaged data; coh [M, B, 2, 2] solve
    coherencies; chunk_idx [M, B]; chunk_mask [M, Kmax] bool; J0
    [M, Kmax, N, 2, 2]; wt_base [B, 8]. Returns (J, info) with
    res_0/res_1 = ||residual w||_2 / (8 B), mean_nu and executed trips."""
    if int(config.solver_mode) not in _PORTED_MODES:
        raise NotImplementedError(
            f"solver mode -j {int(config.solver_mode)} is not ported yet: "
            "this slice runs -j 1 (ROADMAP: the next slice ports -j 5 "
            "robust RTR/NSD, OS-LM and robust LM)")
    M = coh.shape[0]
    dtype = x8.dtype
    dev = x8.device
    if nu0 is None:
        nu0 = config.nulow
    total_iter = M * config.max_iter
    iter_bar = int(-(-0.8 * total_iter // M))
    itcap = int(config.max_iter) + iter_bar
    shim = ClusterOrder(seed)
    lm_cfg = lm_mod.LMConfig(itmax=itcap, inner=config.inner,
                             kernel=config.kernel,
                             jones_mode=config.jones_mode)
    chunk_idx = chunk_idx.long()
    sta1, sta2 = sta1.long(), sta2.long()

    xres = x8 - full_model8(J0, coh, sta1, sta2, chunk_idx)
    res_0 = torch.linalg.vector_norm(xres * wt_base) / (x8.shape[0] * 8)
    J = J0.clone()
    nerr = torch.zeros((M,), dtype=dtype, device=dev)
    nuM = torch.full((M,), float(nu0), dtype=dtype, device=dev)
    solver_iters = 0
    t_em = time.perf_counter()
    for ci in range(config.max_emiter):
        weighted = config.randomize and (ci % 2 == 1)
        order = shim.order(ci, M, nerr, weighted, config.randomize)
        nerr_host = nerr.cpu().numpy() if weighted else None
        nerr_acc = torch.zeros((M,), dtype=dtype, device=dev)
        for cj in (int(c) for c in order):
            if weighted:
                itermax = int(np.asarray(
                    0.2 * nerr_host[cj] * total_iter).astype(np.int32)) \
                    + iter_bar
            else:
                itermax = config.max_iter
            xdummy = xres + rp.model8(coh[cj], J[cj], sta1, sta2,
                                      chunk_idx[cj])
            Jn, info = lm_mod.lm_solve(
                xdummy, coh[cj], sta1, sta2, chunk_idx[cj], wt_base, J[cj],
                n_stations, chunk_mask=chunk_mask[cj], config=lm_cfg,
                itmax_dynamic=itermax, row_period=int(config.nbase))
            solver_iters += int(info["iters"])
            init_res = info["init_cost"].sum()
            final_res = info["final_cost"].sum()
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

    mean_nu = torch.clamp(nuM.mean(), config.nulow, config.nuhigh)
    # host wall split: the LM loop reads the device every iteration and
    # the refine's line search every evaluation, so each span ends within
    # one small kernel of its device work
    t_refine = time.perf_counter()
    em_s = t_refine - t_em
    lbfgs_k = 0
    if config.max_lbfgs > 0:
        J, res_1, lbfgs_k = refine(x8, coh, sta1, sta2, chunk_idx, J,
                                   wt_base, n_stations, config)
    else:
        res_1 = _wres(x8, J, coh, sta1, sta2, chunk_idx, wt_base)
    res_1 = float(res_1)
    return J, {"res_0": res_0, "res_1": res_1, "mean_nu": mean_nu,
               "em_s": em_s, "refine_s": time.perf_counter() - t_refine,
               "nerr": nerr, "solver_iters": solver_iters,
               "lbfgs_iters": lbfgs_k}
