"""Batched Levenberg-Marquardt on per-(cluster, time-chunk) Jones blocks
(port of ``sagecal_tpu/solvers/lm.py``).

Every hybrid time chunk of a cluster is an independent 8N-parameter
problem; all chunks solve together as one batched damped Gauss-Newton
iteration. This slice ports the ``blocks_chol`` route (``lm.py:439``):
each damping iteration is ONE fused sweep over the rows
(``ops/sweep.py``, the CUDA kernel on the card) giving the per-baseline
Gram blocks, gradient and acceptance cost at the trial point, and the
damped system assembles, factors and solves from those blocks.

Damping schedule (classic levmar): mu0 = tau * max(diag(JTJ)); accept
when the gain ratio rho > 0 with mu *= max(1/3, 1 - (2 rho - 1)^3);
reject -> mu *= nu, nu *= 2.

The iteration loop is a Python loop that reads one [K]-bool back per
iteration to decide whether any chunk is still live (the JAX
``while_loop`` condition); everything else stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sagecal_tpu_torch.ops import sweep as swp
from sagecal_tpu_torch.solvers import normal_eq as ne


#: executed-iteration counters a solver info dict may carry
TRIP_KEYS = ("solver_iters", "cg_iters", "lbfgs_iters", "rejected_groups")


def executed_trips(info) -> dict:
    """Host-side executed-trip totals: the sum of each
    :data:`TRIP_KEYS` entry present in a solver ``info`` dict."""
    if not isinstance(info, dict):
        return {}
    return {k: int(torch.as_tensor(info[k]).sum()) for k in TRIP_KEYS
            if k in info}


class LMConfig(NamedTuple):
    itmax: int = 10
    tau: float = 1e-3          # CLM_INIT_MU
    eps1: float = 1e-15        # ||JTe||_inf stop
    eps2: float = 1e-15        # ||dp||/||p|| stop
    eps3: float = 1e-15        # ||e||^2 stop
    jitter: float = 1e-9       # Cholesky regularization floor
    inner: str = "chol"        # only "chol" is ported
    kernel: str = "pallas"     # only the fused sweep is ported
    jones_mode: str = "full"


def _check(config: LMConfig, kmax: int, row_period: int, B: int) -> None:
    if config.inner != "chol":
        raise NotImplementedError(
            "--inner cg is not ported yet (ROADMAP queue A item 9 with the "
            "blocks matvec kernel, queue B item 3)")
    if config.kernel != "pallas":
        raise NotImplementedError(
            "--kernel xla needs the XLA normal-equation assembly, not "
            "ported yet (ROADMAP queue A item 3)")
    if config.jones_mode != "full":
        raise NotImplementedError(
            f"--jones {config.jones_mode} is not ported yet (ROADMAP queue "
            "A item 9)")
    if not swp.supported(kmax, row_period, B):
        raise NotImplementedError(
            f"the fused sweep needs baseline-major rows and at most "
            f"{swp.MAX_CHUNKS} hybrid chunks (kmax={kmax}, row_period="
            f"{row_period}, B={B}); the generic XLA assembly is ROADMAP "
            "queue A item 3")


def lm_solve(x8, coh, sta1, sta2, chunk_id, wt, J0, n_stations: int,
             chunk_mask=None, config: LMConfig = LMConfig(),
             itmax_dynamic=None, row_period: int = 0):
    """Levenberg-Marquardt solve of all chunks of one cluster.

    x8 [B, 8] data (residual + this cluster's model); coh [B, 2, 2];
    sta1/sta2/chunk_id [B]; wt [B, 8] sqrt-weights; J0 [K, N, 2, 2];
    chunk_mask [K] bool; ``itmax_dynamic`` an optional iteration cap
    <= config.itmax. Returns (J [K, N, 2, 2], info) with init_cost /
    final_cost [K] and iters (executed iterations)."""
    kmax = J0.shape[0]
    _check(config, kmax, row_period, x8.shape[0])
    dev = x8.device
    dtype = x8.dtype
    N = n_stations
    p = ne.jones_c2r(J0).reshape(kmax, -1).to(dtype)
    if chunk_mask is None:
        chunk_mask = torch.ones((kmax,), dtype=torch.bool, device=dev)

    def p_to_J(pv):
        return ne.jones_r2c(pv.reshape(kmax, N, 8))

    def nrm_eq(pv):
        return swp.gn_blocks(x8, p_to_J(pv), coh, sta1, sta2, chunk_id, wt,
                             N, kmax, row_period)

    fac, JTe, cost = nrm_eq(p)
    cost0 = cost
    dd = torch.diagonal(fac.D, dim1=-2, dim2=-1)
    diag_max = dd.reshape(kmax, -1).abs().amax(dim=-1)
    mu = config.tau * torch.clamp(diag_max, min=1e-30)
    nu = torch.full((kmax,), 2.0, dtype=dtype, device=dev)
    stop = torch.zeros((kmax,), dtype=torch.bool, device=dev)
    itmax = config.itmax if itmax_dynamic is None else \
        min(int(itmax_dynamic), config.itmax)

    k = 0
    while k < itmax and bool((~stop & chunk_mask).any()):
        dp, ok = swp.solve_damped_blocks(fac, JTe, mu, config.jitter,
                                         sta1, sta2, N)
        pnew = p + dp
        facn, JTen, cost_new = nrm_eq(pnew)
        dL = (dp * (mu[:, None] * dp + JTe)).sum(dim=-1)
        dF = cost - cost_new
        accept = ok & (dF > 0) & (dL > 0) & ~stop & chunk_mask
        rho = dF / torch.clamp(dL, min=1e-30)
        mu_acc = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                  min=1.0 / 3.0)
        mu = torch.where(accept, mu_acc, mu * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        small_dp = (torch.linalg.vector_norm(dp, dim=-1)
                    <= config.eps2 * (torch.linalg.vector_norm(p, dim=-1)
                                      + 1e-30))
        p = torch.where(accept[:, None], pnew, p)
        cost = torch.where(accept, cost_new, cost)
        # rejected chunks keep their entering blocks and gradient
        fac = swp.GNBlocks(*(
            torch.where(accept.reshape((kmax,) + (1,) * (new.ndim - 1)),
                        new, old) for new, old in zip(facn, fac)))
        JTe = torch.where(accept[:, None], JTen, JTe)
        small_grad = JTe.abs().amax(dim=-1) <= config.eps1
        small_cost = cost <= config.eps3
        stop = stop | small_grad | (accept & small_dp) | small_cost \
            | (k + 1 >= itmax)
        k += 1
    J = p_to_J(p)
    J = torch.where(chunk_mask[:, None, None, None], J, J0.to(J.dtype))
    return J, {"init_cost": cost0, "final_cost": cost, "iters": k}


def make_weights(flags, dtype=torch.float32):
    """[B, 8] sqrt-weights from row flags: only flag == 0 rows enter the
    solve (flag 2 = uv-cut rows are subtracted but not solved on)."""
    return (flags == 0).to(dtype)[:, None].expand(-1, 8).contiguous()
