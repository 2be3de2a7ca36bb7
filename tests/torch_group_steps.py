"""Functions that ``tests/test_torch_distributed.py`` runs on the ranks
of a gloo group (:func:`run_group`); kept apart from the tests, which
import jax, so that the spawned ranks import torch and the port only."""

import numpy as np
import torch

from sagecal_tpu_torch import distributed as dist


def _group_rank(rank, fn, world, port, args):
    group = dist.init(f"127.0.0.1:{port}", world, rank, torch.device("cpu"))
    try:
        return fn(group, *args)
    finally:
        dist.shutdown(group)


def run_group(fn, world, args=(), timeout=900.0):
    """``fn(group, *args)`` on ``world`` CPU ranks of this host joined in
    a gloo group on a free port (``distributed.spawn``); returns the
    results in rank order."""
    return dist.spawn(_group_rank, world,
                      (fn, world, dist.free_port(), args), timeout)


def consensus_step(group, JF, Jr, fratio, B_pad, cmask, nf, cfg_kw,
                   niter):
    """On this rank's slots of the padded subband axis: the grouped
    manifold average of ``JF`` alone, then the runner's consensus step
    after iteration 0 (``iter0_post``) and after one later iteration
    (``body_post`` with the new Jones ``Jr``). JF, Jr [Fpad, M, K, N, 8],
    fratio [Fpad] (every slot, padded ones included; each rank takes its
    own); B_pad the padded basis, cfg_kw the ``ADMMConfig`` fields.
    Returns numpy arrays of this rank's slots: the manifold average,
    then Y0F, Z, YF and rhoF after iteration 0, then Z, YF, rhoF and the
    dual after the body step."""
    from sagecal_tpu_torch import utils
    from sagecal_tpu_torch.consensus import admm, manifold
    Fl = JF.shape[0] // group.world
    lo = group.rank * Fl
    JF, Jr, fratio = (a[lo:lo + Fl] for a in (JF, Jr, fratio))
    M, K, N = JF.shape[1:4]
    real = np.arange(lo, lo + Fl) < nf
    J = torch.as_tensor(JF)
    avg = manifold.manifold_average(
        utils.jones_r2c(J).reshape(Fl, M * K, N, 2, 2), niter, nf=nf,
        group=group, real=real)
    parts = admm._runner_parts(None, None, None, None, cmask, N, 1e5, B_pad,
                               admm.ADMMConfig(**cfg_kw), nf_total=nf,
                               group=group)
    B = parts.basis(torch.float64)
    st, Y0F = parts.iter0_post(B, J, torch.as_tensor(fratio))
    out = [avg, Y0F, st["Z"], st["YF"], st["rhoF"]]
    dual = parts.body_post(B, torch.as_tensor(Jr), st, 1)
    out += [st["Z"], st["YF"], st["rhoF"], dual]
    return [o.numpy() for o in out]


def fail_on_rank(group, bad):
    """Raise on rank ``bad`` after the others have entered a barrier that
    it never reaches (the launcher must end them)."""
    if group.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier(group)
