"""Consensus ADMM over frequency subbands on one card (port of
``sagecal_tpu/consensus/admm.py``; the reference's MPI master/slave
per-timeslot loop, ``sagecal_master.cpp:621-890`` and
``sagecal_slave.cpp:488-930``).

The JAX package runs the subbands as one SPMD program over a device
mesh. On one card its mesh has one device and every subband rides the
local leading axis (``cli_mpi.py:371-377``: ndev = 1, fpad = nf), so every
consensus tensor here carries the subbands first (Y, Z's contributions,
rho: [F, M, ...]) and its ``psum`` over the subband axis is a local sum.
:func:`make_admm_runner` keeps the JAX runner's contract and its
``host_loop=True`` plan: one host step per ADMM iteration.

- Iteration 0: a plain SAGE solve per subband (``sage.sagefit_host``, the
  same algorithm as the JAX runner's traced ``sage.sagefit``), the dual
  seed Y = rho J, the manifold average of Y over the subbands
  (``manifold.manifold_average``, master :739-751), the first Z update
  and Y -= rho B Z (``iter0_post``).
- Iterations k > 0: the augmented-Lagrangian SAGE solve per subband
  (``admm=(Y_f, B_f Z, rho_f)``, no refine, warm in-flight groups), Y +=
  rho J, Z = Bii sum_f B_f Y_f (``z_update``, ``poly.find_prod_inverse``),
  Y -= rho B Z and the optional Barzilai-Borwein rho per (subband,
  cluster) (``body_post``, slave :686-786).
- rho is scaled by each subband's unflagged fraction (master :646-650);
  with ``-X`` the spatial prior pulls Z toward its spherical-harmonic
  model every ``cadence`` iterations (master :668-673, :768-814).

The other execution plans of the JAX package share those pieces
(:func:`_runner_parts`):

- :func:`make_admm_runner_blocked` (``--block-f``): the J-updates in
  blocks of ``block_f`` subbands with the consensus steps in between, the
  same values as :func:`make_admm_runner`;
- :func:`make_admm_runner_stale` (``--staleness``): bounded staleness, a
  straggling subband (``faults.draw("admm_subband_slow")``) skipping its
  J-update while the others take its last-sent dual;
- :func:`make_admm_runner_2d` (``--time-shard``) with :func:`pad_time`:
  the solution intervals as a second axis, each time shard a warm-started
  chain of its intervals; on one card the shards run in turn.

The subbands solve one after another; batching them as lanes of one
``sage.sagefit_host_tiles`` solve is performance work (ROADMAP). The
consensus state (Y, Z, B Z, rho and the basis) is kept in the pipeline's
dtype, float32 on the card and float64 on the CPU, under every
``--dtype-policy``: only the solves' rows are stored reduced.
"""

from __future__ import annotations

import time
import types
from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import faults, utils
from sagecal_tpu_torch.consensus import manifold as mf
from sagecal_tpu_torch.consensus import poly as cpoly
from sagecal_tpu_torch.consensus import spatial as sp
from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.solvers import sage


class ADMMConfig(NamedTuple):
    n_admm: int = 10
    npoly: int = 2
    poly_type: int = 2
    # a scalar, or an [M] per-cluster array (a -G rho file)
    rho: float = 5.0
    adaptive_rho: bool = False
    manifold_iters: int = 20     # master :740 Niter
    sage: sage.SageConfig = sage.SageConfig()
    # -X l2,l1,order,fista_iters,cadence (README.md:160-166); None = off
    spatialreg: tuple | None = None
    federated_alpha: float = 0.0  # -u : alpha of the spatial prior


def diverged(res0, res_fin, ratio: float = 5.0) -> np.ndarray:
    """The per-subband divergence rule (slave :680-683): [F] bool, a
    final residual that is non-finite, exactly 0 (all flagged) or above
    ``ratio`` x the initial one."""
    res_fin, res0 = np.asarray(res_fin), np.asarray(res0)
    return (~np.isfinite(res_fin)) | (res_fin == 0.0) \
        | (res_fin > ratio * res0)


def divergence_reset(JF, J0F, res0, res_fin, ratio: float = 5.0):
    """The per-subband warm-start divergence rule (:func:`diverged`): a
    diverged subband restarts the next interval from ``J0F``. JF, J0F
    [F, ...], res0 and res_fin [F] numpy arrays. Returns (J, the [F]
    bool mask of reset subbands)."""
    bad = diverged(res0, res_fin, ratio)
    shape = (-1,) + (1,) * (np.ndim(JF) - 1)
    return np.where(bad.reshape(shape), J0F, JF), bad


def pad_time(arrays, nt: int, ndev_t: int, axis: int = 1):
    """The time axis's padding contract (``pad_time`` of the JAX
    package): pad ``axis`` (the solution-interval axis) of every array,
    numpy or tensor, to ``tpad = ceil(nt / ndev_t) * ndev_t`` by
    replicating the LAST interval. Returns (padded arrays, tpad). The
    port's :func:`make_admm_runner_2d` solves no padded interval."""
    ndev_t = max(int(ndev_t), 1)
    tpad = -(-max(nt, ndev_t) // ndev_t) * ndev_t
    if tpad == nt:
        return list(arrays), tpad
    out = []
    for a in arrays:
        if torch.is_tensor(a):
            last = a.narrow(axis, a.shape[axis] - 1, 1)
            out.append(torch.cat([a] + [last] * (tpad - nt), dim=axis))
            continue
        a = np.asarray(a)
        last = np.take(a, [-1], axis=axis)
        out.append(np.concatenate([a] + [last] * (tpad - nt), axis=axis))
    return out, tpad


def _runner_parts(dsky, sta1, sta2, cidx, cmask, n_stations: int,
                  fdelta: float, B_poly, cfg: ADMMConfig, nf_total=None,
                  spatial_coords=None, dobeam: int = 0, tslot=None,
                  device="cpu"):
    """The pieces every runner shares (``_return_parts`` of the JAX
    ``make_admm_runner``): the per-subband solves, the consensus steps
    after iteration 0 and after each later iteration, and their helpers,
    as attributes of a namespace."""
    cmask_np = np.asarray(cmask.cpu() if torch.is_tensor(cmask) else cmask)
    M, K = cmask_np.shape
    N = n_stations
    Ppoly = int(np.asarray(B_poly).shape[1])
    dev = torch.device(device)
    cmask_t = torch.as_tensor(cmask_np, device=dev)
    nf_total = int(np.asarray(B_poly).shape[0]) if nf_total is None \
        else int(nf_total)

    spat = None
    if cfg.spatialreg is not None:
        sh_l2, sh_mu, sh_n0, fista_iters, cadence = cfg.spatialreg
        Phi, Phikk = sp.phi_padded(cmask_np, *spatial_coords, sh_n0, sh_l2)
        spat = dict(Phi=Phi, Phikk=Phikk, mu=float(sh_mu),
                    iters=int(fista_iters), cadence=int(cadence))

    def coh_for(u, v, w, freq, beam=None):
        bkw = {} if not dobeam else dict(beam=beam, dobeam=dobeam,
                                         tslot=tslot)
        return rp.coherencies(dsky, u, v, w, [float(freq)], fdelta,
                              sta1=sta1, sta2=sta2, **bkw)[:, :, 0]

    def local_solve(x8, u, v, w, wt, J_r8, freq, beam, scfg, admm=None):
        coh = coh_for(u, v, w, freq, beam)
        J, info = sage.sagefit_host(
            x8, coh, sta1, sta2, cidx, cmask_t, utils.jones_r2c(J_r8), N,
            wt, config=scfg, admm=admm)
        return utils.jones_c2r(J), info["res_0"], info["res_1"], \
            info["groups"]

    def per_subband(inputs, JF, cfg_s, admm=None, beamF=None):
        """Every subband of ``inputs`` ((x8F, uF, vF, wF, freqF, wtF),
        [F, ...] each) solved in turn from JF: (J [F, ...], res0 [F],
        res1 [F] float64 CPU tensors, one group record list a
        subband)."""
        x8F, uF, vF, wF, freqF, wtF = inputs
        out = [local_solve(x8F[f], uF[f], vF[f], wF[f], wtF[f], JF[f],
                           freqF[f], None if beamF is None else beamF[f],
                           cfg_s, None if admm is None
                           else tuple(a[f] for a in admm))
               for f in range(x8F.shape[0])]
        return (torch.stack([o[0] for o in out]),
                torch.as_tensor([float(o[1]) for o in out],
                                dtype=torch.float64),
                torch.as_tensor([float(o[2]) for o in out],
                                dtype=torch.float64),
                [o[3] for o in out])

    def rho_vec(dtype):
        """cfg.rho as an [M] tensor (a scalar broadcast)."""
        return torch.as_tensor(np.broadcast_to(np.asarray(cfg.rho,
                                                          np.float64),
                                               (M,)).copy(),
                               dtype=dtype, device=dev)

    def alpha_vec(rho_m):
        if spat is None:
            return None
        # per-cluster alpha scaled by the initial rho, alpha at the
        # largest rho (sagecal_master.cpp:577-579)
        return cfg.federated_alpha * rho_m / torch.clamp(rho_m.max(),
                                                         min=1e-30)

    def z_update(B, YF, rhoF, alpha, Zbar=None, Xd=None):
        """z = sum_f B_f Y_f, YF holding Y + rho J as sent to the master
        (slave :686-700); Z = Bii z (master :755-779); with the spatial
        prior z += alpha Zbar - X and Bii gains alpha I."""
        zsum = torch.einsum("fp,fmknr->mpknr", B, YF)
        if Zbar is not None:
            zsum = zsum + alpha[:, None, None, None, None] * Zbar - Xd
        Bii = cpoly.find_prod_inverse(B, rhoF.T.contiguous(), alpha=alpha)
        return cpoly.z_from_contributions(zsum, Bii)

    def spatial_step(Z, Xd):
        """The FISTA prox and the Zbar/X refresh (master :789-814)."""
        cdt = torch.complex64 if Z.dtype == torch.float32 \
            else torch.complex128
        Phi = torch.as_tensor(spat["Phi"], device=dev).to(cdt)
        Phikk = torch.as_tensor(spat["Phikk"], device=dev).to(cdt)
        Zspat = sp.fista_spatialreg(sp.z_r8_to_blocks(Z).to(cdt), Phikk,
                                    Phi, spat["mu"], spat["iters"])
        Zbar = sp.blocks_to_z_r8(sp.spatial_predict(Zspat, Phi), M, Ppoly,
                                 K, N).to(Z.dtype)
        return Zbar, Xd + cfg.federated_alpha * (Z - Zbar)

    def bz_of(B, Z):
        return torch.einsum("fp,mpknr->fmknr", B, Z)

    def iter0_post(B, JF, fratioF):
        """Dual seed, manifold average and the first Z/dual update."""
        dtype = JF.dtype
        F = JF.shape[0]
        rho_m = rho_vec(dtype)
        rhoF = rho_m[None, :] * fratioF[:, None] \
            * torch.ones((F, M), dtype=dtype, device=dev)
        alpha = alpha_vec(rho_m)
        r5 = rhoF[..., None, None, None]
        YF = r5 * JF
        Yc = utils.jones_r2c(YF).reshape(F, M * K, N, 2, 2)
        YF = utils.jones_c2r(mf.manifold_average(
            Yc, cfg.manifold_iters, nf=nf_total)).reshape(YF.shape)
        Y0F = YF
        Zbar = torch.zeros((M, Ppoly, K, N, 8), dtype=dtype, device=dev)
        Xd = torch.zeros_like(Zbar)
        Z = z_update(B, YF, rhoF, alpha)
        if spat is not None:
            Zbar, Xd = spatial_step(Z, Xd)
        YF = YF - r5 * bz_of(B, Z)
        return dict(JF=JF, YF=YF, Z=Z, rhoF=rhoF, Yhat=YF, Jprev=JF,
                    Zbar=Zbar, Xd=Xd, rho_upper=rhoF, alpha=alpha), Y0F

    def body_post(B, Jr, st, it):
        """Everything after iteration k's solves (slave :686-786)."""
        r5 = st["rhoF"][..., None, None, None]
        YF = st["YF"] + r5 * Jr
        Zold = st["Z"]
        Zbar, Xd = st["Zbar"], st["Xd"]
        if spat is None:
            Z = z_update(B, YF, st["rhoF"], st["alpha"])
        else:
            Z = z_update(B, YF, st["rhoF"], st["alpha"], Zbar, Xd)
            if it % spat["cadence"] == 0:
                Zbar, Xd = spatial_step(Z, Xd)
        # Yhat for the BB rho takes the OLD BZ (slave :724-732)
        Yhat = YF - r5 * bz_of(B, Zold)
        YF = YF - r5 * bz_of(B, Z)
        rhoF = st["rhoF"]
        if cfg.adaptive_rho:
            rhoF = cpoly.update_rho_bb(rhoF, st["rho_upper"],
                                       Yhat - st["Yhat"], Jr - st["Jprev"],
                                       dims=(2, 3, 4))
        dual = torch.linalg.vector_norm(Z - Zold) / np.sqrt(Z.numel())
        st.update(JF=Jr, YF=YF, Z=Z, rhoF=rhoF, Yhat=Yhat, Jprev=Jr,
                  Zbar=Zbar, Xd=Xd)
        return dual

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def basis(dtype):
        return torch.as_tensor(np.asarray(B_poly), dtype=dtype, device=dev)

    # ADMM iterations k > 0 warm-start from the previous iterate: the
    # cluster groups skip the cold first-sweep width, and there is no
    # refine (iteration 0 keeps the configuration as given)
    cfg_admm = cfg.sage._replace(max_lbfgs=0, inflight_warm=True)
    return types.SimpleNamespace(
        M=M, K=K, N=N, dev=dev, cfg=cfg, cfg_admm=cfg_admm,
        per_subband=per_subband, iter0_post=iter0_post,
        body_post=body_post, z_update=z_update, bz_of=bz_of,
        rho_vec=rho_vec, alpha_vec=alpha_vec, sync=sync, basis=basis)


def _make_runner(parts, block_f, timer, groups):
    """The runner of :func:`make_admm_runner` (``block_f`` None: every
    subband in one J-update step, ``timer`` labels "iter0" and "body[k]")
    and of :func:`make_admm_runner_blocked` (blocks of ``block_f``
    subbands, labels "solve[i]" a block, "cons0" and "cons[k]" a
    consensus step). Both compute the same values."""
    cfg = parts.cfg

    def tick(label, t0):
        parts.sync()
        if timer is not None:
            timer.append((label, time.perf_counter() - t0))

    def solve_all(inputs, JF, cfg_s, admm=None, beamF=None):
        F = inputs[0].shape[0]
        step = F if block_f is None else block_f
        Js, r0s, r1s, grps = [], [], [], []
        for i, b0 in enumerate(range(0, F, step)):
            sl = slice(b0, min(b0 + step, F))
            t0 = time.perf_counter()
            J, r0, r1, g = parts.per_subband(
                tuple(a[sl] for a in inputs), JF[sl], cfg_s,
                admm=None if admm is None else tuple(a[sl] for a in admm),
                beamF=None if beamF is None else beamF[sl])
            if block_f is not None:
                tick(f"solve[{i}]", t0)
            Js.append(J)
            r0s.append(r0)
            r1s.append(r1)
            grps += g
        if groups is not None:
            groups.append(grps)
        if len(Js) == 1:
            return Js[0], r0s[0], r1s[0]
        return torch.cat(Js), torch.cat(r0s), torch.cat(r1s)

    def iterate(inputs, B, st, beamF=None):
        """Iterations 1 .. A - 1 from the state ``st`` (in place);
        returns (r1s, duals)."""
        r1s, duals = [], []
        for it in range(1, max(cfg.n_admm, 1)):
            t0 = time.perf_counter()
            Jr, _, r1 = solve_all(
                inputs, st["JF"], parts.cfg_admm,
                admm=(st["YF"], parts.bz_of(B, st["Z"]), st["rhoF"]),
                beamF=beamF)
            tc = time.perf_counter()
            duals.append(parts.body_post(B, Jr.to(B.dtype), st, it))
            r1s.append(r1)
            if block_f is None:
                tick(f"body[{it}]", t0)
            else:
                tick(f"cons[{it}]", tc)
        F = inputs[0].shape[0]
        return (torch.stack(r1s) if r1s
                else torch.zeros((0, F), dtype=torch.float64),
                torch.stack(duals) if duals
                else torch.zeros((0,), dtype=B.dtype, device=parts.dev))

    def run(x8F, uF, vF, wF, freqF, wtF, fratioF, J0F, beamF=None):
        dtype = J0F.dtype
        B = parts.basis(dtype)
        inputs = (x8F, uF, vF, wF, np.asarray(freqF), wtF)
        t0 = time.perf_counter()
        JF, res0, res1 = solve_all(inputs, J0F, cfg.sage, beamF=beamF)
        tc = time.perf_counter()
        st, Y0F = parts.iter0_post(B, JF.to(dtype), fratioF.to(dtype))
        if block_f is None:
            tick("iter0", t0)
        else:
            tick("cons0", tc)
        r1s, duals = iterate(inputs, B, st, beamF)
        return (st["JF"], st["Z"], st["rhoF"], res0, res1, r1s, duals, Y0F)

    def from_state(x8F, uF, vF, wF, freqF, wtF, state, beamF=None):
        """Iterations 1 .. A - 1 from an iteration-0 ``state`` (the dict
        of ``convert.admm_state_from_numpy``: the JAX runner's carry):
        (JF, Z, rhoF, r1s, duals)."""
        st = dict(state)
        B = parts.basis(st["JF"].dtype)
        st["alpha"] = parts.alpha_vec(parts.rho_vec(B.dtype))
        r1s, duals = iterate((x8F, uF, vF, wF, np.asarray(freqF), wtF), B,
                             st, beamF)
        return st["JF"], st["Z"], st["rhoF"], r1s, duals

    run.from_state = from_state
    return run


def make_admm_runner(dsky, sta1, sta2, cidx, cmask, n_stations: int,
                     fdelta: float, B_poly, cfg: ADMMConfig, nf_total=None,
                     spatial_coords=None, dobeam: int = 0, tslot=None,
                     device="cpu", timer: list | None = None,
                     groups: list | None = None):
    """Build the per-interval consensus-ADMM runner (``make_admm_runner``
    of the JAX package, its ``host_loop=True`` plan, on one card).

    ``dsky`` the device sky (a ``rime.predict.SplitSky``, or a SkyArrays
    under ``-B``); sta1/sta2 [B] and cidx [M, B] tensors on ``device``,
    cmask [M, Kmax] bool; B_poly [F, P] (numpy); ``nf_total`` the real
    subband count (all F on one card); ``spatial_coords`` the ([Mt] r,
    [Mt] theta) centroids when ``cfg.spatialreg`` is set; ``dobeam`` and
    the rows' timeslots ``tslot`` the predict's beam arguments. ``timer``
    (a list) receives ("iter0" | "body[k]", seconds) per iteration, and
    ``groups`` (a list) per iteration one list a subband of its in-flight
    group records (``sage.sagefit_host``'s: sweep, members, omega,
    margins).

    Returns ``run(x8F, uF, vF, wF, freqF, wtF, fratioF, J0F, beamF=None)``
    on [F, ...] tensors (x8F and wtF may be in a reduced storage dtype;
    J0F [F, M, K, N, 8] reals; ``beamF`` one beam table set a subband),
    giving back (JF [F, M, K, N, 8], Z [M, P, K, N, 8], rhoF [F, M], res0
    [F], res1 [F], r1s [A - 1, F], duals [A - 1], Y0F [F, M, K, N, 8]):
    Y0F the manifold-projected rho J of iteration 0 (the MDL input,
    master :815-822), res1 iteration 0's."""
    parts = _runner_parts(dsky, sta1, sta2, cidx, cmask, n_stations, fdelta,
                          B_poly, cfg, nf_total, spatial_coords, dobeam,
                          tslot, device)
    return _make_runner(parts, None, timer, groups)


def make_admm_runner_blocked(dsky, sta1, sta2, cidx, cmask, n_stations: int,
                             fdelta: float, B_poly, cfg: ADMMConfig,
                             block_f: int, nf_total=None, dobeam: int = 0,
                             tslot=None, device="cpu",
                             timer: list | None = None,
                             groups: list | None = None):
    """Consensus ADMM with the J-update in blocks of ``block_f``
    subbands (``make_admm_runner_blocked`` of the JAX package,
    ``--block-f``; a ragged last block takes the rest), the consensus
    steps in between. Inside a block the subbands solve in turn, so the
    outputs are those of :func:`make_admm_runner`, bit for bit; the block
    is the unit of ``timer``: ("solve[i]", s) a block, ("cons0", s) and
    ("cons[k]", s) a consensus step, in the order they run (iteration 0's
    blocks, cons0, then each iteration's blocks and its cons[k]).
    ``-X`` is refused, as in the JAX package. Arguments and ``run`` as
    :func:`make_admm_runner`'s."""
    if cfg.spatialreg is not None:
        raise ValueError("blocked runner does not support -X spatial "
                         "regularization; use make_admm_runner")
    if int(block_f) < 1:
        raise ValueError(f"block_f {block_f}: must be >= 1")
    parts = _runner_parts(dsky, sta1, sta2, cidx, cmask, n_stations, fdelta,
                          B_poly, cfg, nf_total, None, dobeam, tslot,
                          device)
    return _make_runner(parts, int(block_f), timer, groups)


def make_admm_runner_stale(dsky, sta1, sta2, cidx, cmask, n_stations: int,
                           fdelta: float, B_poly, cfg: ADMMConfig,
                           nf_total=None, staleness: int = 0,
                           device="cpu", timer: list | None = None,
                           groups: list | None = None):
    """Bounded-staleness consensus ADMM (``make_admm_runner_stale`` of
    the JAX package, ``--staleness S``): a straggling subband may SKIP
    its J-update for a round while the others iterate against its
    last-sent dual contribution, up to ``staleness`` rounds stale.

    Each round k > 0, subband f asks ``faults.draw("admm_subband_slow",
    key=f)`` only while skipping keeps it within the bound (``it -
    last_update[f] <= S``; S = 0 never asks): a "transient" draw skips the
    round, a "fatal" one marks the subband DEAD for good (zero rho, zero
    sent dual, its last residual carried forward); past the bound the
    subband updates. Updated subbands send Ysent = Y + rho J (new) and
    take the dual step against the fresh Z, the synchronous math;
    sleeping ones' last-sent Ysent enters the z-sum unchanged; the Bii
    solve is exact over the mixed table (:func:`stale_post`). Iteration 0
    is synchronous for every subband.

    With ``staleness=0``, or with no fault plan, every subband updates
    every round and the outputs are bit-identical to
    ``make_admm_runner_blocked(block_f=1)``. Refuses ``-X``, adaptive rho
    (``-C 1``: Barzilai-Borwein steps over stale increments are
    undefined) and ``staleness < 0``; ``run`` refuses beam tables (``-B``).
    ``timer`` receives ("solve0[f]" | "solve[f]" | "cons0" | "cons[k]",
    s). Besides the outputs of :func:`make_admm_runner`, ``run.schedule``
    holds per interval the list of per-round update masks ([F] float
    arrays) and ``run.dead`` the (interval, round, subband) of every
    death."""
    if cfg.spatialreg is not None:
        raise ValueError("bounded-staleness runner does not support -X "
                         "spatial regularization")
    if cfg.adaptive_rho:
        raise ValueError("bounded-staleness consensus requires "
                         "adaptive_rho=False (BB rho over stale "
                         "increments is undefined)")
    S = int(staleness)
    if S < 0:
        raise ValueError(f"staleness {S}: must be >= 0")
    parts = _runner_parts(dsky, sta1, sta2, cidx, cmask, n_stations, fdelta,
                          B_poly, cfg, nf_total, None, 0, None, device)
    nf_total = int(np.asarray(B_poly).shape[0]) if nf_total is None \
        else int(nf_total)
    M, K, N = parts.M, parts.K, parts.N

    def tick(label, t0):
        parts.sync()
        if timer is not None:
            timer.append((label, time.perf_counter() - t0))

    def stale_post(B, Jr, r1_new, upd, alive, st, Ysent, r1_prev):
        """The consensus half of one stale round, in place on ``st``
        (``stale_post`` of the JAX package). ``upd``/``alive``: [F] {0,
        1} numpy masks. With both 1 everywhere it computes the values of
        the synchronous ``body_post`` bit for bit (each where() selects
        the same expression). Returns (Ysent, r1, dual)."""
        F = Jr.shape[0]
        upd_t = torch.as_tensor(upd > 0, device=parts.dev)
        alive_t = torch.as_tensor(alive > 0, device=parts.dev)
        upd5 = upd_t.view(F, 1, 1, 1, 1)
        alive5 = alive_t.view(F, 1, 1, 1, 1)
        J5 = Jr.reshape(F, M, K, N, 8)
        rho_eff = torch.where(alive_t[:, None], st["rhoF"],
                              torch.zeros_like(st["rhoF"]))
        r5 = rho_eff[..., None, None, None]
        Ysent = torch.where(upd5, st["YF"] + r5 * J5, Ysent)
        Ysent = torch.where(alive5, Ysent, torch.zeros_like(Ysent))
        Zold = st["Z"]
        Z = parts.z_update(B, Ysent, rho_eff, None)
        YF = torch.where(upd5, Ysent - r5 * parts.bz_of(B, Z), st["YF"])
        JF = torch.where(upd5, J5.reshape(st["JF"].shape), st["JF"])
        r1 = torch.where(torch.as_tensor(upd > 0), r1_new, r1_prev)
        dual = torch.linalg.vector_norm(Z - Zold) / np.sqrt(Z.numel())
        st.update(JF=JF, YF=YF, Z=Z, rhoF=rho_eff)
        return Ysent, r1, dual

    n_runs = [0]
    schedule: list = []
    dead_log: list = []

    def run(x8F, uF, vF, wF, freqF, wtF, fratioF, J0F, beamF=None):
        if beamF is not None:
            raise ValueError("bounded-staleness runner does not support -B "
                             "beam tables")
        interval = n_runs[0]
        n_runs[0] += 1
        F = x8F.shape[0]
        dtype = J0F.dtype
        B = parts.basis(dtype)
        inputs = (x8F, uF, vF, wF, np.asarray(freqF), wtF)

        def solve(f, JF, cfg_s, admm=None):
            sl = slice(f, f + 1)
            return parts.per_subband(
                tuple(a[sl] for a in inputs), JF[sl], cfg_s,
                admm=None if admm is None else tuple(a[sl] for a in admm))

        # iteration 0: synchronous for every subband (the dual seed and
        # the manifold average need the full subband set)
        outs, grp = [], []
        for f in range(F):
            t0 = time.perf_counter()
            outs.append(solve(f, J0F, cfg.sage))
            tick(f"solve0[{f}]", t0)
            grp += outs[-1][3]
        if groups is not None:
            groups.append(grp)
        JF = torch.cat([o[0] for o in outs])
        res0 = torch.cat([o[1] for o in outs])
        res1 = torch.cat([o[2] for o in outs])
        t0 = time.perf_counter()
        st, Y0F = parts.iter0_post(B, JF.to(dtype), fratioF.to(dtype))
        tick("cons0", t0)
        # the last-sent table: iteration 0 sent the manifold-projected
        # rho J, which is Y0F
        Ysent = Y0F
        r1_cur = res1

        alive_np = np.ones(F, np.float64)
        alive_np[nf_total:] = 0.0
        upd_base = alive_np.copy()
        last_update = np.zeros(F, np.int64)
        dead: set = set()
        rounds, r1h, dualh = [], [], []
        for it in range(1, max(cfg.n_admm, 1)):
            upd_np = upd_base.copy()
            for f in range(min(nf_total, F)):
                if f in dead:
                    upd_np[f] = 0.0
                    continue
                # may f sleep this round? asked only while the bound
                # permits the resulting staleness
                if S > 0 and (it - last_update[f]) <= S:
                    kind = faults.draw("admm_subband_slow", key=f)
                    if kind == "fatal":
                        dead.add(f)
                        alive_np[f] = 0.0
                        upd_base[f] = 0.0
                        upd_np[f] = 0.0
                        dead_log.append((interval, it, f))
                        continue
                    if kind is not None:
                        upd_np[f] = 0.0
                        continue
                last_update[f] = it
            rounds.append(upd_np.copy())

            BZ = parts.bz_of(B, st["Z"])
            Jr = st["JF"].clone()
            r1_new = r1_cur.clone()
            grp = []
            for f in range(F):
                if upd_np[f] == 0.0:
                    continue
                t0 = time.perf_counter()
                Jb, _, r1b, g = solve(f, st["JF"], parts.cfg_admm,
                                      admm=(st["YF"], BZ, st["rhoF"]))
                tick(f"solve[{f}]", t0)
                Jr[f] = Jb[0].to(Jr.dtype)
                r1_new[f] = r1b[0]
                grp += g
            if groups is not None:
                groups.append(grp)
            t0 = time.perf_counter()
            Ysent, r1_cur, dual = stale_post(B, Jr, r1_new, upd_np,
                                             alive_np, st, Ysent, r1_cur)
            tick(f"cons[{it}]", t0)
            r1h.append(r1_cur)
            dualh.append(dual)
        schedule.append(rounds)
        return (st["JF"], st["Z"], st["rhoF"], res0, res1,
                torch.stack(r1h) if r1h
                else torch.zeros((0, F), dtype=torch.float64),
                torch.stack(dualh) if dualh
                else torch.zeros((0,), dtype=dtype, device=parts.dev), Y0F)

    run.schedule = schedule
    run.dead = dead_log
    return run


def make_admm_runner_2d(dsky, sta1, sta2, cidx, cmask, n_stations: int,
                        fdelta: float, B_poly, cfg: ADMMConfig,
                        time_shards: int, nt_total: int, nf_total=None,
                        device="cpu", timer: list | None = None,
                        groups: list | None = None):
    """Consensus ADMM over subbands and solution intervals
    (``make_admm_runner_2d`` of the JAX package, ``--time-shard T``). The
    JAX package shards the intervals over the time axis of a ('freq',
    'time') mesh; on one card the ``time_shards`` shards run in turn.
    Time shard d walks its contiguous block of ``Tl = Tpad / T``
    intervals in order: interval t + 1 warm-starts from t's Jones through
    the divergence reset (:func:`divergence_reset`), and the first
    interval of each block cold-starts from ``J0F``, the JAX runner's
    deliberate seam. Each interval is the full ADMM chain of
    :func:`make_admm_runner`. Padded intervals (index >= ``nt_total``,
    :func:`pad_time`) feed no collective and are not solved: their rows of
    the outputs are zero. ``-X`` is refused.

    ``run(x8FT, uFT, vFT, wFT, freqF, wtFT, fratioFT, J0F)`` takes [F,
    Tpad, ...] tensors on ``device`` (fratioFT [F, Tpad]), the host
    channel list ``freqF`` [F] and J0F [F, M, K, N, 8], and returns
    (JT [Tpad, F, M, K, N, 8], ZT [Tpad, M, P, K, N, 8], rhoT [Tpad, F,
    M], res0T [Tpad, F], res1T [Tpad, F], r1sT [Tpad, A - 1, F], dualsT
    [Tpad, A - 1], Y0T [Tpad, F, M, K, N, 8]). ``timer`` receives
    ("interval[t]", s) per solved interval, ``groups`` the in-flight group
    records per interval (each as :func:`make_admm_runner`'s), and
    ``run.resets`` per solved interval the subbands its warm start
    reset."""
    if cfg.spatialreg is not None:
        raise ValueError("2-D runner does not support -X spatial "
                         "regularization; use make_admm_runner")
    T = int(time_shards)
    if T < 1:
        raise ValueError(f"time_shards {time_shards}: must be >= 1")
    nt_total = int(nt_total)
    grp: list = []
    one = make_admm_runner(dsky, sta1, sta2, cidx, cmask, n_stations,
                           fdelta, B_poly, cfg, nf_total=nf_total,
                           device=device, groups=grp)
    resets: list = []

    def run(x8FT, uFT, vFT, wFT, freqF, wtFT, fratioFT, J0F):
        Tpad = x8FT.shape[1]
        if Tpad % T:
            raise ValueError(f"staged time axis {Tpad} must divide over "
                             f"{T} time shards (pad_time)")
        if Tpad < -(-nt_total // T) * T:
            raise ValueError(f"staged time axis {Tpad} cannot hold the "
                             f"declared {nt_total} intervals over {T} "
                             f"time shards (pad_time)")
        Tl = Tpad // T
        outs: list = [None] * Tpad
        resets.clear()
        for d in range(T):
            Jc = J0F
            for w in range(Tl):
                t = d * Tl + w
                if t >= nt_total:
                    continue
                t0 = time.perf_counter()
                grp.clear()
                out = one(x8FT[:, t], uFT[:, t], vFT[:, t], wFT[:, t],
                          freqF, wtFT[:, t], fratioFT[:, t], Jc)
                if groups is not None:
                    groups.append(list(grp))
                res0 = out[3].numpy()
                res_fin = out[5][-1].numpy() if cfg.n_admm > 1 \
                    else out[4].numpy()
                bad = diverged(res0, res_fin)
                resets.append(np.flatnonzero(bad).tolist())
                badt = torch.as_tensor(bad, device=J0F.device).view(
                    -1, 1, 1, 1, 1)
                Jc = torch.where(badt, J0F, out[0].to(J0F.dtype))
                outs[t] = out
                if timer is not None:
                    timer.append((f"interval[{t}]",
                                  time.perf_counter() - t0))
        first = next(o for o in outs if o is not None)
        return tuple(torch.stack([o[i] if o is not None
                                  else torch.zeros_like(first[i])
                                  for o in outs]) for i in range(8))

    run.resets = resets
    return run

