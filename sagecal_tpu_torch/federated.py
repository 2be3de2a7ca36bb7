"""Federated stochastic calibration (port of ``sagecal_tpu/federated.py``;
the reference's stochastic ``sagecal-mpi -N > 0``,
``src/MPI/sagecal_stochastic_master.cpp`` and
``sagecal_stochastic_slave.cpp``).

Every "slave" (one subband dataset) runs minibatch consensus calibration
over its own frequency mini-bands with a LOCAL polynomial consensus Z,
and the slaves are coupled by FEDERATED AVERAGING of their Z's:

- each slave's mini-bands are lanes of one band solve
  (``stochastic.make_band_solver_batched`` with the consensus term,
  ``bfgsfit_minibatch_consensus``), which is what the JAX mesh program's
  ``vmap`` over bands computes; bands whose residual is non-positive or
  above RES_RATIO x the bands' mean stay out of the Z update;
- local Z update (slave :780-825): z = sum_b good_b B_b Y_b (+ alpha Zavg
  - X after the first outer iteration), Z = Bii z, Bii the inverse of
  (sum_b rho_b B_b B_b^T + alpha I) (``poly.find_prod_inverse(...,
  alpha=)``, ``find_prod_inverse_full_fed``);
- after every outer iteration, Zavg = the mean over the slaves
  (stochastic master :329-351), the federated dual X += alpha (Z - Zavg)
  (slave :867-875) and the FEDA dual residual sqrt(sum_s ||Z_s -
  Zavg||^2 / (|Zavg| S)), printed under ``-V``;
- ``-U 1`` (``RunConfig.use_global_solution``) ends the tile with every
  band at its slave's polynomial; slave 0 writes the solutions, and every
  slave its residuals (``StochasticRunner.end_of_tile``).

The JAX package runs the slaves over a "slave" mesh axis
(:func:`run_federated` there); on one card they run in turn, each with
its own Y, Z and X, which is what the JAX package's host-sequential
oracle ``run_federated_sequential`` computes band by band, and what the
tests hold :func:`run_federated` (the CLI's route, bands as lanes)
against. The band cost weighs ||p - BZ||^2 by the sum of the clusters'
rho, as the JAX package's does (ROADMAP C12).

Runs on the card in float32 and on the CPU in float64 (``device``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sagecal_tpu_torch import device as devmod
from sagecal_tpu_torch import pipeline, skymodel
from sagecal_tpu_torch import stochastic as st
from sagecal_tpu_torch.config import RunConfig
from sagecal_tpu_torch.consensus import poly as cpoly
from sagecal_tpu_torch.io import dataset as ds
from sagecal_tpu_torch.solvers import lbfgs as lbfgs_mod

RES_RATIO = st.RES_RATIO


def _fed_setup(cfg: RunConfig, paths: list, device, log):
    """The slaves, the sky, the bases and the per-slave state of a
    federated run (``_fed_setup`` of the JAX package): (mss,
    sky, runners, alpha [M], Bs [W, P] a slave, Biis [M, P, P] a slave
    (float64 on the host), rhoks [W, M] a slave, states). Runner 0 logs
    with ``log``, the others silently."""
    mss = [ds.open_part(p, tilesz=cfg.tile_size,
                        data_column=cfg.input_column,
                        out_column=cfg.output_column) for p in paths]
    ref_f = float(np.mean([m.meta["freq0"] for m in mss]))
    meta0 = mss[0].meta
    sky = skymodel.read_sky_cluster(cfg.sky_model, cfg.cluster_file,
                                    meta0["ra0"], meta0["dec0"], ref_f,
                                    cfg.format_3)
    quiet = lambda *a: None  # noqa: E731
    runners = [st.StochasticRunner(cfg, m, sky, device=device, log=quiet)
               for m in mss]
    runners[0].log = log
    M = runners[0].M
    alpha = np.full(M, cfg.federated_alpha)
    arho = np.full(M, cfg.admm_rho)
    if cfg.rho_file:
        arho = skymodel.read_cluster_rho(cfg.rho_file, sky.cluster_ids,
                                         cfg.admm_rho)
    Bs, Biis, rhoks = [], [], []
    for rn in runners:
        fcen = np.array([rn.freqs[c0:c0 + nc].mean()
                         for c0, nc in zip(rn.chanstart, rn.nchan)])
        B = cpoly.setup_polynomials(fcen, ref_f, cfg.n_poly, cfg.poly_type)
        rhok = np.tile(arho[None, :], (rn.nsolbw, 1))       # [W, M]
        # the federated inverse: + alpha I (find_prod_inverse_full_fed)
        Bii = cpoly.find_prod_inverse(
            torch.as_tensor(B), torch.as_tensor(rhok.T).contiguous(),
            alpha=torch.as_tensor(alpha)).numpy()
        Bs.append(B)
        Biis.append(Bii)
        rhoks.append(rhok)
    states = []
    for rn in runners:
        pinit, pfreq = rn.initial_p()
        like = torch.zeros((), dtype=rn.rdt, device=rn.device)
        mems = [lbfgs_mod.lbfgs_memory_init(rn.nparam, cfg.lbfgs_m, like)
                for _ in range(rn.nsolbw)]
        states.append({"pfreq": pfreq, "mems": mems, "pinit": pinit,
                       "res_prev": None})
    return mss, sky, runners, alpha, Bs, Biis, rhoks, states


def _window(cfg: RunConfig, mss) -> range:
    """The tiles of the run: ``-K`` skipped (CTRL_SKIP, master
    :623-634), at most ``-T``, within the slaves' common count."""
    n_tiles = min(m.n_tiles for m in mss)
    start = cfg.skip_timeslots
    stop = n_tiles if not cfg.max_timeslots else min(
        n_tiles, start + cfg.max_timeslots)
    return range(start, stop)


def _z_step(zsum, Bii):
    """Z = Bii z on the host (float64)."""
    return cpoly.z_from_contributions(torch.as_tensor(zsum),
                                      torch.as_tensor(Bii)).numpy()


def _local_update(Y, B, Bii, rhok, p_np, resband, r1s, zprior):
    """The local ADMM update of one minibatch (slave :780-825), in place
    on Y [W, M, K, N, 8]: bands above RES_RATIO x the mean r1 (or with a
    non-positive residual, ``resband`` inf) stay out; the others add rho
    p_b to Y_b; Z = Bii (sum_b good_b B_b Y_b + ``zprior``); the others
    take Y_b -= rho B_b Z. Returns (Z, the flagged bands)."""
    good = ~(resband > RES_RATIO * float(np.mean(r1s)))
    for b in np.flatnonzero(good):
        Y[b] += rhok[b][:, None, None, None] * p_np[b]
    zsum = np.einsum("b,bp,bmkns->mpkns", good.astype(float), B, Y)
    if zprior is not None:
        zsum = zsum + zprior
    Z = _z_step(zsum, Bii)
    for b in np.flatnonzero(good):
        Y[b] -= rhok[b][:, None, None, None] * np.einsum(
            "p,mpkns->mkns", B[b], Z)
    return Z, np.flatnonzero(~good).tolist()


def _federate(Zs, Xs, alpha):
    """Zavg = the mean over the slaves, X_s += alpha (Z_s - Zavg), and the
    FEDA dual residual (stochastic master :329-351, slave :867-875)."""
    Zavg = np.mean(Zs, axis=0)
    feda = 0.0
    for s in range(len(Zs)):
        d = Zs[s] - Zavg
        Xs[s] += alpha[:, None, None, None, None] * d
        feda += float(np.linalg.norm(d)) ** 2
    return Zavg, float(np.sqrt(feda / max(Zavg.size * len(Zs), 1)))


def _end_tile(cfg, runners, states, Bs, Zs, tiles, inputs, resband, ti,
              res_0, res_1, t0, writer, history, extra):
    """Every slave's end of tile: ``-U`` (each band at its slave's
    polynomial, in the bands' dtype), then ``StochasticRunner.
    end_of_tile`` (residuals, resets; slave 0 writes the solutions and
    the record)."""
    for s, rn in enumerate(runners):
        pfreq = states[s]["pfreq"]
        if cfg.use_global_solution:
            for b in range(rn.nsolbw):
                pfreq[b] = np.einsum("p,mpkns->mkns", Bs[s][b],
                                     Zs[s]).astype(pfreq[b].dtype)
        rn.end_of_tile(tiles[s], ti, inputs[s], states[s], resband[s],
                       res_0, res_1, t0, writer if s == 0 else None,
                       history if s == 0 else [],
                       extra=extra if s == 0 else None)


def run_federated(cfg: RunConfig, paths: list, device=None, log=print):
    """Federated stochastic calibration of the subband datasets ``paths``
    on ``device`` (None: the card, raising without one; "cpu": float64),
    the slaves in turn and each slave's bands as lanes of one band solve
    a minibatch. Returns one record a tile: res_0 and res_1 (the means
    over the last outer iteration's solves of every slave), minutes,
    ``feda`` (the dual residual per outer iteration), ``slave_res`` (per
    slave the mean res_0 of its first solve and the mean res_1 of its
    last), ``lbfgs_iters`` (per outer iteration, slave and solve, per
    band), ``flagged_bands`` (the same nesting), ``armijo`` (per solve
    in the order they ran, per band, per iteration: the line search's
    test margins), the kernel launches of the tile, ``outer_s`` (each
    outer iteration's seconds) and ``tail_s`` (the end of the tile: every
    slave's residuals and the solutions)."""
    device = devmod.resolve(device)
    mss, sky, runners, alpha, Bs, Biis, rhoks, states = _fed_setup(
        cfg, paths, device, log)
    nslaves = len(runners)
    rn0 = runners[0]
    log(f"Federated stochastic calibration: {nslaves} slave datasets, "
        f"{cfg.n_epochs} epochs x {rn0.minibatches} minibatches, "
        f"{rn0.nsolbw} mini-bands each, {cfg.n_admm} outer iterations")
    solvers = [st.make_band_solver_batched(
        rn.dsky, rn.n, rn.cidx, rn.cmask, rn.fdelta_chan,
        nu=cfg.robust_nulow, max_lbfgs=cfg.max_lbfgs, consensus=True,
        dobeam=rn.dobeam, loss=cfg.stochastic_loss) for rn in runners]
    P = cfg.n_poly
    M, kmax, n = rn0.M, rn0.kmax, rn0.n
    pshape = (M, kmax, n, 8)
    writer = rn0.solution_writer()
    history: list = []
    try:
        for ti in _window(cfg, mss):
            t0 = time.time()
            c0 = pipeline._counters()
            tiles = [m.read_tile(ti) for m in mss]
            inputs = [rn.build_tile_inputs(tile)
                      for rn, tile in zip(runners, tiles)]
            Zavg = np.zeros((M, P, kmax, n, 8))
            Zs = [np.zeros_like(Zavg) for _ in range(nslaves)]
            Xs = [np.zeros_like(Zavg) for _ in range(nslaves)]
            Ys = [np.zeros((rn.nsolbw,) + pshape) for rn in runners]
            resband = [np.zeros(rn.nsolbw) for rn in runners]
            lanes = [rn.stack_state(s["pfreq"], s["mems"])
                     for rn, s in zip(runners, states)]
            rho_d = [rn._t(rhok) for rn, rhok in zip(runners, rhoks)]
            first = [None] * nslaves
            last = [None] * nslaves
            res_0 = res_1 = 0.0
            fedas, iters, flagged, armijo, outer_s = [], [], [], [], []
            for nadmm in range(cfg.n_admm):
                t_o = time.perf_counter()
                r0all, r1all, it_o, fl_o = [], [], [], []
                for s, rn in enumerate(runners):
                    B, Y, Z = Bs[s], Ys[s], Zs[s]
                    pstack, memstack = lanes[s]
                    it_s, fl_s = [], []
                    zprior = None if nadmm == 0 else \
                        alpha[:, None, None, None, None] * Zavg - Xs[s]
                    for _ in range(cfg.n_epochs):
                        for nmb in range(rn.minibatches):
                            BZ = np.einsum("bp,mpkns->bmkns", B, Z)
                            bkw = {} if not rn.dobeam else dict(
                                beam=inputs[s]["beam"],
                                tslot=inputs[s]["tslot"][nmb])
                            margins = [[] for _ in range(rn.nsolbw)]
                            out = solvers[s](*inputs[s][nmb], pstack,
                                             memstack, armijo=margins,
                                             Y=rn._t(Y), BZ=rn._t(BZ),
                                             rho=rho_d[s], **bkw)
                            armijo.append(margins)
                            pstack, memstack = out.p, out.mem
                            p_np = pstack.to("cpu", torch.float64).numpy()
                            r0s = out.res_0.to("cpu", torch.float64).numpy()
                            r1s = out.res_1.to("cpu", torch.float64).numpy()
                            resband[s][:] = np.where((r0s > 0) & (r1s > 0),
                                                     r1s, np.inf)
                            Z, fl = _local_update(Y, B, Biis[s], rhoks[s],
                                                  p_np, resband[s], r1s,
                                                  zprior)
                            if first[s] is None:
                                first[s] = float(np.mean(r0s))
                            last[s] = float(np.mean(r1s))
                            r0all.extend(r0s.tolist())
                            r1all.extend(r1s.tolist())
                            it_s.append([int(k) for k in out.iters])
                            fl_s.append(fl)
                    lanes[s] = (pstack, memstack)
                    Zs[s] = Z
                    it_o.append(it_s)
                    fl_o.append(fl_s)
                Zavg, feda = _federate(Zs, Xs, alpha)
                fedas.append(feda)
                if cfg.verbose:
                    log(f"FEDA: {nadmm} dual residual={feda:.6f}")
                res_0 = float(np.mean(r0all))
                res_1 = float(np.mean(r1all))
                iters.append(it_o)
                flagged.append(fl_o)
                outer_s.append(time.perf_counter() - t_o)
            for s, rn in enumerate(runners):
                rn.unstack_state(*lanes[s], states[s]["pfreq"],
                                 states[s]["mems"])
            t_tail = time.perf_counter()
            _end_tile(cfg, runners, states, Bs, Zs, tiles, inputs, resband,
                      ti, res_0, res_1, t0, writer, history,
                      extra={"feda": fedas,
                             "slave_res": [list(r) for r in zip(first, last)],
                             "lbfgs_iters": iters,
                             "flagged_bands": flagged, "armijo": armijo})
            launches = [b - a for a, b in zip(c0, pipeline._counters())]
            history[-1].update(launches=dict(zip(
                ("coh", "sweep", "matvec", "visits"), launches[:4])),
                xla_solves=launches[4], outer_s=outer_s,
                tail_s=time.perf_counter() - t_tail)
    finally:
        if writer:
            writer.close()
    return history

