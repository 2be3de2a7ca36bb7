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

The subbands solve one after another; batching them as lanes of one
``sage.sagefit_host_tiles`` solve is performance work (ROADMAP). The
consensus state (Y, Z, B Z, rho and the basis) is kept in the pipeline's
dtype, float32 on the card and float64 on the CPU, under every
``--dtype-policy``: only the solves' rows are stored reduced.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import utils
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


def divergence_reset(JF, J0F, res0, res_fin, ratio: float = 5.0):
    """The per-subband warm-start divergence rule (slave :680-683): a
    subband whose final residual is non-finite, exactly 0 (all flagged)
    or above ``ratio`` x its initial one restarts the next interval from
    ``J0F``. JF, J0F [F, ...], res0 and res_fin [F] numpy arrays. Returns
    (J, the [F] bool mask of reset subbands)."""
    res_fin, res0 = np.asarray(res_fin), np.asarray(res0)
    bad = (~np.isfinite(res_fin)) | (res_fin == 0.0) \
        | (res_fin > ratio * res0)
    shape = (-1,) + (1,) * (np.ndim(JF) - 1)
    return np.where(bad.reshape(shape), J0F, JF), bad


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

    # ADMM iterations k > 0 warm-start from the previous iterate: the
    # cluster groups skip the cold first-sweep width, and there is no
    # refine (iteration 0 keeps the configuration as given)
    cfg_admm = cfg.sage._replace(max_lbfgs=0, inflight_warm=True)

    def per_subband(inputs, JF, cfg_s, admm=None, beamF=None):
        x8F, uF, vF, wF, freqF, wtF = inputs
        out = [local_solve(x8F[f], uF[f], vF[f], wF[f], wtF[f], JF[f],
                           freqF[f], None if beamF is None else beamF[f],
                           cfg_s, None if admm is None
                           else tuple(a[f] for a in admm))
               for f in range(x8F.shape[0])]
        if groups is not None:
            groups.append([o[3] for o in out])
        return (torch.stack([o[0] for o in out]),
                torch.as_tensor([float(o[1]) for o in out],
                                dtype=torch.float64),
                torch.as_tensor([float(o[2]) for o in out],
                                dtype=torch.float64))

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
        rho_m = torch.as_tensor(np.broadcast_to(np.asarray(cfg.rho,
                                                           np.float64),
                                                (M,)).copy(),
                                dtype=dtype, device=dev)
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

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def iterate(inputs, B, st, beamF=None):
        """Iterations 1 .. A - 1 from the state ``st`` (in place);
        returns (r1s, duals)."""
        r1s, duals = [], []
        for it in range(1, max(cfg.n_admm, 1)):
            t0 = time.perf_counter()
            Jr, _, r1 = per_subband(
                inputs, st["JF"], cfg_admm,
                admm=(st["YF"], bz_of(B, st["Z"]), st["rhoF"]), beamF=beamF)
            duals.append(body_post(B, Jr.to(B.dtype), st, it))
            r1s.append(r1)
            _sync()
            if timer is not None:
                timer.append((f"body[{it}]", time.perf_counter() - t0))
        F = inputs[0].shape[0]
        return (torch.stack(r1s) if r1s
                else torch.zeros((0, F), dtype=torch.float64),
                torch.stack(duals) if duals
                else torch.zeros((0,), dtype=B.dtype, device=dev))

    def run(x8F, uF, vF, wF, freqF, wtF, fratioF, J0F, beamF=None):
        dtype = J0F.dtype
        B = torch.as_tensor(np.asarray(B_poly), dtype=dtype, device=dev)
        inputs = (x8F, uF, vF, wF, np.asarray(freqF), wtF)
        t0 = time.perf_counter()
        JF, res0, res1 = per_subband(inputs, J0F, cfg.sage, beamF=beamF)
        st, Y0F = iter0_post(B, JF.to(dtype), fratioF.to(dtype))
        _sync()
        if timer is not None:
            timer.append(("iter0", time.perf_counter() - t0))
        r1s, duals = iterate(inputs, B, st, beamF)
        return (st["JF"], st["Z"], st["rhoF"], res0, res1, r1s, duals, Y0F)

    def from_state(x8F, uF, vF, wF, freqF, wtF, state, beamF=None):
        """Iterations 1 .. A - 1 from an iteration-0 ``state`` (the dict
        of ``convert.admm_state_from_numpy``: the JAX runner's carry):
        (JF, Z, rhoF, r1s, duals)."""
        st = dict(state)
        B = torch.as_tensor(np.asarray(B_poly), dtype=st["JF"].dtype,
                            device=dev)
        st["alpha"] = alpha_vec(torch.as_tensor(
            np.broadcast_to(np.asarray(cfg.rho, np.float64), (M,)).copy(),
            dtype=B.dtype, device=dev))
        r1s, duals = iterate((x8F, uF, vF, wF, np.asarray(freqF), wtF), B,
                             st, beamF)
        return st["JF"], st["Z"], st["rhoF"], r1s, duals

    run.from_state = from_state
    return run
