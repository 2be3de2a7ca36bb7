"""Stochastic (minibatch) calibration (port of ``run_minibatch`` and its
machinery in ``sagecal_tpu/stochastic.py``; reference
``src/MS/minibatch_mode.cpp:47``).

Each solve interval (tile) is split into ``ceil(tilesz / minibatches)``-
timeslot minibatches (:func:`minibatch_rows`) and its channels into
``nsolbw`` frequency mini-bands (:func:`band_plan`, ``-w``). Every band
carries its own full solution vector and its own persistent LBFGS memory
(``solvers/lbfgs.py``); for ``-N`` epochs, each minibatch solves all
bands at once, jointly over all clusters, by robust LBFGS on the
Student's-t cost sum log1p(r^2 / nu) or the Huber cost (``--loss``,
:func:`make_band_cost`). The bands are lanes of one solve
(:func:`make_band_solver_batched`, the JAX ``vmap``): they share the
minibatch's geometry, each predicts its own channels through the
coherency kernel (``rime.predict.coherencies`` with per-channel flux),
and each lane steps, stops and stores its curvature pairs as if alone.
Residuals are written per (minibatch, band) with the minibatch-length
chunk map (minibatch_mode.cpp:71, :450-492), and the reference's
divergence policy follows every tile: a band whose residual exceeds
RES_RATIO x the band average is reset with its memory, and a residual of
0, NaN or above RES_RATIO x the best so far resets every band
(:516-542). ``-q`` warm-starts the bands (:meth:`StochasticRunner.
initial_p`).

The station beam (``-B 1|2|3``): the band lanes and the residuals
predict through the generic route with the tile's beam tables
(``rime.beam``; no coherency kernel), each minibatch row gathering them
at its GLOBAL timeslot in the tile (padded rows at the minibatch's last),
as ``build_tile_inputs`` of the JAX package does. ``-f`` lists and
per-channel flags come in through ``io/dataset.open_dataset`` (a channel
flag zeroes that channel's weight). ``--resume`` starts fresh: the
checkpoint is the sequential full-batch loop's contract, as in the JAX
package.

Stochastic consensus (``-A > 1`` with ``-w > 1``,
:func:`run_minibatch_consensus`; minibatch_consensus_mode.cpp:47): the
bands' solutions are tied by consensus ADMM to a polynomial in frequency
over the band centres (``consensus/poly.py``): each minibatch's band
solve minimises the band cost plus the augmented-Lagrangian term
(:func:`make_band_cost` with ``consensus``), then the duals and Z update
on the host in float64, a band whose residual exceeds RES_RATIO x the
mean left out of the update (:528-546); ``-U`` (``RunConfig.
use_global_solution``) replaces every band's solution by the polynomial
at its centre at the end of a tile.

Runs on the card in float32 and on the CPU in float64, like the
full-batch pipeline. The JAX package's background reader and writer
threads (``--prefetch``) and its trace records (queue A item 10) change
no value and are left out: tiles are read and written inline.
"""

from __future__ import annotations

import json
import time
from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import device as devmod
from sagecal_tpu_torch import dtypes, pipeline, skymodel, utils
from sagecal_tpu_torch.config import RunConfig
from sagecal_tpu_torch.io import dataset as ds
from sagecal_tpu_torch.io import solutions as sol
from sagecal_tpu_torch.rime import beam as bm
from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.rime import residual as rr
from sagecal_tpu_torch.solvers import lbfgs as lbfgs_mod

RES_RATIO = 5.0  # minibatch_mode.cpp res_ratio


def band_plan(nchan_total: int, nsolbw: int):
    """Channel ranges of the frequency mini-bands: ``ceil(Nchan /
    nsolbw)`` channels a band, the last taking the remainder, bands that
    end up empty dropped (minibatch_mode.cpp:89-114); ``nsolbw`` is
    clamped to Nchan. Returns (chanstart, nchan, nchanpersol)."""
    nsolbw = min(nsolbw, nchan_total)
    nchanpersol = (nchan_total + nsolbw - 1) // nsolbw
    chanstart, nchan = [], []
    count = 0
    for _ in range(nsolbw):
        nc = nchanpersol if count + nchanpersol < nchan_total else \
            nchan_total - count
        if nc <= 0:
            break
        nchan.append(nc)
        chanstart.append(count)
        count += nc
    return np.asarray(chanstart), np.asarray(nchan), nchanpersol


def minibatch_rows(tilesz: int, nbase: int, minibatches: int):
    """Row ranges of the minibatches (rows ordered t * nbase + bl):
    ``time_per_minibatch = ceil(tilesz / minibatches)``
    (minibatch_mode.cpp:57), ``minibatches`` clamped to ``tilesz`` so
    that none is empty. Returns (row_start, n_timeslots,
    time_per_minibatch)."""
    minibatches = max(min(minibatches, tilesz), 1)
    tpm = (tilesz + minibatches - 1) // minibatches
    starts, nts = [], []
    for nmb in range(minibatches):
        t0 = nmb * tpm
        t1 = min(t0 + tpm, tilesz)
        if t1 <= t0:
            break
        starts.append(t0 * nbase)
        nts.append(t1 - t0)
    return np.asarray(starts), np.asarray(nts), tpm


def _model8_rows(J, coh, idx_p, idx_q):
    """Sum over clusters of J_p C_m(f) J_q^H as [L, B, F, 8] reals, on
    L lanes: J [L, M, K, N, 2, 2], coh [L, M, B, F, 2, 2], idx_p/idx_q
    [M, B] flat (chunk, station) rows of [K * N]. The rows are an
    ``index_select`` of the real view (``utils.gather_jones`` on lanes);
    the clusters add in order, as the reference's scan does."""
    L, M, K, N = J.shape[:4]
    acc = None
    for m in range(M):
        Jr = torch.view_as_real(J[:, m].resolve_conj()).reshape(L, K * N, 8)
        Jp = torch.view_as_complex(
            Jr.index_select(1, idx_p[m]).view(L, -1, 2, 2, 2))[:, :, None]
        Jq = torch.view_as_complex(
            Jr.index_select(1, idx_q[m]).view(L, -1, 2, 2, 2))[:, :, None]
        V = utils.mul22(utils.mul22(Jp, coh[:, m]), Jq, conj_b=True)
        acc = V if acc is None else acc + V
    Lb, B, F = acc.shape[:3]
    return torch.view_as_real(acc.reshape(Lb, B, F, 4)).reshape(Lb, B, F, 8)


def _row_ids(chunk_idx, sta, n_stations: int):
    return chunk_idx.long() * n_stations + sta.long()[None]


def model8_multifreq(J, coh, sta1, sta2, chunk_idx):
    """Sum over clusters of J_p C_m(f) J_q^H as [B, F, 8] reals
    (``model8_multifreq``; robust_batchmode_lbfgs.c
    ``minimize_viz_full_multifreq``). J [M, K, N, 2, 2] complex, coh
    [M, B, F, 2, 2], chunk_idx [M, B]; a leading lane axis on J and coh
    gives [W, B, F, 8]."""
    lanes = J.dim() == 6
    if not lanes:
        J, coh = J[None], coh[None]
    N = J.shape[3]
    out = _model8_rows(J, coh, _row_ids(chunk_idx, sta1, N),
                       _row_ids(chunk_idx, sta2, N))
    return out if lanes else out[0]


def _x8f_to_complex(x8F):
    """[..., B, F, 8] reals -> [..., B, F, 2, 2] complex."""
    return utils.r2c(x8F.reshape(x8F.shape[:-1] + (4, 2))).reshape(
        x8F.shape[:-1] + (2, 2))


class BandSolverOutputs(NamedTuple):
    p: torch.Tensor          # [M, K, N, 8] (a leading [W] on lanes)
    mem: lbfgs_mod.LBFGSMemory
    res_0: torch.Tensor      # cost at p0 over the weighted reals
    res_1: torch.Tensor
    iters: object            # executed LBFGS iterations (int, or [W])


def make_band_cost(chunk_idx, chunk_mask, n_stations: int, nu: float,
                   consensus: bool = False, loss: str = "robust"):
    """The band objective of :func:`make_band_solver`: ``cost_of(x8F,
    coh, wtF, sta1, sta2, Y=None, BZ=None, rho=None) -> cost_fn(pflat)``,
    with ``r = (x8F - model8_multifreq(J, coh, ...)) * wtF`` summed as
    log1p(r^2 / nu) (Student's t) or, with ``loss="huber"``, r^2 inside
    |r| <= nu and 2 nu |r| - nu^2 outside (func_huber_th,
    robust_batchmode_lbfgs.c:66). ``cost_fn`` maps p [M K N 8] to a
    scalar, or p [W, M K N 8] on lanes (x8F, coh and wtF with a leading
    [W]) to the lanes' costs [W]. ``chunk_idx`` is a [M, B] tensor on the
    data's device.

    With ``consensus`` the augmented Lagrangian of
    bfgsfit_minibatch_consensus (robust_batchmode_lbfgs.c:1504) is added
    with the JAX package's convention (``stochastic.py:143-174``): y^T d
    + rho/2 ||d||^2, d = p - BZ over the live chunks (``chunk_mask``),
    Y and BZ [M, K, N, 8] and rho [M] (a leading [W] on lanes). The JAX
    package weighs ||d||^2 there by the SUM of the clusters' rho (its
    rho[:, None, None, None] broadcasts against the [M, K] chunk norms):
    the port computes the same term, ROADMAP queue C item C12."""
    if loss not in ("robust", "huber"):
        raise ValueError(f"--loss {loss!r}: expected robust or huber")
    M, kmax = np.asarray(chunk_mask).shape

    def cost_of(x8F, coh, wtF, sta1, sta2, Y=None, BZ=None, rho=None):
        idx_p = _row_ids(chunk_idx, sta1, n_stations)
        idx_q = _row_ids(chunk_idx, sta2, n_stations)
        lanes = x8F.dim() == 4
        xl, cl, wl = (x8F, coh, wtF) if lanes else \
            (x8F[None], coh[None], wtF[None])

        if consensus:
            live = torch.as_tensor(np.asarray(chunk_mask),
                                   device=x8F.device)[..., None, None]
            yl, bl, rl = (Y, BZ, rho) if lanes else \
                (Y[None], BZ[None], rho[None])

        def cost_fn(pflat):
            p = pflat.reshape(xl.shape[:1] + (M, kmax, n_stations, 8))
            r = (xl - _model8_rows(utils.jones_r2c(p), cl, idx_p, idx_q)) \
                * wl
            if loss == "huber":
                a = torch.abs(r)
                c = torch.where(a <= nu, r * r, 2.0 * nu * a - nu * nu)
            else:
                c = torch.log1p(r * r / nu)
            c = c.flatten(1).sum(-1)
            if consensus:
                d = torch.where(live, p - bl, torch.zeros_like(p))
                c = c + (yl * d).flatten(1).sum(-1)
                c = c + 0.5 * rl.sum(-1) * (d * d).flatten(1).sum(-1)
            return c if lanes else c[0]
        return cost_fn

    return cost_of


def _nograd(fn):
    def cost(p):
        with torch.no_grad():
            return fn(p)
    return cost


def _autograd(fn):
    """The gradient of ``fn`` (summed over lanes: lanes are independent,
    so each lane's row is its own gradient)."""
    def grad(p):
        with torch.enable_grad():
            pv = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fn(pv).sum(), pv)
        return g
    return grad


def _nreal(wtF, lanes: bool):
    """The weighted reals a band's cost runs over, at least 1."""
    n = (wtF > 0).flatten(1 if lanes else 0).sum(-1)
    return torch.clamp(n, min=1).to(dtypes.acc_dtype(wtF.dtype))


def make_band_solver(dsky, n_stations: int, chunk_idx, chunk_mask,
                     fdelta_chan: float, nu: float, max_lbfgs: int,
                     consensus: bool = False, dobeam: int = 0,
                     loss: str = "robust"):
    """The per-(band, minibatch) robust LBFGS solve
    (``bfgsfit_minibatch_visibilities``, robust_batchmode_lbfgs.c:1446):
    ``solve(x8F, u, v, w, sta1, sta2, wtF, freqsF, p0, mem)`` predicts
    the band's coherencies once (``rime.predict.coherencies`` with
    per-channel flux: the coherency kernel on the point/gaussian half),
    then minimises :func:`make_band_cost` with
    ``lbfgs.lbfgs_fit_minibatch`` from p0 [M, K, N, 8] and the band's
    persistent memory, the gradient by ``torch.autograd.grad``.
    ``freqsF`` is the band's host channel list (numpy); x8F and wtF are
    [B, F, 8]. ``armijo`` (optional list) receives the line search's
    test margins per iteration. Under ``dobeam`` the prediction takes the
    tile's beam tables ``beam`` at the rows' tile timeslots ``tslot``
    (the generic route). Returns :class:`BandSolverOutputs` with
    res_0/res_1 the cost over the count of weighted reals."""
    M, kmax = np.asarray(chunk_mask).shape
    cost_of = make_band_cost(chunk_idx, chunk_mask, n_stations, nu,
                             consensus, loss=loss)

    def solve(x8F, u, v, w, sta1, sta2, wtF, freqsF, p0, mem, armijo=None,
              tslot=None, beam=None, Y=None, BZ=None, rho=None):
        coh = rp.coherencies(dsky, u, v, w, freqsF, fdelta_chan,
                             per_channel_flux=True, beam=beam,
                             dobeam=dobeam, tslot=tslot, sta1=sta1,
                             sta2=sta2)
        nreal = _nreal(wtF, False)
        fn = cost_of(x8F, coh, wtF, sta1, sta2, Y, BZ, rho)
        cost = _nograd(fn)
        p0f = p0.reshape(-1)
        res_0 = cost(p0f) / nreal
        p1f, mem1, k = lbfgs_mod.lbfgs_fit_minibatch(
            cost, _autograd(fn), p0f, mem, itmax=max_lbfgs, armijo=armijo)
        return BandSolverOutputs(p1f.reshape(M, kmax, n_stations, 8), mem1,
                                 res_0, cost(p1f) / nreal, k)

    return solve


def make_band_solver_batched(dsky, n_stations: int, chunk_idx, chunk_mask,
                             fdelta_chan: float, nu: float, max_lbfgs: int,
                             consensus: bool = False, dobeam: int = 0,
                             loss: str = "robust"):
    """All bands of a minibatch as lanes of one solve (the JAX ``vmap``
    of :func:`make_band_solver`). x8F/wtF [W, B, F, 8], ``freqsF`` W host
    channel lists, p0 [W, M, K, N, 8], ``mem`` a memory on lanes
    (``lbfgs.stack_memories``); the geometry (u, v, w, sta1, sta2) is
    shared. Each band predicts its own channels (one coherency call a
    band); one cost evaluation returns the [W] lane costs and the
    gradient of their sum is each lane's own. Each lane keeps its own
    step, stop, slot, fill and count (``lbfgs.lbfgs_minibatch_lanes``),
    so a batch gives what W single-band solves give. ``armijo``: a list
    per lane, ``tslot`` and ``beam`` as :func:`make_band_solver`'s; with
    ``consensus``, Y and BZ [W, M, K, N, 8] and rho [W, M] per lane.
    Returns stacked :class:`BandSolverOutputs` (iters a [W] int
    array)."""
    M, kmax = np.asarray(chunk_mask).shape
    cost_of = make_band_cost(chunk_idx, chunk_mask, n_stations, nu,
                             consensus, loss=loss)

    def solve(x8F, u, v, w, sta1, sta2, wtF, freqsF, p0, mem, armijo=None,
              tslot=None, beam=None, Y=None, BZ=None, rho=None):
        W = x8F.shape[0]
        coh = torch.stack([rp.coherencies(dsky, u, v, w, f, fdelta_chan,
                                          per_channel_flux=True, beam=beam,
                                          dobeam=dobeam, tslot=tslot,
                                          sta1=sta1, sta2=sta2)
                           for f in freqsF])         # [W, M, B, F, 2, 2]
        nreal = _nreal(wtF, True)
        fn = cost_of(x8F, coh, wtF, sta1, sta2, Y, BZ, rho)
        cost = _nograd(fn)
        p0f = p0.reshape(W, -1)
        res_0 = cost(p0f) / nreal
        p1f, mem1, k = lbfgs_mod.lbfgs_minibatch_lanes(
            cost, _autograd(fn), p0f, mem, itmax=max_lbfgs, armijo=armijo)
        return BandSolverOutputs(p1f.reshape(W, M, kmax, n_stations, 8),
                                 mem1, res_0, cost(p1f) / nreal, k)

    return solve


def check_supported(cfg: RunConfig) -> None:
    """Raise for what ``pipeline.check_supported`` refuses. ``-W``,
    ``-b``, ``-J``, ``-a`` and ``-z`` pass: a stochastic run reads none
    of them, as in the JAX package."""
    pipeline.check_supported(cfg.replace(n_epochs=0))


class StochasticRunner:
    """The shared machinery of a stochastic run (``_StochasticRunner``):
    the band and minibatch plans, the per-tile staging, the residual
    write-back and the end-of-tile resets. ``device`` None is the card
    (float32; raises without one), "cpu" the CPU (float64)."""

    def __init__(self, cfg: RunConfig, ms: ds.SimMS, sky, device=None,
                 log=print):
        check_supported(cfg)
        self.cfg = cfg
        self.ms = ms
        self.sky = sky
        self.log = log
        self.device = devmod.resolve(device)
        self.rdt = devmod.real_dtype(self.device)
        if cfg.dtype_policy != "f32":
            # a reduced storage policy pairs with the float32 pipeline
            self.rdt = torch.float32
        self.sdt = dtypes.storage_dtype(cfg.dtype_policy, self.rdt)
        meta = ms.meta
        self.meta = meta
        # -B: the same beam chain as full batch (minibatch_mode.cpp's
        # _withbeam variants), the whole sky on the generic route
        self.dobeam = int(cfg.beam_mode)
        self.beam_info = bm.resolve_beaminfo(self.dobeam, ms, meta, log=log)
        self._warned_no_times = False
        self.dsky = rp.sky_to_device(sky, self.rdt, self.device) \
            if self.dobeam else rp.split_sky(sky, self.rdt, self.device)
        self.n = meta["n_stations"]
        self.nbase = meta["nbase"]
        self.tilesz = meta["tilesz"]
        self.freqs = np.asarray(meta["freqs"], np.float64)
        self.nchan_total = len(self.freqs)
        self.fdelta_chan = meta["fdelta"] / self.nchan_total
        self.kmax = int(sky.nchunk.max())
        self.cmask = np.arange(self.kmax)[None, :] < sky.nchunk[:, None]
        self.M = sky.n_clusters
        self.chanstart, self.nchan, self.fpad = band_plan(
            self.nchan_total, max(cfg.channel_avg_per_band, 1))
        self.nsolbw = len(self.chanstart)
        self.row0, self.nts, self.tpm = minibatch_rows(
            self.tilesz, self.nbase, max(cfg.n_minibatches, 1))
        self.minibatches = len(self.row0)
        self.bmb = self.tpm * self.nbase     # padded rows per minibatch
        # chunk map for the MINIBATCH length (minibatch_mode.cpp:71)
        self.cidx = torch.as_tensor(
            rp.chunk_indices(self.tpm, self.nbase, sky.nchunk),
            device=self.device, dtype=torch.long)
        self.nparam = self.M * self.kmax * self.n * 8
        self.sub_mask = sky.subtract_mask()
        self.correct_idx = skymodel.correct_cluster_index(
            sky, cfg.correct_cluster, warn=log)
        log(f"Stochastic calibration with {cfg.n_epochs} epochs (passes) of "
            f"{self.minibatches} minibatches each for each solution "
            f"interval.")
        log(f"Time per minibatch: {self.tpm}")
        log(f"Finding {self.nsolbw} solutions, each "
            f"{(self.nchan_total + self.nsolbw - 1) // self.nsolbw} "
            f"channels wide")

    def initial_p(self):
        """(pinit, per-band starts) as [M, K, N, 8] reals: the identity
        Jones, or the ``-q`` warm start (``_StochasticRunner.initial_p``;
        minibatch_mode.cpp:229-232). The file's last interval is read: a
        multi-band file maps band for band when its band count is the
        run's, else every band starts from its first band; a single-band
        file replaces the identity and starts every band. ``pinit`` (the
        end-of-tile reset target) stays the identity under a multi-band
        file, as in the JAX package. Every value goes through float32,
        as the JAX package casts them (``astype(np.float32)``, under x64
        too): the port carries that cast over, so a float64 run starts
        from the JAX package's values."""
        J0 = np.tile(np.eye(2, dtype=np.complex128),
                     (self.M, self.kmax, self.n, 1, 1))
        per_band = None
        if self.cfg.init_solutions:
            _, blocks = sol.read_solutions(self.cfg.init_solutions,
                                           self.sky.nchunk)
            if blocks:
                last = blocks[-1]
                if isinstance(last, list):
                    per_band = last if len(last) == self.nsolbw \
                        else [last[0]] * self.nsolbw
                else:
                    J0 = last
        pinit = utils.jones_c2r_np(J0).astype(np.float32)
        if per_band is not None:
            return pinit, [utils.jones_c2r_np(Jb).astype(np.float32)
                           for Jb in per_band]
        return pinit, [pinit.copy() for _ in range(self.nsolbw)]

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=self.rdt if dtype is None else dtype)

    def build_tile_inputs(self, tile: ds.VisTile):
        """Every minibatch's solve inputs, padded to ``tpm`` timeslots:
        a dict nmb -> (x8F [W, B, Fp, 8], u, v, w, sta1, sta2, wtF [W, B,
        Fp, 8], freqsF: W host channel lists). The ``-x/-y`` uv window
        flags a COPY of the row flags (the written flags stay as read);
        per-channel flags zero their channels' weights; a band narrower
        than Fp is padded with zero weights and its first channel
        repeated. Under ``-B`` the dict also holds ``"beam"`` (the
        tile's beam tables) and ``"tslot"`` (nmb -> each row's timeslot
        in the TILE, padded rows at the minibatch's last slot)."""
        rowflags = rp.apply_uvcut(tile.flags, tile, self.cfg.uvmin,
                                  self.cfg.uvmax)
        out = {}
        if self.dobeam:
            if tile.time_mjd is None and not self._warned_no_times:
                self.log("WARNING: dataset tiles carry no timestamps; beam "
                         "az/el will be evaluated at the J2000 placeholder "
                         "epoch")
                self._warned_no_times = True
            out["beam"] = bm.beam_to_device(
                self.beam_info, self.meta["freq0"], self.rdt,
                time_jd=tile.time_jd, device=self.device)
            out["tslot"] = {}
        for nmb in range(self.minibatches):
            r0 = self.row0[nmb]
            nrow = self.nts[nmb] * self.nbase
            sel = slice(r0, r0 + nrow)
            u, v, w = (np.zeros(self.bmb) for _ in range(3))
            u[:nrow], v[:nrow], w[:nrow] = tile.u[sel], tile.v[sel], \
                tile.w[sel]
            sta1 = np.zeros(self.bmb, np.int64)
            sta2 = np.ones(self.bmb, np.int64)
            sta1[:nrow], sta2[:nrow] = tile.sta1[sel], tile.sta2[sel]
            good = (rowflags[sel] == 0)[:, None]
            if self.dobeam:
                out["tslot"][nmb] = self._t(np.minimum(
                    (r0 + np.arange(self.bmb)) // self.nbase,
                    self.tilesz - 1), torch.long)
            x8s, wts, fls = [], [], []
            for b in range(self.nsolbw):
                c0, nc = self.chanstart[b], self.nchan[b]
                x = np.zeros((self.bmb, self.fpad, 4), np.complex128)
                x[:nrow, :nc] = tile.x[sel, c0:c0 + nc].reshape(nrow, nc, 4)
                x8s.append(np.stack([x.real, x.imag], -1).reshape(
                    self.bmb, self.fpad, 8))
                ok = np.broadcast_to(good, (nrow, nc))
                if tile.cflags is not None:
                    ok = ok & (tile.cflags[sel, c0:c0 + nc] == 0)
                wt = np.zeros((self.bmb, self.fpad, 8))
                wt[:nrow, :nc] = np.where(ok[..., None], 1.0, 0.0)
                wts.append(wt)
                fl = np.full(self.fpad, self.freqs[c0], np.float64)
                fl[:nc] = self.freqs[c0:c0 + nc]
                fls.append(fl)
            out[nmb] = (self._t(np.stack(x8s), self.sdt), self._t(u),
                        self._t(v), self._t(w), self._t(sta1, torch.long),
                        self._t(sta2, torch.long),
                        self._t(np.stack(wts), self.sdt), fls)
        return out

    def stack_state(self, pfreq, mems):
        """Per-band host state -> (p [W, M, K, N, 8] on the device, the
        memories on lanes)."""
        return self._t(np.stack(pfreq)), lbfgs_mod.stack_memories(mems)

    def unstack_state(self, pstack, memstack, pfreq, mems):
        """Lanes back into the per-band lists, in place (the end-of-tile
        resets own them)."""
        p_np = pstack.cpu().numpy()
        for b in range(self.nsolbw):
            pfreq[b] = p_np[b]
            mems[b] = lbfgs_mod.lane_memory(memstack, b)

    def residual(self, inputs, b: int, p, beam_kw=None):
        """One (minibatch, band) residual, [bmb, Fp, 2, 2] complex128:
        the data minus every subtractable cluster's J_p C(f) J_q^H with
        the minibatch chunk map, corrected by ``-k``'s cluster
        (minibatch_mode.cpp:450-492); ``beam_kw`` the beam, dobeam and
        rows' tile timeslots under ``-B``."""
        beam_kw = beam_kw or {}
        x8F, u, v, w, s1, s2, _, fls = inputs
        res = rr.calculate_residuals_multifreq(
            self.dsky, utils.jones_r2c(self._t(p)), _x8f_to_complex(x8F[b]),
            u, v, w, fls[b], self.fdelta_chan, s1, s2, self.cidx,
            self.sub_mask, correct_idx=self.correct_idx,
            rho=self.cfg.mmse_rho, **beam_kw)
        return utils.r2c(rr.residual_writeback(res, self.sdt).to(
            "cpu", torch.float64).numpy())

    def write_residuals(self, tile, ti, inputs, pfreq):
        """Every (minibatch, band) residual into the tile's data, written
        to the output column."""
        xout = np.array(tile.x)
        for nmb in range(self.minibatches):
            r0 = self.row0[nmb]
            nrow = self.nts[nmb] * self.nbase
            bkw = {} if not self.dobeam else dict(
                beam=inputs["beam"], dobeam=self.dobeam,
                tslot=inputs["tslot"][nmb])
            for b in range(self.nsolbw):
                c0, nc = self.chanstart[b], self.nchan[b]
                res = self.residual(inputs[nmb], b, pfreq[b], bkw)
                xout[r0:r0 + nrow, c0:c0 + nc] = res[:nrow, :nc]
        tile.x = xout
        self.ms.write_tile(ti, tile)

    def solution_writer(self):
        if not self.cfg.solutions_file:
            return None
        return sol.SolutionWriter(
            self.cfg.solutions_file, self.meta["freq0"], self.meta["fdelta"],
            self.tilesz * self.meta["tdelta"] / 60.0, self.n,
            self.M, self.sky.n_eff_clusters,
            nchan=self.nchan_total if self.nsolbw > 1 else None,
            nsolbw=self.nsolbw if self.nsolbw > 1 else None)

    def end_of_tile(self, tile, ti, inputs, state, resband, res_0, res_1, t0,
                    writer, history, extra=None):
        """The per-tile tail (minibatch_mode.cpp:448-546): residual
        write-back, the solutions, the per-band reset (a band above
        RES_RATIO x res_1 restarts from pinit with a fresh memory), the
        global reset (a residual of 0, NaN, or above RES_RATIO x the best
        so far: every band restarts from pinit, memories kept), and the
        record. ``res_prev`` forgets a 0 or NaN residual, so one bad tile
        cannot ratchet resets."""
        pfreq, mems, pinit = state["pfreq"], state["mems"], state["pinit"]
        self.write_residuals(tile, ti, inputs, pfreq)
        if writer:
            writer.write_interval_multiband(
                [utils.jones_r2c_np(p.astype(np.float64)) for p in pfreq],
                self.sky.nchunk)
        for b in range(self.nsolbw):
            if resband[b] > RES_RATIO * res_1:
                self.log(f"Resetting solution for band {b}")
                pfreq[b] = pinit.copy()
                mems[b] = lbfgs_mod.lbfgs_memory_reset(mems[b])
        res_prev = state["res_prev"]
        if res_1 == 0.0 or not np.isfinite(res_1) or (
                res_prev is not None and res_1 > RES_RATIO * res_prev):
            self.log("Resetting Solution")
            for b in range(self.nsolbw):
                pfreq[b] = pinit.copy()
            state["res_prev"] = res_1 if (np.isfinite(res_1) and res_1 > 0) \
                else None
        else:
            state["res_prev"] = res_1 if res_prev is None \
                else min(res_prev, res_1)
        dt = (time.time() - t0) / 60.0
        self.log(f"Timeslot: {ti} Residual: initial={res_0:.6g}, "
                 f"final={res_1:.6g}, Time spent={dt:.3g} minutes")
        history.append({"tile": ti, "res_0": res_0, "res_1": res_1,
                        "minutes": dt, **(extra or {})})


def _open(cfg: RunConfig, log=print):
    if cfg.resume:
        # the checkpoint is the sequential full-batch contract: the
        # minibatch chain has no tile-boundary watermark
        log("resume: unsupported in stochastic mode; starting fresh")
    ms = ds.open_dataset(cfg.ms, cfg.ms_list, tilesz=cfg.tile_size,
                         data_column=cfg.input_column,
                         out_column=cfg.output_column)
    meta = ms.meta
    sky = skymodel.read_sky_cluster(cfg.sky_model, cfg.cluster_file,
                                    meta["ra0"], meta["dec0"], meta["freq0"],
                                    cfg.format_3)
    return ms, sky


class StochasticStepper:
    """The minibatch run one tile at a time (``StochasticStepper``):
    :meth:`stage` builds a tile's inputs, :meth:`step` runs its epochs
    and minibatches (all bands as lanes of one solve a minibatch) and
    its end-of-tile tail, :meth:`close` closes the solutions file. The
    per-band solutions and memories persist across tiles here.

    Each history record holds ``tile``, ``res_0``, ``res_1`` (the band
    means of the last solve), ``minutes``, ``lbfgs_iters`` (per solve,
    per band), ``launches`` (the coherency kernel and, which must stay 0,
    the solve kernels and XLA solves), ``armijo`` (per solve, per band,
    per iteration: the line search's test margins) and
    ``lbfgs_exhausted`` (line searches whose every test failed, so that
    the last halved step was taken untested, as the reference takes
    it)."""

    def __init__(self, cfg: RunConfig, device=None, log=print):
        self.cfg = cfg
        self.log = log
        check_supported(cfg)
        device = devmod.resolve(device)
        ms, sky = _open(cfg, log)
        self.ms = ms
        self.rn = rn = StochasticRunner(cfg, ms, sky, device=device, log=log)
        self.solver = make_band_solver_batched(
            rn.dsky, rn.n, rn.cidx, rn.cmask, rn.fdelta_chan,
            nu=cfg.robust_nulow, max_lbfgs=cfg.max_lbfgs, dobeam=rn.dobeam,
            loss=cfg.stochastic_loss)
        pinit, pfreq = rn.initial_p()
        like = torch.zeros((), dtype=rn.rdt, device=rn.device)
        self.mems = [lbfgs_mod.lbfgs_memory_init(rn.nparam, cfg.lbfgs_m,
                                                 like)
                     for _ in range(rn.nsolbw)]
        self.pfreq = pfreq
        self.writer = rn.solution_writer()
        self.state = {"pfreq": pfreq, "mems": self.mems, "pinit": pinit,
                      "res_prev": None}
        self.n_tiles = ms.n_tiles
        if cfg.max_timeslots:
            self.n_tiles = min(self.n_tiles, cfg.max_timeslots)
        self.history: list = []

    def stage(self, ti, tile):
        return self.rn.build_tile_inputs(tile)

    def step(self, ti, tile, inputs):
        cfg, rn, log = self.cfg, self.rn, self.log
        t0 = time.time()
        c0 = pipeline._counters()
        pfreq, mems = self.pfreq, self.mems
        resband = np.zeros(rn.nsolbw)
        res_0 = res_1 = 0.0
        iters, armijo = [], []
        pstack, memstack = rn.stack_state(pfreq, mems)
        for nepch in range(cfg.n_epochs):
            for nmb in range(rn.minibatches):
                margins = [[] for _ in range(rn.nsolbw)]
                bkw = {} if not rn.dobeam else dict(
                    beam=inputs["beam"], tslot=inputs["tslot"][nmb])
                out = self.solver(*inputs[nmb], pstack, memstack,
                                  armijo=margins, **bkw)
                pstack, memstack = out.p, out.mem
                r0s = out.res_0.to("cpu", torch.float64).numpy()
                r1s = out.res_1.to("cpu", torch.float64).numpy()
                resband[:] = r1s
                if cfg.verbose:
                    for b in range(rn.nsolbw):
                        log(f"epoch={nepch} minibatch={nmb} band={b} "
                            f"{r0s[b]:.6f} {r1s[b]:.6f}")
                res_0, res_1 = float(np.mean(r0s)), float(np.mean(r1s))
                iters.append([int(k) for k in out.iters])
                armijo.append(margins)
        rn.unstack_state(pstack, memstack, pfreq, mems)
        rn.end_of_tile(tile, ti, inputs, self.state, resband, res_0, res_1,
                       t0, self.writer, self.history,
                       extra={"lbfgs_iters": iters, "armijo": armijo})
        # launches over the tile, its residual pass included
        rec = self.history[-1]
        launches = [b - a for a, b in zip(c0, pipeline._counters())]
        rec.update(launches=dict(zip(("coh", "sweep", "matvec", "visits"),
                                     launches[:4])), xla_solves=launches[4],
                   lbfgs_exhausted=sum(
                       len(it) == lbfgs_mod.MAX_HALVINGS and it[-1] > 0
                       for solve in armijo for band in solve for it in band))
        if cfg.verbose:
            log(f"Timeslot: {ti} stats: " + json.dumps(
                {k: rec[k] for k in ("lbfgs_iters", "lbfgs_exhausted",
                                     "launches", "xla_solves")}))
        return rec

    def close(self):
        if self.writer:
            self.writer.close()


def stepper(cfg: RunConfig, device=None, log=print) -> StochasticStepper:
    return StochasticStepper(cfg, device=device, log=log)


def run_minibatch(cfg: RunConfig, device=None, log=print):
    """Stochastic minibatch calibration (minibatch_mode.cpp:47) on
    ``device`` (None: the card, raising without one), tile by tile;
    returns the per-tile history."""
    st = StochasticStepper(cfg, device=device, log=log)
    try:
        for ti in range(st.n_tiles):
            tile = st.ms.read_tile(ti)
            st.step(ti, tile, st.stage(ti, tile))
    finally:
        st.close()
    return st.history


def run_minibatch_consensus(cfg: RunConfig, device=None, log=print):
    """Stochastic minibatch calibration with single-node frequency
    consensus (``run_minibatch_consensus``, ``stochastic.py:762-888`` of
    the JAX package; minibatch_consensus_mode.cpp:47) on ``device``
    (None: the card, raising without one).

    The -w bands' solutions are tied by ADMM to a ``-P``-term polynomial
    of type ``-Q`` over the band centres, with rho from ``-r`` or the
    ``-G`` file per cluster. Per tile, the duals Y and Z start at 0; for
    each of ``-A`` ADMM iterations, ``-N`` epochs of the minibatches
    solve all bands as lanes of one band solve with the augmented term
    (Y_b, B_b Z, rho), then on the host in float64 a band whose residual
    is non-positive or above RES_RATIO x the bands' mean is flagged out,
    the others add rho p_b to Y_b, Z = Bii sum_b B_b Y_b and the others
    take Y_b -= rho B_b Z. ``-U`` ends the tile with every band at the
    polynomial's value at its centre (through float32, as the JAX package
    casts it). The residual write-back, the solutions and the resets are
    the plain run's (:meth:`StochasticRunner.end_of_tile`).

    Returns one record a tile: res_0, res_1, minutes, lbfgs_iters (per
    solve, per band), armijo, the dual residual and the flagged bands
    per solve, and the kernel launches."""
    from sagecal_tpu_torch.consensus import poly as cpoly
    check_supported(cfg)
    device = devmod.resolve(device)
    ms, sky = _open(cfg, log)
    rn = StochasticRunner(cfg, ms, sky, device=device, log=log)
    if rn.nchan_total == 1:
        raise ValueError("consensus optimization needs more than 1 channel "
                         "(minibatch_consensus_mode.cpp:90)")
    log(f"ADMM iterations={cfg.n_admm} polynomial order={cfg.n_poly} "
        f"regularization={cfg.admm_rho}")
    # the basis at the band centres, rho per cluster replicated per band
    fcen = np.array([rn.freqs[c0:c0 + nc].mean()
                     for c0, nc in zip(rn.chanstart, rn.nchan)])
    B = cpoly.setup_polynomials(fcen, ms.meta["freq0"], cfg.n_poly,
                                cfg.poly_type)                 # [W, P]
    arho = np.full(rn.M, cfg.admm_rho)
    if cfg.rho_file:
        arho = skymodel.read_cluster_rho(cfg.rho_file, sky.cluster_ids,
                                         cfg.admm_rho)
    rhok = np.tile(arho[None, :], (rn.nsolbw, 1))              # [W, M]
    Bt = torch.as_tensor(B)
    Bii = cpoly.find_prod_inverse(Bt, torch.as_tensor(rhok.T).contiguous())
    solver = make_band_solver_batched(
        rn.dsky, rn.n, rn.cidx, rn.cmask, rn.fdelta_chan,
        nu=cfg.robust_nulow, max_lbfgs=cfg.max_lbfgs, consensus=True,
        dobeam=rn.dobeam, loss=cfg.stochastic_loss)
    pinit, pfreq = rn.initial_p()
    like = torch.zeros((), dtype=rn.rdt, device=rn.device)
    mems = [lbfgs_mod.lbfgs_memory_init(rn.nparam, cfg.lbfgs_m, like)
            for _ in range(rn.nsolbw)]
    writer = rn.solution_writer()
    state = {"pfreq": pfreq, "mems": mems, "pinit": pinit, "res_prev": None}
    pshape = (rn.M, rn.kmax, rn.n, 8)
    n_tiles = ms.n_tiles if not cfg.max_timeslots \
        else min(ms.n_tiles, cfg.max_timeslots)
    history = []
    try:
        for ti in range(n_tiles):
            t0 = time.time()
            c0 = pipeline._counters()
            tile = ms.read_tile(ti)
            inputs = rn.build_tile_inputs(tile)
            Y = np.zeros((rn.nsolbw,) + pshape)
            Z = np.zeros((rn.M, cfg.n_poly, rn.kmax, rn.n, 8))
            resband = np.zeros(rn.nsolbw)
            res_0 = res_1 = 0.0
            iters, armijo, duals, flagged = [], [], [], []
            pstack, memstack = rn.stack_state(pfreq, mems)
            rho_d = rn._t(rhok)
            for nadmm in range(cfg.n_admm):
                for nepch in range(cfg.n_epochs):
                    for nmb in range(rn.minibatches):
                        BZ_all = np.einsum("bp,mpkns->bmkns", B, Z)
                        bkw = {} if not rn.dobeam else dict(
                            beam=inputs["beam"], tslot=inputs["tslot"][nmb])
                        margins = [[] for _ in range(rn.nsolbw)]
                        out = solver(*inputs[nmb], pstack, memstack,
                                     armijo=margins, Y=rn._t(Y),
                                     BZ=rn._t(BZ_all), rho=rho_d, **bkw)
                        pstack, memstack = out.p, out.mem
                        p_np = pstack.to("cpu", torch.float64).numpy()
                        r0s = out.res_0.to("cpu", torch.float64).numpy()
                        r1s = out.res_1.to("cpu", torch.float64).numpy()
                        # a non-positive residual marks a bad solve
                        resband[:] = np.where((r0s > 0) & (r1s > 0), r1s,
                                              np.inf)
                        if cfg.verbose:
                            for b in range(rn.nsolbw):
                                primal = float(np.linalg.norm(
                                    (p_np[b] - BZ_all[b])
                                    * rn.cmask[..., None, None])
                                    / np.sqrt(p_np[b].size))
                                log(f"admm={nadmm} epoch={nepch} "
                                    f"minibatch={nmb} band={b} primal "
                                    f"{primal:.6f} {r0s[b]:.6f} "
                                    f"{r1s[b]:.6f}")
                        res_0, res_1 = float(np.mean(r0s)), float(np.mean(r1s))
                        iters.append([int(k) for k in out.iters])
                        armijo.append(margins)
                        # diverged bands stay out of the Z update (:528-546)
                        good = ~(resband > RES_RATIO * res_1)
                        flagged.append(np.flatnonzero(~good).tolist())
                        for b in np.flatnonzero(good):
                            Y[b] += rhok[b][:, None, None, None] * p_np[b]
                        zsum = np.einsum("b,bp,bmkns->mpkns",
                                         good.astype(float), B, Y)
                        Zold = Z
                        Z = cpoly.z_from_contributions(
                            torch.as_tensor(zsum), Bii).numpy()
                        dual = float(np.linalg.norm(Z - Zold)
                                     / np.sqrt(Z.size))
                        duals.append(dual)
                        if cfg.verbose:
                            log(f"ADMM : {nadmm} dual residual={dual:.6f}")
                        for b in np.flatnonzero(good):
                            Y[b] -= rhok[b][:, None, None, None] * np.einsum(
                                "p,mpkns->mkns", B[b], Z)
            rn.unstack_state(pstack, memstack, pfreq, mems)
            if cfg.use_global_solution:
                log("Using Global")
                for b in range(rn.nsolbw):
                    pfreq[b] = np.einsum("p,mpkns->mkns", B[b], Z).astype(
                        np.float32)
            rn.end_of_tile(tile, ti, inputs, state, resband, res_0, res_1,
                           t0, writer, history,
                           extra={"lbfgs_iters": iters, "armijo": armijo,
                                  "duals": duals, "flagged_bands": flagged})
            launches = [b - a for a, b in zip(c0, pipeline._counters())]
            history[-1].update(launches=dict(zip(
                ("coh", "sweep", "matvec", "visits"), launches[:4])),
                xla_solves=launches[4])
            if cfg.verbose:
                log(f"Timeslot: {ti} stats: " + json.dumps(
                    {k: history[-1][k] for k in ("lbfgs_iters", "duals",
                                                 "flagged_bands",
                                                 "launches")}))
    finally:
        if writer:
            writer.close()
    return history
