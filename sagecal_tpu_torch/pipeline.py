"""Full-batch calibration pipeline (port of the sequential tile loop of
``sagecal_tpu/pipeline.py``).

Stream solve intervals (tiles) from the dataset, predict the solve
coherencies (the coherency kernel on the point/gaussian half of the sky,
the eager envelopes on the rest: ``rime/predict.py``, the sky split once
at construction), run SAGE-EM (every solver mode ``-j 0..6``: LM, OS-LM,
robust LM, RTR, robust RTR and NSD, on the fused-sweep kernel or the XLA
assembly as ``--kernel`` and the shapes decide, ``--inner cg`` on the
matvec kernel or the matrix-free [B] operator; then the joint LBFGS
refine), subtract the model from every channel and write the residuals
and the solutions, with the reference's heuristics:

- first-tile iteration boost: 4x EM iterations for arrays <= LMCUT (40)
  stations, 6x otherwise;
- LMCUT solver downgrade of the RTR/NSD modes for small arrays;
- divergence reset: a residual of 0, non-finite or above RES_RATIO x
  the best so far resets the solutions and re-arms the boost;
- in-flight cluster groups (``--inflight``): the first tile (and the
  first after a reset) solves cold, the others warm; a divergence reset
  with groups active falls back to sequential updates for the rest of
  the run;
- ``--tile-batch T``: after the boosted first tile, T tiles at a time
  solve as one lane-batched SAGE solve (``sage.sagefit_host_tiles``),
  warm-started per batch; a short tail solves tile by tile.

The solve and correction options: ``-q`` warm-starts from a solution
file (and a divergence reset returns to it); ``-W 1`` whitens the solve
input by uv density (never the residual's input); ``-J 1`` corrects the
``-k`` cluster by its phases alone; ``-b 1`` solves the joint SAGE step
without its LBFGS refine, then every channel by an LBFGS-only fit
(``sage.bfgsfit``) warm-started from the joint solution, and writes
each channel's residual and carries the last channel's solutions
(:meth:`FullBatchPipeline.solve_channels`). ``-a 1/2/3`` simulates
instead of calibrating (:meth:`FullBatchPipeline.run_simulation`).

Input and restart: ``-f`` lists open as one dataset of every part's
channels (``io/dataset.py:MultiSimMS``); per-channel flags and the uv
taper (``RunConfig.uvtaper``) stage through the native tile packer
(``VisTile.solve_input``), and ``-b 1`` zeroes a channel's flagged rows
in that channel's solve. ``--resume`` continues a killed run from the
tile-boundary checkpoint beside the solutions file
(``io/solutions.py``), which the sequential loop writes after every
tile's writes and removes at a clean end; the ``--tile-batch`` loop
writes none and starts fresh.

The station beam (``-B 1|2|3``): the beam metadata of the dataset (or a
synthetic layout), the sky and the beam pointing precessed once to the
first tile's mid-timeslot epoch, then per-tile beam tables
(:meth:`FullBatchPipeline._tile_beam`) in every predict: the solve, the
residual, the tile batch, ``-b 1``'s channels and the simulation modes.
Under the beam the whole sky predicts through the generic route with the
beam tables: no coherency kernel runs, as in the JAX package.

One subband's rows over ranks (``--shard-baselines``; ``_build_sharded_
solver`` of the JAX package, ``parallel.py``): with a process group each
rank stages its own whole timeslots of every tile (``parallel.RowPlan``;
the last block padded with zero-weight timeslots) on its own device,
predicts their coherencies through ``rime/predict.coherencies`` (the
coherency kernel on the card, shard-local: the same function as the JAX
sharded path's plain XLA predict), and runs ``sage.sagefit_host`` with
the row group, every row sum of every solver a collective. The
residuals are per row: each rank computes its own, rank 0 gathers them
(``distributed.gather_to_root``) and writes the residual column, the
solutions and the checkpoint; the other ranks write and log nothing.
``--tile-batch`` is off on this path, as in the JAX package.

The JAX package's serve cache, fleet, priors, overlapped scheduler,
fault injection and tracing are not ported yet; their options raise
``NotImplementedError`` (see ``cli.py:UNPORTED``).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from sagecal_tpu_torch import coords
from sagecal_tpu_torch import device as devmod
from sagecal_tpu_torch import distributed as dist
from sagecal_tpu_torch import dtypes, parallel
from sagecal_tpu_torch import skymodel, utils
from sagecal_tpu_torch.config import RunConfig, SimulationMode, SolverMode
from sagecal_tpu_torch.io import dataset as ds
from sagecal_tpu_torch.io import native
from sagecal_tpu_torch.io import solutions as sol
from sagecal_tpu_torch.ops import coh as coh_ops
from sagecal_tpu_torch.ops import sweep as swp
from sagecal_tpu_torch.rime import beam as bm
from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.rime import residual as rr
from sagecal_tpu_torch.solvers import lm as lm_mod
from sagecal_tpu_torch.solvers import robust as rb
from sagecal_tpu_torch.solvers import sage

LMCUT = 40
RES_RATIO = 5.0


def effective_solver_mode(mode: int, n_stations: int) -> int:
    """LMCUT downgrade (reference fullbatch_mode.cpp)."""
    if n_stations <= LMCUT and mode == int(SolverMode.RTR_OSLM_LBFGS):
        return int(SolverMode.OSLM_LBFGS)
    if n_stations <= LMCUT and mode in (int(SolverMode.RTR_OSRLM_RLBFGS),
                                        int(SolverMode.NSD_RLBFGS)):
        return int(SolverMode.OSLM_OSRLM_RLBFGS)
    return mode


def first_tile_boost(n_stations: int) -> int:
    return 4 if n_stations <= LMCUT else 6


def check_supported(cfg: RunConfig) -> None:
    """Raise for a configuration this pipeline does not run:
    ``ValueError`` for ``-N > 0``, which ``stochastic.py`` runs, and for
    an unknown storage policy (``dtypes.validate``)."""
    if cfg.n_epochs > 0:
        raise ValueError("-N > 0 is stochastic calibration: run it with "
                         "stochastic.run_minibatch (the CLI routes it)")
    dtypes.validate(cfg.dtype_policy)


class FullBatchPipeline:
    """The sequential full-batch tile loop over a SimMS dataset.

    ``device``: None runs on CUDA (raising without a card), "cpu" on the
    CPU. The pipeline computes in float32 on the card and float64 on the
    CPU, and in float32 on both under a reduced ``--dtype-policy`` (its
    accumulator dtype: ``pipeline.py:124-133`` of the JAX package), with
    the solve's data and weights staged in the storage dtype ``sdt``.

    ``rows`` (a ``parallel.RowGroup``): this rank's whole timeslots of
    every tile (module docstring); the per-row tables are the rank's
    slices of the whole tile's."""

    def __init__(self, cfg: RunConfig, ms, sky: skymodel.ClusterSky,
                 device=None, log=print, rows=None):
        check_supported(cfg)
        self.cfg = cfg
        self.rows = rows
        self.rank = 0 if rows is None else rows.rank
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
        # -B: the dataset's beam metadata, else a synthetic layout
        # (fullbatch_mode.cpp:56-70); under the beam the whole sky
        # predicts through the generic route (the JAX package gates its
        # coherency kernel off), precessed once to the first tile's
        # epoch before any solve (data.cpp:1473, fullbatch_mode.cpp:325)
        self.dobeam = int(cfg.beam_mode)
        self.beam_info = bm.resolve_beaminfo(self.dobeam, ms, meta, log=log)
        self._warned_no_times = False
        self.precessed = False
        if self.dobeam:
            self.dsky = rp.sky_to_device(sky, self.rdt, self.device)
            self._precess_sources(log)
        else:
            # both device skies once (the JAX package's _pallas_skies):
            # the point/gaussian half for the coherency kernel, the rest
            # for the generic predict; on the CPU too, where the kernel
            # half runs its plain version. A kernel that fails raises:
            # there is no fallback.
            self.dsky = rp.split_sky(sky, self.rdt, self.device)
        self.kmax = int(sky.nchunk.max())
        self.cmask = torch.as_tensor(
            np.arange(self.kmax)[None, :] < sky.nchunk[:, None],
            device=self.device)
        # the per-row tables of the whole tile, or this rank's rows of
        # them (padded rows: chunk 0, timeslot 0, subset 0, weight 0)
        cidx = rp.chunk_indices(meta["tilesz"], meta["nbase"], sky.nchunk)
        tslot = ds.row_tslot(meta["tilesz"] * meta["nbase"], meta["nbase"])
        os_id, n_sub = lm_mod.os_subset_ids(meta["tilesz"], meta["nbase"])
        if rows is not None:
            cidx = rows.plan.take_cols(cidx, self.rank)
            tslot = rows.plan.take(tslot, self.rank)
            os_id = rows.plan.take(os_id, self.rank)
        self.cidx = torch.as_tensor(cidx, device=self.device,
                                    dtype=torch.long)
        self.tslot = torch.as_tensor(tslot, device=self.device,
                                     dtype=torch.long)
        self.n = meta["n_stations"]
        mode = effective_solver_mode(int(cfg.solver_mode), self.n)
        # -b 1: the joint solve runs without its refine; the channel
        # solves are the LBFGS fits (solve_channels)
        self.base_cfg = sage.SageConfig(
            max_emiter=cfg.max_em_iter, max_iter=cfg.max_iter,
            max_lbfgs=0 if cfg.per_channel_bfgs else cfg.max_lbfgs,
            lbfgs_m=cfg.lbfgs_m, solver_mode=mode,
            nulow=cfg.robust_nulow, nuhigh=cfg.robust_nuhigh,
            randomize=cfg.randomize, linsolv=cfg.linsolv,
            inner=cfg.solver_inner,
            kernel=cfg.solver_kernel,
            jones_mode=cfg.jones_mode, nbase=int(meta["nbase"]),
            inflight=max(1, int(cfg.cluster_inflight)),
            dtype_policy=cfg.dtype_policy, rows=rows)
        # ordered-subsets partition of the [tilesz, nbase] rows for the
        # OS modes 0/2/3 (the other modes ignore it)
        self.os_info = (os_id, n_sub)
        self.boost = first_tile_boost(self.n)
        # the assembly route, from one visit's shapes (every cluster's
        # solve carries kmax chunks), as each solve picks it
        self.route = lm_mod.route_name(
            cfg.solver_kernel, self.kmax, int(meta["nbase"]),
            int(meta["tilesz"]) * int(meta["nbase"]) if rows is None
            else rows.plan.rows_per_rank)
        # --tile-batch: T > 1 solves T staged tiles as one lane-batched
        # solve; 0 or below solves tile by tile, as in the JAX CLI. -b 1
        # re-solves per channel and --shard-baselines solves its rows
        # over ranks: both run tile by tile, as there
        self.tile_batch = max(1, int(cfg.tile_batch))
        if self.tile_batch > 1 and (cfg.per_channel_bfgs
                                    or cfg.shard_baselines):
            log("tile-batch disabled (per-channel/sharded path); "
                "running sequentially")
            self.tile_batch = 1
        self.sub_mask = sky.subtract_mask()
        self.correct_idx = skymodel.correct_cluster_index(
            sky, cfg.correct_cluster, warn=log)

    def local(self, tile: ds.VisTile) -> ds.VisTile:
        """This rank's rows of ``tile`` (``parallel.RowPlan.local_tile``),
        the tile itself without a row group."""
        if self.rows is None:
            return tile
        return self.rows.plan.local_tile(tile, self.rank)

    def gather(self, res):
        """A rank's residual rows [Bl, F, 2, 2] (complex128 numpy) -> the
        tile's [B, F, 2, 2] on rank 0 (``distributed.gather_to_root``;
        padding dropped), None on the others; ``res`` itself without a
        row group."""
        if self.rows is None:
            return res
        allr = dist.gather_to_root(torch.view_as_real(torch.from_numpy(
            np.ascontiguousarray(res))), self.rows.group)
        if allr is None:
            return None
        return torch.view_as_complex(allr).numpy()[:self.rows.n_rows]

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=self.rdt if dtype is None else dtype)

    def _precess_sources(self, log=print) -> None:
        """J2000 -> the epoch of the first tile's mid timeslot, for the
        device sky's (ra, dec) and the beam pointing (``_precess_sources``
        of the JAX package; data.cpp:1473), in the run's dtype."""
        import dataclasses
        try:
            tj = self.ms.read_tile(0).time_jd
        except Exception:
            return      # the placeholder-epoch warning comes per tile
        jd = float(np.asarray(tj)[len(np.asarray(tj)) // 2])
        pmat = coords.precession_matrix(jd, self.rdt, self.device)
        ra_p, dec_p = coords.precess_radec_std(self.dsky.ra, self.dsky.dec,
                                               pmat)
        self.dsky = self.dsky._replace(ra=ra_p, dec=dec_p)
        b_ra, b_dec = coords.precess_radec_std(
            self._t(self.beam_info.ra0), self._t(self.beam_info.dec0), pmat)
        self.beam_info = dataclasses.replace(
            self.beam_info, ra0=float(b_ra), dec0=float(b_dec))
        self.precessed = True
        log(f"Precessed source/beam coordinates to JD {jd:.5f}")

    def _tile_beam(self, tile):
        """A tile's beam tables (its own times), or None without -B."""
        if not self.dobeam:
            return None
        if tile.time_mjd is None and not self._warned_no_times:
            self.log("WARNING: dataset tiles carry no timestamps; beam "
                     "az/el will be evaluated at the J2000 placeholder epoch")
            self._warned_no_times = True
        return bm.beam_to_device(self.beam_info, self.meta["freq0"],
                                 self.rdt, time_jd=tile.time_jd,
                                 device=self.device)

    def _beam_kw(self, beam) -> dict:
        """The predict's beam arguments for a tile's beam tables ({}
        without -B); the rows' stations go with them."""
        if beam is None:
            return {}
        return dict(beam=beam, dobeam=self.dobeam, tslot=self.tslot)

    def stage(self, tile: ds.VisTile) -> dict:
        """Host tile -> device tensors for the solve and the residual
        (the beam tables too under -B). The solve input goes through the
        tile packer when the tile has per-channel flags or a taper is
        set (``VisTile.solve_input``)."""
        x8_np, rowflags, _ = tile.solve_input(uvtaper_m=self.cfg.uvtaper)
        u, v, w = self._t(tile.u), self._t(tile.v), self._t(tile.w)
        flags = rp.uvcut_flags(self._t(rowflags, torch.int32), u, v,
                               self._t(tile.freqs), self.cfg.uvmin,
                               self.cfg.uvmax)
        x8 = dtypes.storage_tensor(x8_np, self.cfg.dtype_policy, self.rdt,
                                   self.device)
        if self.cfg.whiten:
            # -W 1: uv-density whitening of the solve input only
            x8 = rb.whiten_data(x8, u, v, self.meta["freq0"])
        return dict(u=u, v=v, w=w, x8=x8, flags=flags,
                    wt=lm_mod.make_weights(flags, self.sdt),
                    sta1=self._t(tile.sta1, torch.long),
                    sta2=self._t(tile.sta2, torch.long),
                    beam=self._tile_beam(tile))

    def solve(self, stg: dict, J0: np.ndarray, tile_idx: int, boost: int,
              warm: bool = False):
        """One solve interval: solve coherencies, then SAGE-EM with the
        EM budget multiplied by ``boost``; ``warm`` when J0 comes from the
        previous tile (no cold first-sweep group width). Returns (J
        numpy, info)."""
        meta = self.meta
        coh = rp.coherencies(self.dsky, stg["u"], stg["v"], stg["w"],
                             [meta["freq0"]], meta["fdelta"],
                             sta1=stg["sta1"], sta2=stg["sta2"],
                             **self._beam_kw(stg["beam"]))[:, :, 0]
        cdt = devmod.complex_dtype(self.rdt)
        J0t = torch.as_tensor(J0, device=self.device).to(cdt)
        scfg = self.base_cfg._replace(
            max_emiter=self.base_cfg.max_emiter * boost, inflight_warm=warm)
        J, info = sage.sagefit_host(
            stg["x8"], coh, stg["sta1"], stg["sta2"], self.cidx, self.cmask,
            J0t, self.n, stg["wt"], config=scfg, seed=199 * 1000 + tile_idx,
            os_id=self.os_info)
        return J.cpu().numpy().astype(np.complex128), info

    def solve_tiles(self, stgs, J0: np.ndarray, tile_ids):
        """T staged tiles as one lane-batched solve (``_build_tiles_solver``
        of the JAX package): each tile's solve coherencies, then
        ``sage.sagefit_host_tiles`` with every tile warm-started from
        ``J0`` (the batch's warm start), its sequential seed, no boost and
        no cold first-sweep group width; under -B each tile predicts with
        its own beam tables (its gmst track: the JAX package's stacked
        ``beamT``). Returns (J [T] numpy, info)."""
        meta = self.meta
        coh = torch.stack([
            rp.coherencies(self.dsky, s["u"], s["v"], s["w"],
                           [meta["freq0"]], meta["fdelta"],
                           sta1=s["sta1"], sta2=s["sta2"],
                           **self._beam_kw(s["beam"]))[:, :, 0]
            for s in stgs])
        cdt = devmod.complex_dtype(self.rdt)
        J0t = torch.as_tensor(J0, device=self.device).to(cdt)
        J, info = sage.sagefit_host_tiles(
            torch.stack([s["x8"] for s in stgs]), coh, stgs[0]["sta1"],
            stgs[0]["sta2"], self.cidx, self.cmask,
            J0t.expand((len(stgs),) + J0t.shape).contiguous(), self.n,
            torch.stack([s["wt"] for s in stgs]),
            config=self.base_cfg._replace(inflight_warm=True),
            seeds=[199 * 1000 + ti for ti in tile_ids], os_id=self.os_info)
        return J.cpu().numpy().astype(np.complex128), info

    def residuals(self, J: np.ndarray, tile: ds.VisTile, stg: dict):
        """[B, F, 2, 2] complex128 residual of every channel. Under a
        reduced policy the data enter in the storage dtype and the
        residual is emitted in it (``residual_writeback``), as the JAX
        package stages and writes them."""
        meta = self.meta
        cdt = devmod.complex_dtype(self.rdt)
        if dtypes.is_reduced(self.sdt):
            x = utils.r2c(dtypes.storage_tensor(
                utils.c2r(tile.x), self.cfg.dtype_policy, self.rdt,
                self.device))
        else:
            x = torch.as_tensor(tile.x, device=self.device).to(cdt)
        res = rr.calculate_residuals_multifreq(
            self.dsky, torch.as_tensor(J, device=self.device).to(cdt), x,
            stg["u"], stg["v"], stg["w"], meta["freqs"],
            meta["fdelta"] / len(meta["freqs"]), stg["sta1"], stg["sta2"],
            self.cidx, self.sub_mask, correct_idx=self.correct_idx,
            rho=self.cfg.mmse_rho, phase_only=self.cfg.phase_only,
            **self._beam_kw(stg["beam"]))
        return utils.r2c(rr.residual_writeback(res, self.sdt).to(
            "cpu", torch.float64).numpy()).astype(np.complex128)

    def solve_channels(self, J0: np.ndarray, tile: ds.VisTile, stg: dict,
                       write_residuals: bool):
        """``-b 1`` (``_step_per_channel`` of the JAX package;
        fullbatch_mode.cpp:442-488): every channel solved by an LBFGS-only
        joint fit (``sage.bfgsfit``, ``-l`` iterations, the Student's-t
        cost at nu = ``-L`` in the robust modes), each warm-started from
        the same joint solution ``J0``. A channel's data has its flagged
        rows and the rows its per-channel flags mark zeroed, and those
        rows weigh nothing in its solve (their written residual is minus
        the model); under ``-W 1`` it is whitened at ``freq0``.

        One coherency call of all F channels (per-channel flux, the
        channel bandwidth) serves every channel's solve and residual:
        channel f's coherencies are that call's slice f, which is what
        the JAX package predicts for channel f alone. The channels solve
        one after another (the JAX package vmaps them; a lane whose line
        search has ended is frozen there, so each channel's result is
        its solo solve's).

        Returns (the last channel's J as numpy, which the run carries and
        writes; per-channel records of res_0, res_1 and lbfgs_iters; the
        [B, F, 2, 2] complex128 residual of every channel, or None when
        ``write_residuals`` is off)."""
        meta = self.meta
        F = len(tile.freqs)
        fdelta_chan = meta["fdelta"] / len(meta["freqs"])
        coh = rp.coherencies(self.dsky, stg["u"], stg["v"], stg["w"],
                             meta["freqs"], fdelta_chan,
                             per_channel_flux=True, sta1=stg["sta1"],
                             sta2=stg["sta2"], **self._beam_kw(stg["beam"]))
        cdt = devmod.complex_dtype(self.rdt)
        J0t = torch.as_tensor(J0, device=self.device).to(cdt)
        scfg = self.base_cfg._replace(max_lbfgs=self.cfg.max_lbfgs)
        bad = (stg["flags"] == 1).cpu().numpy()
        if write_residuals and dtypes.is_reduced(self.sdt) \
                and not getattr(self, "_warned_b1_dtype", False):
            # as in the JAX package: the channels' residuals are made
            # from the data at the pipeline dtype
            self._warned_b1_dtype = True
            unmelted = tile.x.shape[0] * F * 8 * (
                self.rdt.itemsize - self.sdt.itemsize)
            self.log(
                f"dtype-policy {self.cfg.dtype_policy}: the -b 1 "
                "per-channel residual assembly is host-side numpy "
                "(no bf16/f16) and stays at the pipeline dtype — "
                f"~{unmelted / 1e6:.1f} MB/tile of residual "
                "traffic is NOT melted by the storage policy")
        J, chans, res = None, [], []
        for f in range(F):
            xc = np.array(tile.x[:, f])
            bad_f = bad if tile.cflags is None else \
                bad | (tile.cflags[:, f] != 0)
            xc[bad_f] = 0.0
            x8 = self._t(utils.vis_to_x8(xc))
            if self.cfg.whiten:
                x8 = rb.whiten_data(x8, stg["u"], stg["v"], meta["freq0"])
            # the row weights exclude the flagged rows; a channel's
            # flagged rows weigh nothing in its solve
            wt = stg["wt"] if tile.cflags is None else \
                stg["wt"] * self._t(~bad_f, stg["wt"].dtype)[:, None]
            J, info = sage.bfgsfit(x8, coh[:, :, f].contiguous(),
                                   stg["sta1"], stg["sta2"], self.cidx, J0t,
                                   self.n, wt, config=scfg,
                                   nu=self.cfg.robust_nulow)
            chans.append(info)
            if write_residuals:
                r = rr.residual_from_coherencies(
                    coh[:, :, f:f + 1], J,
                    torch.as_tensor(xc[:, None], device=self.device).to(cdt),
                    stg["sta1"], stg["sta2"], self.cidx, self.sub_mask,
                    correct_idx=self.correct_idx, rho=self.cfg.mmse_rho,
                    phase_only=self.cfg.phase_only)
                res.append(r[:, 0].cpu().numpy().astype(np.complex128))
        return (J.cpu().numpy().astype(np.complex128), chans,
                np.stack(res, axis=1) if write_residuals else None)

    def run_simulation(self, log=None):
        """Simulation modes ``-a 1/2/3`` (``run_simulation`` of the JAX
        package; fullbatch_mode.cpp:524-578): every tile's model replaces
        (1), is added to (2) or subtracted from (3) its data, and lands in
        the output column. With ``-p`` the model is corrupted by the
        file's solutions (tile ti takes interval min(ti, count - 1)) and
        ``-z`` leaves its clusters out; without ``-p``, ``-z`` does
        nothing, as in the JAX package. Returns one record a tile (its
        seconds and kernel launches)."""
        log = self.log if log is None else log
        if self.rows is not None:
            raise ValueError("the simulation modes run unsharded (-a leaves "
                             "--shard-baselines inert, as in the JAX CLI)")
        cfg, ms, sky, meta = self.cfg, self.ms, self.sky, self.meta
        blocks, ignore_mask = None, None
        if cfg.solutions_file:
            _, blocks = sol.read_solutions(cfg.solutions_file, sky.nchunk)
            if cfg.ignore_clusters_file:
                ignore = skymodel.read_ignore_list(cfg.ignore_clusters_file)
                ignore_mask = np.array(
                    [int(cid) not in ignore for cid in sky.cluster_ids])
        cdt = devmod.complex_dtype(self.rdt)
        history = []
        for ti in range(ms.n_tiles):
            c0 = _counters()
            t0 = time.time()
            tile = ms.read_tile(ti)
            J = None
            if blocks:
                J = torch.as_tensor(blocks[min(ti, len(blocks) - 1)],
                                    device=self.device).to(cdt)
            out = rr.simulate_visibilities(
                self.dsky, torch.as_tensor(tile.x, device=self.device).to(
                    cdt), self._t(tile.u), self._t(tile.v), self._t(tile.w),
                meta["freqs"], meta["fdelta"] / len(meta["freqs"]),
                self._t(tile.sta1, torch.long),
                self._t(tile.sta2, torch.long), mode=int(cfg.simulation),
                J=J, chunk_idx=self.cidx, ignore_mask=ignore_mask,
                **self._beam_kw(self._tile_beam(tile)))
            tile.x = out.cpu().numpy().astype(np.complex128)
            ms.write_tile(ti, tile)
            log(f"Timeslot: {ti} simulated (mode={int(cfg.simulation)})")
            history.append({"tile": ti, "seconds": time.time() - t0,
                            "launches": dict(zip(
                                ("coh", "sweep", "matvec", "visits"),
                                [b - a for a, b in
                                 zip(c0, _counters())][:4]))})
        return history

    def _inflight_downgrade(self, log=print) -> None:
        """Divergence guard for ``--inflight`` (``pipeline.
        _inflight_downgrade``): a divergence reset with cluster groups
        active is taken as group overcorrection, and the run falls back to
        sequential cluster updates (G = 1) for every remaining tile.
        Sticky; the caller skips it for a res_1 == 0 reset (flagged
        data)."""
        if self.base_cfg.inflight <= 1:
            return
        log("inflight downgrade: divergence reset with cluster groups "
            "active; falling back to sequential updates (G=1)")
        self.base_cfg = self.base_cfg._replace(inflight=1)

    def initial_jones(self) -> np.ndarray:
        """The run's start and divergence-reset target: identity Jones, or
        the ``-q`` file's last interval (``sol.read_warm_start``)."""
        if self.cfg.init_solutions:
            Jq = sol.read_warm_start(self.cfg.init_solutions, self.sky,
                                     self.n)
            if Jq is not None:
                return Jq
        return np.tile(np.eye(2, dtype=np.complex128),
                       (self.sky.n_clusters, self.kmax, self.n, 1, 1))

    def run(self, write_residuals: bool = True, solution_path=None,
            max_tiles=None, log=None):
        """Solve every tile in order; returns the per-tile history.

        With ``--tile-batch T`` > 1 (``pipeline._run_batched`` of the JAX
        package): tile 0, and every tile re-armed by a divergence reset,
        solves alone with the boost; the tiles after it are staged T at a
        time and solve as one lane-batched solve (:meth:`solve_tiles`),
        each warm-started from the solution carried into the batch; a
        short tail solves tile by tile. Resets, the in-flight downgrade,
        the solutions and the residuals then follow tile by tile in
        order, as on the sequential path. A batch's solve launches and
        XLA solves are counted on its first tile's record, and every
        record of a batch carries the batch's ``batch`` entry (its tiles,
        EM, refine and solve seconds).

        The tile-by-tile loop checkpoints every tile boundary beside the
        solutions file (``TileStepper`` of the JAX package): after the
        tile's solution and residual writes, the sidecar
        (``sol.checkpoint_path``) holds the warm-start J in full
        precision, ``first``, ``res_prev``, the in-flight width (a
        sticky downgrade) and the solutions file's byte length; a clean
        end removes it. With ``--resume`` the run truncates the solutions
        file back to that length (refusing a shorter file), restores the
        state and skips the completed tiles; the tile draws depend only
        on the tile index (``solve``'s seed), so the resumed run is the
        uninterrupted one. The ``--tile-batch`` loop's warm start is
        batch-granular: it writes no checkpoint and starts fresh.

        With a row group every rank solves every tile on its own rows and
        reads the checkpoint; rank 0 alone writes the solutions, the
        residual column (every rank's rows, :meth:`gather`) and the
        checkpoint. Each record then also carries the world, this rank,
        the timeslot blocks, the data backend, the tile's row-sum
        collectives and bytes (``parallel.counters``), the SHA-256 of the
        solutions it carries on (``solution_sha``: the same on every
        rank), the rank's peak device bytes on a card and ``wrote``, what
        the rank wrote."""
        log = self.log if log is None else log
        ms, sky, meta = self.ms, self.sky, self.meta
        n_tiles = ms.n_tiles if not max_tiles else min(ms.n_tiles,
                                                       int(max_tiles))
        pinit = self.initial_jones()
        state = {"J": pinit.copy(), "first": True, "res_prev": None}
        ckpt_meta = dict(n_tiles=int(n_tiles), n_stations=int(self.n),
                         n_clusters=int(sky.n_clusters), kmax=int(self.kmax),
                         tilesz=int(meta["tilesz"]))
        ckpt_path = sol.checkpoint_path(solution_path) \
            if solution_path and self.tile_batch == 1 else None
        ck = None
        if self.cfg.resume and self.tile_batch > 1:
            log("resume: unsupported on the --tile-batch driver; "
                "starting fresh")
        elif self.cfg.resume and ckpt_path is None:
            log("resume: no solutions file -> no checkpoint; starting "
                "fresh")
        elif self.cfg.resume:
            ck = sol.load_checkpoint(ckpt_path, expect_meta=ckpt_meta)
            if ck is None:
                log("resume: no checkpoint found; starting fresh")
        writer = None
        root = self.rank == 0
        if solution_path and ck is not None and root:
            # a kill can fall between a solution write and its
            # checkpoint: back to the checkpointed byte length, then append
            size = os.path.getsize(solution_path)
            if size < ck["sol_bytes"]:
                raise ValueError(
                    f"resume: {solution_path!r} is shorter ({size} B) "
                    f"than its checkpoint watermark ({ck['sol_bytes']} B); "
                    "refusing to resume from inconsistent state")
            with open(solution_path, "r+") as f:
                f.truncate(ck["sol_bytes"])
            writer = sol.SolutionWriter.open_resume(solution_path, self.n)
        elif solution_path and root:
            writer = sol.SolutionWriter(
                solution_path, meta["freq0"], meta["fdelta"],
                meta["tilesz"] * meta["tdelta"] / 60.0, self.n,
                sky.n_clusters, sky.n_eff_clusters)
        start = 0
        if ck is not None:
            start = ck["tile"] + 1
            state.update(J=ck["J"], first=ck["first"],
                         res_prev=ck["res_prev"])
            if ck["inflight"] < self.base_cfg.inflight:
                self._inflight_downgrade(log)
            log(f"resume: checkpoint at tile {ck['tile']}; skipping "
                f"{start}/{n_tiles} completed tiles")
        history = []

        def post(item, Jnew, info, t, launches, secs, batch=None):
            """A solved tile in order: the divergence reset, the solution,
            the residual write-back and the record (``post`` of the JAX
            package's ``_run_batched``); ``info`` the solve's, ``t`` the
            tile's index in it (None for a solo solve's scalars)."""
            ti, tile, stg = item["ti"], item["tile"], item["stg"]

            def of(key):
                return info[key] if t is None else info[key][t]

            res_0, res_1 = float(of("res_0")), float(of("res_1"))
            mean_nu = float(of("mean_nu"))
            if res_1 == 0.0 or not np.isfinite(res_1) or (
                    state["res_prev"] is not None
                    and res_1 > RES_RATIO * state["res_prev"]):
                log(f"tile {ti}: Resetting Solution")
                if res_1 != 0.0:   # zero = flagged data
                    self._inflight_downgrade(log)
                state.update(J=pinit.copy(), first=True,
                             res_prev=res_1 if np.isfinite(res_1) else None)
            else:
                state["J"] = Jnew
                state["res_prev"] = (res_1 if state["res_prev"] is None
                                     else min(state["res_prev"], res_1))
            c0 = _counters()
            t_res = time.time()
            chans = None
            wrote = []
            if self.cfg.per_channel_bfgs:
                # -b 1: the channel solves from the joint solution, their
                # residuals; the last channel's solutions are carried
                state["J"], chans, res = self.solve_channels(
                    state["J"], item["ltile"], stg, write_residuals)
            if writer:
                writer.write_interval(state["J"], sky.nchunk)
                wrote.append(solution_path)
            if write_residuals:
                res = self.gather(
                    res if chans is not None else
                    self.residuals(state["J"], item["ltile"], stg))
                t_write = time.time()
                if root:
                    tile.x = res
                    ms.write_tile(ti, tile)
                    wrote.append(f"{getattr(ms, 'path', 'dataset')}:"
                                 f"tile{ti}")
            t1 = time.time()
            # under -b 1 residual_s holds the channel solves too
            secs = dict(secs, read_s=item["read_s"],
                        residual_s=(t_write - t_res
                                    if write_residuals else 0.0),
                        write_s=t1 - t_write if write_residuals else 0.0)
            launches = [a + b - c for a, b, c in
                        zip(launches, _counters(), c0)]
            dt = sum(secs[k] for k in ("read_s", "solve_s", "residual_s",
                                       "write_s")) / 60.0
            log(f"Timeslot: {ti} Residual: initial={res_0:.6g}, "
                f"final={res_1:.6g}, Time spent={dt:.3g} minutes, "
                f"nu={mean_nu:.2f}")
            rec = {"tile": ti, "res_0": res_0, "res_1": res_1,
                   "mean_nu": mean_nu, "minutes": dt,
                   **{k: int(of(k)) for k in lm_mod.TRIP_KEYS},
                   "tcg_iters": int(of("tcg_iters")),
                   "groups": of("groups"),
                   "launches": dict(zip(("coh", "sweep", "matvec",
                                         "visits"), launches[:4])),
                   "xla_solves": launches[4], "batch": batch,
                   "channels": chans, **secs}
            if self.rows is not None:
                rec.update(world=self.rows.world, rank=self.rank,
                           blocks=self.rows.plan.blocks(),
                           backend=self.rows.group.backend,
                           row_sums=item["row_sums"], wrote=wrote,
                           solution_sha=hashlib.sha256(np.ascontiguousarray(
                               state["J"]).tobytes()).hexdigest(),
                           peak_bytes=torch.cuda.max_memory_allocated(
                               self.device)
                           if self.device.type == "cuda" else None)
            history.append(rec)
            if self.cfg.verbose:
                log(f"Timeslot: {ti} stats: " + json.dumps(
                    {k: rec[k] for k in ("solver_iters", "cg_iters",
                                         "tcg_iters", "lbfgs_iters",
                                         "rejected_groups", "mean_nu",
                                         "launches", "xla_solves", "batch",
                                         "channels", *secs)}))
            if writer and ckpt_path:
                # this tile boundary, after its writes
                wrote.append(ckpt_path)
                sol.save_checkpoint(
                    ckpt_path, tile=ti, J=state["J"].copy(),
                    first=state["first"], res_prev=state["res_prev"],
                    inflight=int(self.base_cfg.inflight),
                    sol_bytes=writer.f.tell(), meta=ckpt_meta)

        def solo(item, boosted: bool):
            c0 = _counters()
            t0 = time.time()
            rs0 = parallel.counters()
            Jnew, info = self.solve(item["stg"], state["J"], item["ti"],
                                    self.boost if boosted else 1,
                                    warm=not boosted)
            item["row_sums"] = parallel.counters_since(rs0)
            state["first"] = False
            post(item, Jnew, info, None,
                 [b - a for a, b in zip(c0, _counters())],
                 {"solve_s": time.time() - t0, "em_s": info["em_s"],
                  "refine_s": info["refine_s"]})

        def flush(group):
            if len(group) < self.tile_batch:
                # the stream's short tail: tile by tile, warm
                for item in group:
                    solo(item, boosted=False)
                return
            c0 = _counters()
            t0 = time.time()
            Jnew, info = self.solve_tiles([g["stg"] for g in group],
                                          state["J"],
                                          [g["ti"] for g in group])
            solve_s = time.time() - t0
            n = len(group)
            batch = {"tiles": [g["ti"] for g in group],
                     "em_s": info["em_s"], "refine_s": info["refine_s"],
                     "solve_s": solve_s}
            launches = [b - a for a, b in zip(c0, _counters())]
            for t, item in enumerate(group):
                post(item, Jnew[t], info, t,
                     launches if t == 0 else [0] * len(launches),
                     {"solve_s": solve_s / n, "em_s": info["em_s"] / n,
                      "refine_s": info["refine_tiles_s"][t]}, batch)

        pending = []
        try:
            for ti in range(start, n_tiles):
                t0 = time.time()
                if self.cfg.verbose:
                    log(f"tile {ti}: solver route: {self.route}")
                tile = ms.read_tile(ti)
                ltile = self.local(tile)
                item = {"ti": ti, "tile": tile, "ltile": ltile,
                        "stg": self.stage(ltile)}
                item["read_s"] = time.time() - t0
                if self.tile_batch == 1 or state["first"]:
                    solo(item, boosted=state["first"])
                    continue
                pending.append(item)
                if len(pending) == self.tile_batch:
                    flush(pending)
                    pending = []
            flush(pending)
        finally:
            if writer:
                writer.close()
        if ckpt_path and root and os.path.exists(ckpt_path):
            os.remove(ckpt_path)      # a clean end
        return history


def _counters():
    """The kernel launch counters (coh, sweep, matvec, visits) and the
    XLA-route solves, read on the host."""
    return (coh_ops.LAUNCHES, swp.LAUNCHES, swp.MATVEC_LAUNCHES,
            swp.VISITS_LAUNCHES, lm_mod.XLA_SOLVES)


def _quiet(*_):
    """The log of a rank other than 0: it prints nothing."""


def run(cfg: RunConfig, device=None, log=print, group=None):
    """Open the dataset and the sky model and run full-batch
    calibration, or with ``-a`` the simulation, on ``device`` (None:
    CUDA, raising without a card).

    ``group`` (a joined ``distributed.Group``, ``--shard-baselines`` over
    ranks: ``parallel.run_sharded``) solves every tile's rows over its
    ranks on ``group.device`` (:class:`FullBatchPipeline`, ``rows``):
    rank 0 logs and writes, the others only compute."""
    check_supported(cfg)
    dev = devmod.resolve(device if group is None else group.device)
    ms = ds.open_dataset(cfg.ms, cfg.ms_list, tilesz=cfg.tile_size,
                         data_column=cfg.input_column,
                         out_column=cfg.output_column)
    meta = ms.meta
    sky = skymodel.read_sky_cluster(cfg.sky_model, cfg.cluster_file,
                                    meta["ra0"], meta["dec0"], meta["freq0"],
                                    cfg.format_3)
    rows = None
    if group is not None:
        rows = parallel.RowGroup(group, parallel.RowPlan(
            int(meta["tilesz"]), int(meta["nbase"]), group.world))
        if group.rank != 0:
            log = _quiet
        log(f"Shard baselines: {group.world} ranks of "
            f"{rows.plan.tper} timeslots ({rows.plan.rows_per_rank} rows) "
            f"each, timeslot blocks {rows.plan.blocks()}; data collectives "
            f"over {group.backend} ({group.reason})")
    pipe = FullBatchPipeline(cfg, ms, sky, device=dev, log=log, rows=rows)
    if cfg.simulation != SimulationMode.OFF:
        return pipe.run_simulation(log=log)
    packs = native.PACKS
    hist = pipe.run(solution_path=cfg.solutions_file,
                    max_tiles=cfg.max_timeslots or None, log=log)
    if native.PACKS > packs:
        log(f"tile packer: native ({native.LIB_PATH}), "
            f"{native.PACKS - packs} tiles")
    return hist
