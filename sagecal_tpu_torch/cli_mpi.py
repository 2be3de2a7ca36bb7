"""``sagecal-tpu-torch-mpi``: consensus calibration across subbands on one
card (port of ``sagecal_tpu/cli_mpi.py``; reference ``sagecal-mpi``,
``src/MPI/main.cpp``).

One invocation calibrates F frequency-subband datasets jointly with
consensus ADMM and a smooth polynomial-in-frequency prior
(``consensus/admm.py``). The JAX CLI runs the subbands over a device
mesh; on one card its mesh has one device, which is the plan here: every
subband solves on the card, one after another, and the consensus sums
over subbands are local.

The parser takes exactly the JAX CLI's flags. Runs: ``-f -s -c -p -F -t
-e -g -l -m -x -y -n -R -W -k -o -J -q -B -j -L -H -A -P -Q -r -G -C -T
-K -U --mdl -N -M -w -u -X -V -I -O --inflight --dtype-policy --inner
--kernel --block-f --staleness --time-shard --faults`` and ``--platform``.
The execution plans of the JAX CLI:

- ``-N > 0``: federated stochastic calibration (``federated.py``, the
  slaves in turn), with the ``RunConfig`` the JAX route builds; every flag
  that route does not read is inert (``-j``, ``-B``, ``--dtype-policy``,
  ``--inflight``, ``--block-f``, ...), and ``-x``/``-y`` print the JAX
  CLI's warning. ``-N`` with ``--num-processes > 1`` is a parser error;
- ``--block-f N``: the J-updates in blocks of N subbands
  (``admm.make_admm_runner_blocked``; prints the ADMM wall-clock per
  iteration);
- ``--staleness S``: bounded-staleness consensus
  (``admm.make_admm_runner_stale``), its stragglers drawn from a
  ``--faults`` plan's ``admm_subband_slow`` rules;
- ``--time-shard T``: the solution intervals in T time shards
  (``admm.make_admm_runner_2d``; every selected interval read up front,
  the shards in turn).

They are exclusive, and each is with ``--host-loop`` (:func:`check_plans`,
the JAX CLI's refusals: ``--time-shard 1``, ``--time-shard`` with ``-B``,
``-X`` or ``--mdl``, ``--staleness`` with ``-B``, ``-X`` or ``-C 1``,
``--block-f`` below 1 or with ``-X``). ``--faults`` takes plans whose
rules name only ``admm_subband_slow`` (:func:`install_faults`).
``--jones diag|phase`` raises ``ValueError`` as in the JAX CLI (the
consensus vectors are full-Jones parameters). ``--host-loop`` (otherwise
the port's only plan), ``--mesh-devices`` and ``--prefetch 1`` are
no-ops. ``--coordinator``, ``--num-processes`` above 1,
``--process-id``, ``--cpu-devices``, ``--prior-cache``, ``--diag``,
``--metrics`` and ``--prefetch`` other than 1 raise
``NotImplementedError`` naming their ROADMAP item (:data:`UNPORTED`);
under ``-N``, whose route reads neither, ``--prefetch`` and
``--prior-cache`` are inert.

``--platform cpu`` runs on the CPU in float64; without it the run needs
a CUDA device (float32). ``--kernel`` defaults to ``pallas`` (the fused
sweep where it fits), as in the port's full-batch CLI; the JAX CLI's
default is ``xla``.

Per solve interval: iteration 0 solves every subband plainly, the duals
are seeded and manifold-averaged, then each ADMM iteration solves the
augmented problem per subband and updates Z (``-P`` terms of type ``-Q``,
``-r`` rho or the ``-G`` file's, Barzilai-Borwein with ``-C 1``, the
spatial prior with ``-X`` and ``-u``). A subband whose final residual is
0, non-finite or above 5 x its initial one restarts the next interval
from the initial Jones. Residuals are written per subband with its own
solutions (``-U 1``: the consensus polynomial at its frequency); the Z
file goes to ``-p`` and every subband's J to ``<dataset>.solutions``;
with ``-X`` and ``-p``, the spatial model to ``spatial_<solutions>``.
"""

from __future__ import annotations

import argparse
import glob as globmod
import os
import sys
import time

import numpy as np
import torch

from sagecal_tpu_torch import device as devmod
from sagecal_tpu_torch import dtypes, pipeline, skymodel, utils
from sagecal_tpu_torch.config import SolverMode
from sagecal_tpu_torch.consensus import admm as cadmm
from sagecal_tpu_torch.consensus import mdl as mdlmod
from sagecal_tpu_torch.io import solutions as sol

#: flags parsed for parity but not ported: dest -> (default, ROADMAP item)
UNPORTED = {
    "coordinator": (None, "queue A item 9e (multi-card ADMM)"),
    "num_processes": (1, "queue A item 9e (multi-card ADMM)"),
    "process_id": (0, "queue A item 9e (multi-card ADMM)"),
    "cpu_devices": (0, "queue A item 9e (--cpu-devices)"),
    "prefetch": (1, "queue A item 10 (--prefetch overlap)"),
    "diag": (None, "queue A item 10 (--diag)"),
    "metrics": (None, "queue A item 10 (--metrics)"),
    "prior_cache": ("off", "queue A item 11 (--prior-cache)"),
}

#: UNPORTED flags that the -N route does not read (inert under -N)
INERT_UNDER_N = ("prefetch", "prior_cache")

#: the fault points the MPI CLI's --faults may name: the straggler draw of
#: the bounded-staleness runner
FAULT_POINTS = ("admm_subband_slow",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sagecal-tpu-torch-mpi",
        description="consensus-ADMM calibration over subbands on "
                    "PyTorch/CUDA (port of sagecal-tpu-mpi)")
    a = p.add_argument
    a("-f", "--ms-pattern", required=True,
      help="glob pattern or file listing the subband datasets")
    a("-s", "--sky-model", required=True)
    a("-c", "--cluster-file", required=True)
    a("-p", "--solutions-file", help="global Z solution file")
    a("-F", "--format", type=int, default=0)
    a("-t", "--tile-size", type=int, default=120)
    a("-e", "--max-em-iter", type=int, default=3)
    a("-g", "--max-iter", type=int, default=10)
    a("-l", "--max-lbfgs", type=int, default=10)
    a("-m", "--lbfgs-m", type=int, default=7)
    a("-x", "--uvmin", type=float, default=0.0)
    a("-y", "--uvmax", type=float, default=1e9)
    a("-n", "--n-threads", type=int, default=4,
      help="accepted for parity; host threads are PyTorch's own")
    a("-R", "--randomize", type=int, default=1)
    a("-W", "--whiten", type=int, default=0)
    a("-k", "--correct-cluster", type=int, default=None)
    a("-o", "--mmse-rho", type=float, default=1e-9)
    a("-J", "--phase-only", type=int, default=0)
    a("-q", "--init-solutions",
      help="warm-start J from this solution file (1 interval, J format)")
    a("-B", "--beam", type=int, default=0,
      help="0 none, 1 array factor, 2 array+element, 3 element")
    a("-j", "--solver-mode", type=int, default=5)
    a("-L", "--nulow", type=float, default=2.0)
    a("-H", "--nuhigh", type=float, default=30.0)
    a("-A", "--admm", type=int, default=10)
    a("-P", "--npoly", type=int, default=2)
    a("-Q", "--polytype", type=int, default=2)
    a("-r", "--rho", type=float, default=5.0)
    a("-G", "--rho-file", default=None)
    a("-C", "--adaptive-rho", type=int, default=0)
    a("--prior-cache", choices=("off", "read", "readwrite"), default="off")
    a("-T", "--max-timeslots", type=int, default=0)
    a("-K", "--skip-timeslots", type=int, default=0)
    a("-U", "--use-global-solution", type=int, default=0)
    a("--mdl", action="store_true",
      help="report the MDL/AIC consensus-polynomial order (mdl.c:42)")
    a("-N", "--epochs", type=int, default=0)
    a("-M", "--minibatches", type=int, default=1)
    a("-w", "--bands", type=int, default=1)
    a("-u", "--federated-alpha", type=float, default=0.0)
    a("-X", "--spatialreg", default=None,
      help="spatial regularization: l2,l1,order,fista_iters,cadence")
    a("-V", "--verbose", action="store_true")
    a("-I", "--input-column", default="DATA")
    a("-O", "--output-column", default="CORRECTED_DATA")
    a("--coordinator", default=None)
    a("--num-processes", type=int, default=1)
    a("--process-id", type=int, default=0)
    a("--platform", default=None,
      help="'cpu' runs on the CPU (float64); default: the CUDA device")
    a("--cpu-devices", type=int, default=0)
    a("--mesh-devices", type=int, default=0,
      help="accepted; a no-op on one card")
    a("--block-f", type=int, default=0)
    a("--time-shard", type=int, default=0, metavar="T")
    a("--staleness", type=int, default=0, metavar="S")
    a("--inflight", type=int, default=1)
    a("--dtype-policy", choices=("f32", "bf16", "f16"), default="f32")
    a("--inner", choices=("chol", "cg"), default="chol")
    a("--kernel", choices=("xla", "pallas"), default="pallas",
      help="pallas (default here): the fused-sweep CUDA kernel where it "
           "fits; xla (the JAX CLI's default): the XLA assembly")
    a("--jones", choices=("full", "diag", "phase"), default="full")
    a("--host-loop", action="store_true",
      help="accepted; the port's only plan (one host step per ADMM "
           "iteration)")
    a("--prefetch", type=int, default=1, metavar="N")
    a("--diag", default=None, metavar="PATH")
    a("--metrics", default=None, metavar="PATH")
    a("--faults", default=None, metavar="SPEC")
    return p


def discover_datasets(pattern: str) -> list:
    """A list file (one path a line) or a glob -> dataset paths
    (master :61-221)."""
    if os.path.isfile(pattern):
        with open(pattern) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
    else:
        paths = sorted(globmod.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no datasets match {pattern!r}")
    return paths


def check_flags(args) -> None:
    """``--jones`` other than full raises ``ValueError`` as in the JAX
    CLI; a non-default :data:`UNPORTED` flag ``NotImplementedError``
    (except :data:`INERT_UNDER_N` under ``-N``)."""
    if args.jones != "full":
        raise ValueError(
            f"--jones {args.jones} is not supported with consensus "
            "ADMM: the y/bz consensus vectors are full-Jones "
            "parameters. Run the fullbatch CLI (sagecal_tpu_torch.cli) "
            "for constrained-Jones solves.")
    for dest, (default, item) in UNPORTED.items():
        if args.epochs > 0 and dest in INERT_UNDER_N:
            continue
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')}={getattr(args, dest)!r} is not "
                f"ported yet (ROADMAP {item})")


def check_plans(args) -> None:
    """The JAX CLI's refusals around its execution plans
    (``sagecal_tpu/cli_mpi.py:473-519``), each a ``ValueError``:
    ``--block-f``, ``--host-loop``, ``--time-shard > 1`` and
    ``--staleness > 0`` are different plans; ``--time-shard 1`` is
    ambiguous; ``--time-shard`` refuses ``-B``, ``-X`` and ``--mdl``,
    ``--staleness`` refuses ``-B``, and ``--block-f`` must be >= 1. The
    runners refuse the rest (``-X`` with ``--block-f`` or ``--staleness``,
    ``-C 1`` with ``--staleness``). As in the JAX CLI, a negative
    ``--staleness`` or ``--time-shard`` runs the synchronous plan."""
    plans = [nm for nm, on in (("--block-f", args.block_f),
                               ("--host-loop", args.host_loop),
                               ("--time-shard", args.time_shard > 1),
                               ("--staleness", args.staleness > 0))
             if on]
    if len(plans) > 1:
        raise ValueError(f"{' and '.join(plans)} are different execution "
                         "plans; pick one")
    if args.time_shard == 1:
        raise ValueError("--time-shard 1 is ambiguous: use 0 (off, the "
                         "per-interval loop) or >= 2 time shards")
    if args.time_shard > 1:
        if args.beam:
            raise ValueError("--time-shard does not support -B beam tables "
                             "yet; use the per-interval loop")
        if args.spatialreg:
            raise ValueError("--time-shard does not support -X spatial "
                             "regularization; use the per-interval loop")
        if args.mdl:
            raise ValueError("--time-shard does not support --mdl")
    elif args.staleness > 0:
        if args.beam:
            raise ValueError("--staleness does not support -B beam tables")
    elif args.block_f and args.block_f < 1:
        raise ValueError(f"--block-f {args.block_f}: must be >= 1")


def install_faults(spec):
    """Install the ``--faults`` plan (``faults.enable_spec``: a JSON list
    of rules, ``{"seed": ..., "rules": [...]}`` or a file holding either).
    A rule naming another point than :data:`FAULT_POINTS` raises
    ``NotImplementedError``: the I/O retry seams the other points feed
    come with the host runtime (ROADMAP queue A item 10). Returns the
    plan, or None without a spec."""
    if spec is None:
        return None
    from sagecal_tpu_torch import faults
    plan = faults.enable_spec(spec)
    other = sorted({r.point for r in plan.rules} - set(FAULT_POINTS))
    if other:
        faults.disable()
        raise NotImplementedError(
            f"--faults rules at {other} are not ported yet: the MPI CLI "
            f"takes {list(FAULT_POINTS)} only (ROADMAP queue A item 10, "
            "--faults)")
    return plan


def federated_config(args, paths):
    """The ``RunConfig`` of the ``-N`` route, field for field as the JAX
    CLI builds it (``sagecal_tpu/cli_mpi.py:275-302``)."""
    from sagecal_tpu_torch.config import RunConfig
    return RunConfig(
        ms=paths[0], sky_model=args.sky_model,
        cluster_file=args.cluster_file,
        solutions_file=args.solutions_file, format_3=bool(args.format),
        n_epochs=args.epochs, n_minibatches=args.minibatches,
        channel_avg_per_band=args.bands, n_admm=args.admm,
        n_poly=args.npoly, poly_type=args.polytype, admm_rho=args.rho,
        rho_file=args.rho_file, federated_alpha=args.federated_alpha,
        use_global_solution=bool(args.use_global_solution),
        max_timeslots=args.max_timeslots,
        skip_timeslots=args.skip_timeslots, max_lbfgs=args.max_lbfgs,
        lbfgs_m=args.lbfgs_m, robust_nulow=args.nulow,
        robust_nuhigh=args.nuhigh, tile_size=args.tile_size,
        input_column=args.input_column, output_column=args.output_column,
        verbose=args.verbose)


def run_federated(args, device=None, log=print) -> list:
    """The ``-N > 0`` route (reference main.cpp:330-342): federated
    stochastic calibration of the subband datasets; returns its per-tile
    records (``federated.run_federated``)."""
    from sagecal_tpu_torch import federated
    device = devmod.resolve(device)
    if args.uvmin > 0.0 or args.uvmax < 1e9:
        print("Warning: -x/-y uv cuts are not applied in federated "
              "stochastic mode; calibrating all baselines", file=sys.stderr)
    paths = discover_datasets(args.ms_pattern)
    return federated.run_federated(federated_config(args, paths),
                                   paths, device=device, log=log)


def _iter_walls(timer) -> list:
    """Per ADMM iteration the summed seconds of a runner's ``timer``:
    each iteration ends at its consensus step ("iter0", "body[k]",
    "cons0", "cons[k]")."""
    out, acc = [], 0.0
    for label, secs in timer:
        acc += secs
        if label == "iter0" or label.startswith(("body[", "cons")):
            out.append(acc)
            acc = 0.0
    return out


class ConsensusRun:
    """The MPI CLI's consensus run: the subbands, sky, basis and runner
    (:meth:`__init__`), then :meth:`run` over the solve intervals."""

    def __init__(self, args, device=None, log=print):
        from sagecal_tpu_torch.consensus import poly as cpoly
        from sagecal_tpu_torch.io import dataset as ds
        from sagecal_tpu_torch.rime import beam as bm
        from sagecal_tpu_torch.rime import predict as rp
        from sagecal_tpu_torch.solvers import sage
        self.args, self.log = args, log
        dev = self.device = devmod.resolve(device)
        self.rdt = devmod.real_dtype(dev)
        if args.dtype_policy != "f32":
            # a reduced storage policy pairs with the float32 pipeline
            self.rdt = torch.float32
        self.sdt = dtypes.storage_dtype(args.dtype_policy, self.rdt)
        paths = discover_datasets(args.ms_pattern)
        mss = [ds.open_part(p, tilesz=args.tile_size,
                            data_column=args.input_column,
                            out_column=args.output_column) for p in paths]
        meta0 = mss[0].meta
        # metadata consistency (master :239-284)
        for msx in mss[1:]:
            if len(msx.meta["freqs"]) != len(meta0["freqs"]):
                raise ValueError(
                    f"dataset {msx.path}: channel count mismatch "
                    f'({len(msx.meta["freqs"])} vs {len(meta0["freqs"])})')
            for key in ("n_stations", "nbase", "tilesz"):
                if msx.meta[key] != meta0[key]:
                    raise ValueError(f"dataset {msx.path}: {key} mismatch "
                                     f"({msx.meta[key]} != {meta0[key]})")
        freqs = np.array([m.meta["freq0"] for m in mss])
        order = np.argsort(freqs)
        self.mss = mss = [mss[i] for i in order]
        self.freqs = freqs = freqs[order]
        self.meta0 = meta0
        self.nf = nf = len(mss)
        sky = self.sky = skymodel.read_sky_cluster(
            args.sky_model, args.cluster_file, meta0["ra0"], meta0["dec0"],
            float(freqs.mean()), bool(args.format))
        self.dobeam = int(args.beam)
        self.beam_infos = [bm.resolve_beaminfo(self.dobeam, m, m.meta,
                                               log=log) for m in mss] \
            if self.dobeam else None
        self.dsky = rp.sky_to_device(sky, self.rdt, dev) if self.dobeam \
            else rp.split_sky(sky, self.rdt, dev)
        n = self.n = meta0["n_stations"]
        kmax = self.kmax = int(sky.nchunk.max())
        self.cmask = np.arange(kmax)[None, :] < sky.nchunk[:, None]
        cidx = rp.chunk_indices(meta0["tilesz"], meta0["nbase"], sky.nchunk)
        log(f"Platform: {dev.type} (1 device(s))")
        log(f"Subbands: {nf} over 1 device(s); stations {n}, clusters "
            f"{sky.n_clusters} (Mt={sky.n_eff_clusters})")
        self.rho0 = args.rho
        if args.rho_file:
            self.rho0 = skymodel.read_cluster_rho(
                args.rho_file, sky.cluster_ids, default_rho=args.rho)
        self.Bpoly = cpoly.setup_polynomials(freqs, float(freqs.mean()),
                                             args.npoly, args.polytype)
        self.spatialreg, self.spatial_coords = None, None
        if args.spatialreg:
            from sagecal_tpu_torch.consensus import spatial as csp
            vals = [float(x) for x in args.spatialreg.split(",")]
            if len(vals) != 5:
                raise ValueError("-X needs l2,l1,order,fista_iters,cadence")
            if args.federated_alpha <= 0.0:
                raise ValueError(
                    "-X spatial regularization couples into the consensus "
                    "Z only through the -u prior strength; give -u > 0 "
                    "(master :768-775 adds alpha*Zbar - X to the Z update)")
            self.spatialreg = (vals[0], vals[1], int(vals[2]), int(vals[3]),
                               max(int(vals[4]), 1))
            self.spatial_coords = csp.cluster_polar_coords(sky)
        self.cfg = cadmm.ADMMConfig(
            n_admm=args.admm, npoly=args.npoly, poly_type=args.polytype,
            rho=self.rho0, adaptive_rho=bool(args.adaptive_rho),
            spatialreg=self.spatialreg, federated_alpha=args.federated_alpha,
            sage=sage.SageConfig(
                max_emiter=args.max_em_iter, max_iter=args.max_iter,
                max_lbfgs=args.max_lbfgs, lbfgs_m=args.lbfgs_m,
                solver_mode=int(SolverMode(args.solver_mode)),
                nulow=args.nulow, nuhigh=args.nuhigh,
                randomize=bool(args.randomize), inflight=args.inflight,
                inner=args.inner, kernel=args.kernel,
                nbase=int(meta0["nbase"]), dtype_policy=args.dtype_policy))
        t0 = mss[0].read_tile(0)
        it = lambda a: torch.as_tensor(np.asarray(a), device=dev,
                                       dtype=torch.long)
        self.sta1, self.sta2, self.cidx = it(t0.sta1), it(t0.sta2), it(cidx)
        self.tslot = it(ds.row_tslot(len(t0.sta1), meta0["nbase"]))
        self.timer: list = []
        self.groups: list = []
        common = (self.dsky, self.sta1, self.sta2, self.cidx, self.cmask, n,
                  meta0["fdelta"], self.Bpoly, self.cfg)
        run_kw = dict(device=dev, timer=self.timer, groups=self.groups)
        if args.time_shard > 1:
            # built in run(): it needs the selected interval count
            self.runner = None
        elif args.staleness > 0:
            self.runner = cadmm.make_admm_runner_stale(
                *common, nf_total=nf, staleness=args.staleness, **run_kw)
        elif args.block_f:
            self.runner = cadmm.make_admm_runner_blocked(
                *common, block_f=args.block_f, nf_total=nf,
                dobeam=self.dobeam, tslot=self.tslot, **run_kw)
        else:
            self.runner = cadmm.make_admm_runner(
                *common, nf_total=nf, spatial_coords=self.spatial_coords,
                dobeam=self.dobeam, tslot=self.tslot, **run_kw)
        self.correct_idx = skymodel.correct_cluster_index(
            sky, args.correct_cluster, warn=log)
        self.sub_mask = sky.subtract_mask()

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=self.rdt if dtype is None else dtype)

    def prep_tiles(self, tiles):
        """One interval's solve inputs from its subband tiles (``_prep_
        tiles`` of the JAX CLI): the uv window on a copy of the row
        flags, the solve input, ``-W`` whitening and each subband's
        unflagged fraction (rho's scale, master :646-650). Returns
        tensors x8F and wtF (the storage dtype), uF, vF, wF, fratioF."""
        from sagecal_tpu_torch.rime import predict as rp
        from sagecal_tpu_torch.solvers import lm as lm_mod
        from sagecal_tpu_torch.solvers import robust as rb
        args = self.args
        x8_l, wt_l, fr_l = [], [], []
        for t in tiles:
            flags = t.flags
            t.flags = rp.apply_uvcut(flags, t, args.uvmin, args.uvmax)
            try:
                x8_t, flags_t, good = t.solve_input()
            finally:
                t.flags = flags
            fr_l.append(good)
            x8_t = self._t(x8_t)
            if args.whiten:
                x8_t = rb.whiten_data(x8_t, self._t(t.u), self._t(t.v),
                                      t.freq0)
            x8_l.append(x8_t)
            wt_l.append(lm_mod.make_weights(self._t(flags_t, torch.int32),
                                            self.rdt))
        st = lambda a: dtypes.to_storage(torch.stack(a), self.sdt)
        return (st(x8_l), st(wt_l),
                *(self._t(np.stack([getattr(t, k) for t in tiles]))
                  for k in ("u", "v", "w")), self._t(np.array(fr_l)))

    def tile_beams(self, tiles):
        if not self.dobeam:
            return None
        from sagecal_tpu_torch.rime import beam as bm
        return [bm.beam_to_device(info, m.meta["freq0"], self.rdt,
                                  time_jd=t.time_jd, device=self.device)
                for info, m, t in zip(self.beam_infos, self.mss, tiles)]

    def residual(self, f, J, tile, u, v, w, beam):
        """Subband f's residual of every channel (complex128), with its
        Jones J [M, K, N, 2, 2]: the model at the subband's frequency with
        its full bandwidth (``residual_fn`` of the JAX CLI)."""
        from sagecal_tpu_torch.rime import residual as rr
        cdt = devmod.complex_dtype(self.rdt)
        if dtypes.is_reduced(self.sdt):
            x = utils.r2c(dtypes.storage_tensor(
                utils.c2r(tile.x), self.args.dtype_policy, self.rdt,
                self.device))
        else:
            x = torch.as_tensor(tile.x, device=self.device).to(cdt)
        bkw = {} if beam is None else dict(beam=beam, dobeam=self.dobeam,
                                           tslot=self.tslot)
        res = rr.calculate_residuals_multifreq(
            self.dsky, torch.as_tensor(J, device=self.device).to(cdt), x,
            u, v, w, [float(self.freqs[f])], self.meta0["fdelta"],
            self.sta1, self.sta2, self.cidx, self.sub_mask,
            correct_idx=self.correct_idx, rho=self.args.mmse_rho,
            phase_only=bool(self.args.phase_only), **bkw)
        return utils.r2c(rr.residual_writeback(res, self.sdt).to(
            "cpu", torch.float64).numpy()).astype(np.complex128)

    def _spatial_file(self):
        """The spatial model's file (``spatial_`` + the solutions file's
        name, sagecal_master.cpp:472-498) and its basis, or (None,
        None)."""
        args, sky = self.args, self.sky
        if self.spatialreg is None or not args.solutions_file:
            return None, None
        from sagecal_tpu_torch.consensus import spatial as csp
        d, b = os.path.split(args.solutions_file)
        f = open(os.path.join(d, "spatial_" + b), "w")
        rr_c, tt_c = self.spatial_coords
        f.write("# spatial regularization solution file (Zspat)\n"
                "# Top two rows are the polar coordinates of the "
                "centroids (rad)\n"
                "# reference_freq(MHz) polynomial_order(freq) "
                "polynomial_order(spatial) stations clusters "
                "effective_clusters\n")
        f.write(f"{float(self.freqs.mean()) * 1e-6:f} {args.npoly} "
                f"{int(self.spatialreg[2]) ** 2} {self.n} "
                f"{sky.n_clusters} {sky.n_eff_clusters}\n")
        f.write(" ".join(f"{x:f}" for x in np.asarray(rr_c)) + "\n")
        f.write(" ".join(f"{x:f}" for x in np.asarray(tt_c)) + "\n")
        return f, csp.phi_padded(self.cmask, *self.spatial_coords,
                                 self.spatialreg[2], self.spatialreg[0])

    def _write_spatial(self, f, phi, Z):
        """One interval's Zspat rows (the JAX CLI's format: each of the 2
        Npoly N rows its index, then 2G re/im pairs, from the FISTA prox
        of the final Z in complex64 on the host)."""
        from sagecal_tpu_torch.consensus import spatial as csp
        _l2, mu, _n0, iters, _cad = self.spatialreg
        Phi, Phikk = phi
        Zb = csp.z_r8_to_blocks(torch.as_tensor(Z)).to(torch.complex64)
        Zspat = csp.fista_spatialreg(
            Zb, torch.as_tensor(Phikk).to(torch.complex64),
            torch.as_tensor(Phi).to(torch.complex64), mu, int(iters)).numpy()
        for p in range(Zspat.shape[0]):
            f.write(f"{p} " + " ".join(f"{z.real:e} {z.imag:e}"
                                       for z in Zspat[p]) + "\n")

    def _write_interval(self, ti, tiles, uF, vF, wF, beamF, JF, Z, res0,
                        res1, duals, writers):
        """One interval's outputs (the per-interval loop's and the 2-D
        plan's): every subband's worker row, the log line, the residuals
        written back with each subband's J (``-U 1``: the consensus
        polynomial at its frequency), the spatial model and the Z row.
        Returns the residual pass's seconds."""
        args, sky, log = self.args, self.sky, self.log
        M, kmax, nf = sky.n_clusters, self.kmax, self.nf
        writer, workers, spatial_file, spatial_phi = writers
        J_all = utils.jones_r2c_np(JF)
        for f, ww in enumerate(workers):
            ww.write_interval(J_all[f], sky.nchunk)
        log(f"Timeslot:{ti} ADMM:{self.cfg.n_admm} residual "
            f"initial={res0.mean():.6g} final={res1.mean():.6g} "
            f"dual={duals[-1] if len(duals) else 0:.3g}")
        if args.verbose:
            for f in range(nf):
                log(f"  subband {f}: {res0[f]:.6g} -> {res1[f]:.6g}")
        J_res = np.einsum("fp,mpknr->fmknr", self.Bpoly, Z) \
            if args.use_global_solution else JF
        J_res = utils.jones_r2c_np(J_res)
        t_res = time.perf_counter()
        for f, (msx, t) in enumerate(zip(self.mss, tiles)):
            t.x = self.residual(f, J_res[f], t, uF[f], vF[f], wF[f],
                                None if beamF is None else beamF[f])
            msx.write_tile(ti, t)
        res_s = time.perf_counter() - t_res
        if spatial_file is not None:
            self._write_spatial(spatial_file, spatial_phi, Z)
        if writer:
            Zj = utils.jones_r2c_np(Z.transpose(0, 2, 1, 3, 4).reshape(
                M, kmax * args.npoly, self.n, 8))
            writer.write_interval(Zj, sky.nchunk * args.npoly)
        return res_s

    def run(self):
        """Every selected solve interval; returns one record an
        interval (res_0/res_1 per subband and their means, the dual
        residual per ADMM iteration, each iteration's and the interval's
        seconds, the in-flight group records per iteration and subband,
        the reset subbands, kernel launches; under ``--staleness`` the
        round schedule and the deaths, under ``--block-f`` the timer's
        entries)."""
        args, sky, log, meta0 = self.args, self.sky, self.log, self.meta0
        nf, n, kmax, M = self.nf, self.n, self.kmax, sky.n_clusters
        writer = None
        if args.solutions_file:
            writer = sol.SolutionWriter(
                args.solutions_file, float(self.freqs.mean()),
                float(self.freqs.max() - self.freqs.min()),
                meta0["tilesz"] * meta0["tdelta"] / 60.0, n, M,
                sky.n_eff_clusters * args.npoly)
        n_tiles = min(m.n_tiles for m in self.mss)
        if any(m.n_tiles != n_tiles for m in self.mss):
            log(f"Warning: subband tile counts differ; calibrating the "
                f"common {n_tiles} tiles")
        start = args.skip_timeslots
        stop = n_tiles if not args.max_timeslots else min(
            n_tiles, start + args.max_timeslots)
        Jinit = utils.jones_c2r_np(np.tile(np.eye(2, dtype=complex),
                                           (nf, M, kmax, n, 1, 1)))
        if args.init_solutions:
            Jq = sol.read_warm_start(args.init_solutions, sky, n)
            if Jq is not None:
                Jinit = np.tile(utils.jones_c2r_np(np.asarray(Jq))[None],
                                (nf, 1, 1, 1, 1))
        spatial_file, spatial_phi = self._spatial_file()
        # the per-subband worker files, opened only after -q is read (a
        # previous run's worker file is a valid warm start)
        interval_min = meta0["tilesz"] * meta0["tdelta"] / 60.0
        workers = [sol.SolutionWriter(
            m.path.rstrip("/") + ".solutions", float(m.meta["freq0"]),
            float(m.meta["fdelta"]), interval_min, n, M, sky.n_eff_clusters)
            for m in self.mss]
        writers = (writer, workers, spatial_file, spatial_phi)
        try:
            if args.time_shard > 1:
                return self._run_time_sharded(start, stop, Jinit, writers)
            return self._run_intervals(start, stop, Jinit, writers)
        finally:
            if writer:
                writer.close()
            if spatial_file is not None:
                spatial_file.close()
            for ww in workers:
                ww.close()

    def _run_intervals(self, start, stop, Jinit, writers):
        """The per-interval loop (the synchronous, blocked and stale
        runners): each interval warm-starts from the last through the
        divergence reset."""
        args, sky, log = self.args, self.sky, self.log
        M = sky.n_clusters
        J0 = Jinit.copy()
        history = []
        for ti in range(start, stop):
            t_int = time.perf_counter()
            c0 = pipeline._counters()
            tiles = [m.read_tile(ti) for m in self.mss]
            x8F, wtF, uF, vF, wF, fratioF = self.prep_tiles(tiles)
            beamF = self.tile_beams(tiles)
            self.timer.clear()
            self.groups.clear()
            out = self.runner(x8F, uF, vF, wF, self.freqs, wtF, fratioF,
                              self._t(J0), beamF)
            JF, Z, rhoF = (o.to("cpu", torch.float64).numpy()
                           for o in out[:3])
            res0, res1_0, r1s = (o.to("cpu", torch.float64).numpy()
                                 for o in out[3:6])
            duals = out[6].to("cpu", torch.float64).numpy()
            Y0F = out[7].to("cpu", torch.float64).numpy()
            if args.mdl and ti == start:
                # the model-order report from iteration 0's rho J
                # (master :815-822)
                mdlmod.report(mdlmod.minimum_description_length(
                    Y0F, np.broadcast_to(np.asarray(self.rho0, float),
                                         (M,)),
                    self.freqs, float(self.freqs.mean()),
                    weight=fratioF.cpu().numpy(),
                    polytype=args.polytype, kstart=1,
                    kfinish=args.npoly), log=log)
            res1 = r1s[-1] if self.cfg.n_admm > 1 else res1_0
            # the per-subband divergence reset (slave :680-683)
            J0, bad = cadmm.divergence_reset(JF, Jinit, res0, res1)
            for f in np.flatnonzero(bad):
                log(f"  subband {f}: diverged; Resetting Solution")
            iter_s = _iter_walls(self.timer)
            if args.block_f:
                nblk = -(-self.nf // args.block_f)
                log("ADMM wall-clock/iter: "
                    + " ".join(f"{t:.2f}s" for t in iter_s)
                    + f" (blocks of {args.block_f} subbands, {nblk} solve "
                    "executions + 1 consensus each)")
            res_s = self._write_interval(ti, tiles, uF, vF, wF, beamF, JF, Z,
                                         res0, res1, duals, writers)
            launches = [b - a for a, b in zip(c0, pipeline._counters())]
            rec = dict(
                tile=ti, res_0=float(res0.mean()),
                res_1=float(res1.mean()), res_0_f=res0.tolist(),
                res_1_f=res1.tolist(), r1s=r1s.tolist(),
                duals=duals.tolist(), rho_mean=float(rhoF.mean()),
                reset=np.flatnonzero(bad).tolist(), iter_s=iter_s,
                residual_s=res_s, groups=[list(g) for g in self.groups],
                interval_s=time.perf_counter() - t_int,
                launches=dict(zip(("coh", "sweep", "matvec", "visits"),
                                  launches[:4])),
                xla_solves=launches[4])
            if args.block_f:
                rec["timer"] = list(self.timer)
            if args.staleness > 0:
                rec["schedule"] = [r.tolist()
                                   for r in self.runner.schedule[-1]]
                rec["dead"] = [list(d) for d in self.runner.dead]
            history.append(rec)
        return history

    def _run_time_sharded(self, start, stop, Jinit, writers):
        """``--time-shard T`` (``_consensus_time_sharded`` of the JAX
        CLI): every selected interval is read and staged up front, the
        intervals padded to a multiple of T (``admm.pad_time``), solved
        by ``admm.make_admm_runner_2d`` (T shards of contiguous intervals
        in turn, each a warm-started chain whose first interval starts
        from the initial Jones), then written back interval by interval
        through the same writers as the per-interval loop. The records
        are the loop's, each with the kernel launches of its own
        write-back (the residual pass: the intervals are solved together);
        the first record also holds the whole run's (``run_launches``,
        ``run_xla_solves``: every solve and residual pass) and
        ``run_s``."""
        args, log = self.args, self.log
        T = int(args.time_shard)
        nt = stop - start
        if nt < 1:
            raise ValueError("no intervals selected (-T/-K window is empty)")
        c0 = pipeline._counters()
        t_all = time.perf_counter()
        all_tiles = [[m.read_tile(start + i) for m in self.mss]
                     for i in range(nt)]
        preps = [self.prep_tiles(tiles) for tiles in all_tiles]
        staged = [torch.stack([p[k] for p in preps], dim=1)
                  for k in range(6)]
        (x8FT, wtFT, uFT, vFT, wFT, frFT), tpad = cadmm.pad_time(staged, nt,
                                                                 T)
        log(f"time shards: {self.nf} subbands x {nt} intervals (padded to "
            f"{tpad}) in {T} shards of {tpad // T}, run in turn on one "
            "device")
        self.timer.clear()
        self.groups.clear()
        runner = cadmm.make_admm_runner_2d(
            self.dsky, self.sta1, self.sta2, self.cidx, self.cmask, self.n,
            self.meta0["fdelta"], self.Bpoly, self.cfg, T, nt,
            nf_total=self.nf, device=self.device, timer=self.timer,
            groups=self.groups)
        out = runner(x8FT, uFT, vFT, wFT, self.freqs, wtFT, frFT,
                     self._t(Jinit))
        JT, ZT, rhoT = (o.to("cpu", torch.float64).numpy() for o in out[:3])
        res0T, res1T, r1sT, dualsT = (o.to("cpu", torch.float64).numpy()
                                      for o in out[3:7])
        walls = [s for _, s in self.timer]
        log("time-shard interval wall-clock: "
            + " ".join(f"{s:.2f}s" for s in walls)
            + f" ({T} shards, {max(self.cfg.n_admm, 1)} ADMM iterations "
            "each)")
        history = []
        for i in range(nt):
            ti = start + i
            _, _, uF, vF, wF, _ = preps[i]
            r1s = r1sT[i]
            res1 = r1s[-1] if self.cfg.n_admm > 1 else res1T[i]
            c_i = pipeline._counters()
            res_s = self._write_interval(ti, all_tiles[i], uF, vF, wF, None,
                                         JT[i], ZT[i], res0T[i], res1,
                                         dualsT[i], writers)
            launches = [b - a for a, b in zip(c_i, pipeline._counters())]
            history.append(dict(
                tile=ti, res_0=float(res0T[i].mean()),
                res_1=float(res1.mean()), res_0_f=res0T[i].tolist(),
                res_1_f=res1.tolist(), r1s=r1s.tolist(),
                duals=dualsT[i].tolist(), rho_mean=float(rhoT[i].mean()),
                reset=runner.resets[i], iter_s=[walls[i]],
                residual_s=res_s, groups=self.groups[i],
                interval_s=walls[i],
                launches=dict(zip(("coh", "sweep", "matvec", "visits"),
                                  launches[:4])), xla_solves=launches[4]))
        launches = [b - a for a, b in zip(c0, pipeline._counters())]
        history[0].update(
            run_launches=dict(zip(("coh", "sweep", "matvec", "visits"),
                                  launches[:4])), run_xla_solves=launches[4],
            run_s=time.perf_counter() - t_all)
        return history

def run(argv=None, log=print) -> list:
    """Parse ``argv`` and run it: the ``-N`` route
    (:func:`run_federated`) or consensus ADMM (:class:`ConsensusRun`);
    returns the per-tile or per-interval records. A ``--faults`` plan is
    installed for the run and removed after it."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.epochs > 0 and args.num_processes > 1:
        parser.error(
            "federated stochastic mode (-N) currently stages data "
            "single-process; run it per host or use the ADMM mode "
            "for multi-host")
    check_flags(args)
    from sagecal_tpu_torch import faults
    from sagecal_tpu_torch.cli import _device
    install_faults(args.faults)
    try:
        device = _device(args.platform)
        if args.epochs > 0:
            return run_federated(args, device=device, log=log)
        check_plans(args)
        return ConsensusRun(args, device=device, log=log).run()
    finally:
        if args.faults is not None:
            faults.disable()


def main(argv=None, log=print) -> int:
    run(argv, log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
