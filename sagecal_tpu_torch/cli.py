"""``sagecal-tpu-torch`` command line (port of ``sagecal_tpu/cli.py``:
full-batch and stochastic calibration).

The parser accepts every flag of the JAX CLI so command lines translate
directly. The port runs full-batch calibration with
``-d -f -s -c -p -q -F -t -e -g -l -m -j -L -H -R -x -y -I -O -o -k -J -W
-b -B --linsolv --kernel --inner --inflight --jones --tile-batch
--dtype-policy --resume --platform`` (``-f`` a list file or a glob of
SimMS subbands, calibrated as one dataset of all their channels;
per-channel flags through the native tile packer; ``-B 1|2|3`` the
station beam, array factor, full or element, predicted through the
generic route with the beam tables; ``--resume`` continuing a killed run
from the checkpoint beside ``-p``'s solutions file; every solver mode
``-j 0..6``, ``--inner chol|cg``,
``--kernel pallas|xla``, in-flight cluster groups, ``--jones
full|diag|phase``, T solve intervals as one lane-batched solve, skies of
every source morphology, the ``-q`` warm start, ``-W 1`` whitening of the
solve input, ``-J 1`` phase-only correction with ``-k``, ``-b 1``
per-channel solves; ``--linsolv`` is carried and selects nothing, as in
the JAX package; ``--shard-baselines`` one subband's rows over the
process's devices, as below), and the
simulation modes ``-a 1/2/3`` (``-p`` then
names the solutions that corrupt the model and ``-z`` the clusters to
leave out). ``--solve-fuse`` and ``--solve-promote`` are accepted as
no-ops (PyTorch runs eagerly). ``-N E > 0`` routes to stochastic
calibration (``stochastic.run_minibatch``, as the JAX CLI does, before
it looks at ``-a``): E epochs of ``-M`` minibatches a solve interval
over ``-w`` frequency mini-bands, robust LBFGS (``-l`` iterations, ``-m``
memory, ``-L`` nu) on the ``--loss`` cost, with ``-d -f -s -c -p -q -F -t
-T -x -y -I -O -o -k -B -V --platform``; ``-W``, ``-b``, ``-J``, ``-a``
and ``-z`` are no-ops there, and ``--resume`` starts fresh, as in the
JAX package. With ``-N``, ``-A > 1``
and ``-w > 1`` together run stochastic consensus
(``stochastic.run_minibatch_consensus``, as the JAX CLI routes it): the
bands tied by ADMM to a ``-P``-term polynomial of type ``-Q``, rho from
``-r`` or the ``-G`` file; ``-A`` with ``-w 1`` runs plain minibatch
calibration, as in the JAX CLI. ``-M``, ``--loss``, ``-w``, ``-A``,
``-P``, ``-Q``, ``-r`` and ``-G`` act under ``-N`` only and are inert
without it, as there.
``--shard-baselines`` (``parallel.py``) is the JAX flag's mesh over the
process's devices: one rank a visible card (``torch.cuda.device_count()``),
or under ``--platform cpu`` one gloo rank a ``--cpu-devices N`` (default
1), each holding whole timeslots of every tile, started on this host by
``parallel.run_sharded``; rank 0 logs and writes. One device runs in this
process with no group. ``--tile-batch`` is then off (with its log line),
and under ``-N`` and ``-a`` the flag is inert, as in the JAX CLI; ``-b 1``
runs its joint solve and its channel fits over the ranks.
Any other flag given a non-default value raises ``NotImplementedError``
naming the ROADMAP item that will port it — nothing is silently ignored.
Every run warns, as the JAX CLI does, on values of ``-y`` and ``-o``
that suggest a command line written for another tool
(:func:`warn_legacy_flags`).

``--platform cpu`` runs on the CPU in float64; without it the run needs
a CUDA device (float32). Under ``--dtype-policy bf16|f16`` both compute
in float32 and store the solve's rows in the reduced dtype. ``--kernel``
defaults to ``pallas``: the fused sweep wherever it fits, the XLA
assembly where it does not (more than 4 hybrid chunks, rows not
baseline-major), as the JAX package falls back;
``xla`` takes the XLA assembly always, the JAX CLI's default. The port
keeps ``pallas`` so that its main path runs its kernels; the tests hold
both CLIs without ``--kernel`` against each other.
"""

from __future__ import annotations

import argparse
import sys

from sagecal_tpu_torch.config import (BeamMode, RunConfig, SimulationMode,
                                      SolverMode)

# flags parsed for parity but not ported: dest -> (default, ROADMAP item)
UNPORTED = {
    "tile_bucket": (0, "queue A item 11 (--tile-bucket)"),
    "faults": (None, "queue A item 10 (--faults)"),
    "prefetch": (1, "queue A item 10 (--prefetch overlap)"),
    "prior_cache": ("off", "queue A item 11 (--prior-cache)"),
    "profile": (None, "queue A item 1 (--profile)"),
    "diag": (None, "queue A item 10 (--diag)"),
    "metrics": (None, "queue A item 10 (--metrics)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sagecal-tpu-torch",
        description="direction-dependent calibration on PyTorch/CUDA "
                    "(port of sagecal-tpu; full-batch and stochastic "
                    "calibration)")
    a = p.add_argument
    a("-d", "--ms", help="dataset (SimMS directory)")
    a("-f", "--ms-list",
      help="a file listing SimMS datasets (one a line), or a glob; "
           "calibrated as one dataset of all their channels")
    a("-s", "--sky-model")
    a("-c", "--cluster-file")
    a("-p", "--solutions-file", help="solutions out")
    a("-q", "--init-solutions")
    a("-F", "--format", type=int, default=0,
      help="1: sky model has 3rd-order spectral indices")
    a("-t", "--tile-size", type=int, default=120,
      help="timeslots per solve interval (a SimMS stores its own)")
    a("-e", "--max-em-iter", type=int, default=3)
    a("-g", "--max-iter", type=int, default=10)
    a("-l", "--max-lbfgs", type=int, default=10)
    a("-m", "--lbfgs-m", type=int, default=7)
    a("-n", "--n-threads", type=int, default=4,
      help="accepted for parity; host threads are PyTorch's own")
    a("-j", "--solver-mode", type=int, default=5,
      help="solver mode 0-6: 0 OS-LM, 1 LM, 2 robust LM, 3 OS robust LM, "
           "4 RTR, 5 robust RTR (default), 6 NSD; at <= 40 stations 4 "
           "runs as 0 and 5/6 as 3")
    a("-L", "--nulow", type=float, default=2.0)
    a("-H", "--nuhigh", type=float, default=30.0)
    a("--linsolv", type=int, default=1)
    a("-R", "--randomize", type=int, default=1)
    a("-x", "--uvmin", type=float, default=0.0)
    a("-y", "--uvmax", type=float, default=1e9)
    a("-I", "--input-column", default="DATA")
    a("-O", "--output-column", default="CORRECTED_DATA")
    a("-o", "--mmse-rho", type=float, default=1e-9)
    a("-W", "--whiten", type=int, default=0)
    a("-D", "--diagnostics", type=int, default=0,
      help="accepted for parity (disabled in the reference)")
    a("--profile", default=None)
    a("--diag", default=None)
    a("--metrics", default=None)
    a("--tile-batch", type=int, default=1,
      help=">1: solve this many intervals as one lane-batched solve "
           "(warm start per batch; tile 0, a reset tile and a short tail "
           "solve alone); <= 1 solves tile by tile")
    a("--solve-fuse", choices=("auto", "on", "off"), default="auto",
      help="accepted; a no-op (PyTorch runs eagerly)")
    a("--solve-promote", choices=("auto", "on", "off"), default="auto",
      help="accepted; a no-op (PyTorch runs eagerly)")
    a("--inflight", type=int, default=1,
      help="clusters solved together per SAGE step (block-Jacobi groups, "
           "clamped to M//4; 1 = sequential)")
    a("--tile-bucket", type=int, default=0)
    a("--resume", action="store_true",
      help="continue a killed run from the checkpoint beside -p's "
           "solutions file")
    a("--faults", default=None)
    a("--prefetch", type=int, default=1)
    a("--prior-cache", choices=("off", "read", "readwrite"), default="off")
    a("--dtype-policy", choices=("f32", "bf16", "f16"), default="f32")
    a("--inner", choices=("chol", "cg"), default="chol")
    a("--kernel", choices=("xla", "pallas"), default="pallas",
      help="normal-equation assembly: pallas (default here) the "
           "fused-sweep CUDA kernel where it fits (<= 4 hybrid chunks, "
           "baseline-major rows), else the XLA assembly; xla (the JAX "
           "CLI's default) the eager XLA assembly always. Both CLIs "
           "without --kernel are held against each other by the tests")
    a("--jones", choices=("full", "diag", "phase"), default="full")
    a("--shard-baselines", action="store_true")
    a("--platform", default=None,
      help="'cpu' runs on the CPU (float64); default: the CUDA device")
    a("--cpu-devices", type=int, default=0,
      help="with --platform cpu and --shard-baselines: the ranks (one "
           "gloo process each) a subband's rows are sharded over; "
           "inert otherwise")
    a("-w", "--nsolbw", type=int, default=1)
    a("-b", "--per-channel", type=int, default=0)
    a("-a", "--simulation", type=int, default=0)
    a("-z", "--ignore-clusters")
    a("-k", "--correct-cluster", type=int, default=None)
    a("-J", "--phase-only", type=int, default=0)
    a("-B", "--beam", type=int, default=0,
      help="station beam: 0 none, 1 array factor, 2 full, 3 element")
    a("-N", "--epochs", type=int, default=0)
    a("--loss", choices=("robust", "huber"), default="robust")
    a("-M", "--minibatches", type=int, default=1)
    a("-A", "--admm", type=int, default=1)
    a("-P", "--npoly", type=int, default=2)
    a("-Q", "--polytype", type=int, default=2)
    a("-r", "--rho", type=float, default=5.0)
    a("-G", "--rho-file", default=None)
    a("-T", "--max-timeslots", type=int, default=0)
    a("-V", "--verbose", action="store_true",
      help="log per-tile solver iterations and kernel launches")
    return p


def check_flags(args) -> None:
    """Raise NotImplementedError for a non-default unported flag (what a
    stochastic run refuses, ``stochastic.check_supported`` raises)."""
    for dest, (default, item) in UNPORTED.items():
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')}={getattr(args, dest)!r} is not "
                f"ported yet (ROADMAP {item})")


def warn_legacy_flags(args, err=None) -> list:
    """One-time startup warning for short-option values that suggest a
    pre-remap command line (``warn_legacy_flags`` of the JAX CLI,
    ``sagecal_tpu/cli.py:180``): a ``-y`` under 10 lambda excludes
    essentially every baseline, and an ``-o`` (MMSE rho) above 1 is far
    outside the regularization regime (reference default 1e-9); both
    almost certainly meant something else. The run proceeds; the warning
    names the flag, on ``err`` (standard error by default). Returns the
    warnings."""
    err = sys.stderr if err is None else err
    warnings = []
    if args.uvmax < 10.0:
        warnings.append(
            f"-y/--uvmax={args.uvmax:g} lambda excludes nearly all "
            "baselines; the reference -y is an upper uv-distance cut in "
            "lambda (default 1e9) — was this meant for another tool?")
    if args.mmse_rho > 1.0:
        warnings.append(
            f"-o/--mmse-rho={args.mmse_rho:g} is far above the MMSE "
            "regularization regime (reference default 1e-9); the "
            "reference -o is the robust rho for residual correction — "
            "not an output path or a solver knob")
    for w in warnings:
        print(f"WARNING: suspicious legacy option value: {w}", file=err)
    return warnings


def config_from_args(args) -> RunConfig:
    return RunConfig(
        ms=args.ms, ms_list=args.ms_list, sky_model=args.sky_model,
        cluster_file=args.cluster_file, solutions_file=args.solutions_file,
        init_solutions=args.init_solutions, format_3=bool(args.format),
        tile_size=args.tile_size, max_em_iter=args.max_em_iter,
        max_iter=args.max_iter, max_lbfgs=args.max_lbfgs,
        lbfgs_m=args.lbfgs_m, input_column=args.input_column,
        output_column=args.output_column, mmse_rho=args.mmse_rho,
        solver_mode=SolverMode(args.solver_mode),
        robust_nulow=args.nulow, robust_nuhigh=args.nuhigh,
        linsolv=args.linsolv, randomize=bool(args.randomize),
        uvmin=args.uvmin,
        uvmax=args.uvmax, whiten=bool(args.whiten),
        per_channel_bfgs=bool(args.per_channel),
        simulation=SimulationMode(args.simulation),
        ignore_clusters_file=args.ignore_clusters,
        correct_cluster=args.correct_cluster,
        phase_only=bool(args.phase_only), beam_mode=BeamMode(args.beam),
        n_epochs=args.epochs, n_minibatches=args.minibatches,
        stochastic_loss=args.loss, channel_avg_per_band=args.nsolbw,
        n_admm=args.admm, n_poly=args.npoly, poly_type=args.polytype,
        admm_rho=args.rho, rho_file=args.rho_file,
        max_timeslots=args.max_timeslots,
        verbose=args.verbose,
        solve_fuse=args.solve_fuse, solve_promote=args.solve_promote,
        cluster_inflight=args.inflight, tile_batch=args.tile_batch,
        solver_inner=args.inner, solver_kernel=args.kernel,
        jones_mode=args.jones, dtype_policy=args.dtype_policy,
        resume=bool(args.resume),
        shard_baselines=bool(args.shard_baselines))


def _device(platform):
    if platform is None or platform in ("cuda", "gpu"):
        return None
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"--platform {platform!r}: expected cpu or cuda")


def shard_world(args) -> int:
    """The ranks of a ``--shard-baselines`` run: ``--cpu-devices`` (at
    least 1) under ``--platform cpu``, else the visible cards (the JAX
    flag's mesh over the process's devices)."""
    if _device(args.platform) == "cpu":
        return max(1, int(args.cpu_devices))
    import torch
    return max(1, torch.cuda.device_count())


def prepare(argv):
    """(RunConfig, device) of a full-batch command line, its unported
    flags refused (a rank of ``parallel.run_sharded`` starts here)."""
    args = build_parser().parse_args(argv)
    check_flags(args)
    return config_from_args(args), _device(args.platform)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if (not args.ms and not args.ms_list) or not args.sky_model \
            or not args.cluster_file:
        print("need -d dataset (or -f list), -s sky model, -c cluster file",
              file=sys.stderr)
        return 2
    check_flags(args)
    warn_legacy_flags(args)
    cfg = config_from_args(args)
    if cfg.shard_baselines and cfg.n_epochs == 0 \
            and cfg.simulation == SimulationMode.OFF \
            and shard_world(args) > 1:
        from sagecal_tpu_torch import parallel
        parallel.run_sharded(argv, shard_world(args), timeout=float("inf"),
                             echo=True)
    elif cfg.n_epochs > 0:
        from sagecal_tpu_torch import stochastic
        if cfg.n_admm > 1 and cfg.channel_avg_per_band > 1:
            stochastic.run_minibatch_consensus(cfg,
                                               device=_device(args.platform))
        else:
            stochastic.run_minibatch(cfg, device=_device(args.platform))
    else:
        from sagecal_tpu_torch import pipeline
        pipeline.run(cfg, device=_device(args.platform))
    return 0


if __name__ == "__main__":
    sys.exit(main())
