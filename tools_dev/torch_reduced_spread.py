"""How chaotic a reduced-storage pipeline run is, on the CPU.

    python3 tools_dev/torch_reduced_spread.py --stations 16 --chunks 1,1,1 \
        --timeslots 120 --noise 0.05 --policy bf16 [--flags "-j 1"] \
        [--sources 6] [--mixed] [--package port|jax] [--workers 3]

Builds chip_smoke.py's parity observation (seed 9, 2 channels, 2 tiles)
with the given stations, chunks per cluster, sources a cluster, timeslots
a tile and noise, and runs the pipeline of one package on the CPU three
times, as chip_smoke's ``slice_parity`` holds a ``--dtype-policy`` run:
without the policy, at the policy, and at the policy with every source
flux one float32 ulp up (``chip_smoke.perturb_sky``). Prints one JSON
line: ``spread``, the largest relative move of a tile's res_0/res_1
under the ulp (the gate is max(1e-3, SPREAD_FACTOR x spread), at most
SPREAD_CAP), ``drift``, each tile's |res_1 / res_1(no policy) - 1|
(against ENVELOPE), the per-tile residuals and the seconds of each run.
``--package jax`` runs the JAX package's pipeline instead of the port's,
for the reference's own reading (the port never imports it).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _run(job):
    """One pipeline run: (per-tile (res_0, res_1), seconds)."""
    package, path, sky, clus, flags, tilesz = job
    base = ["-d", path, "-s", sky, "-c", clus, "-e", "2", "-g", "10",
            "-l", "5", "-R", "0", "-t", str(tilesz)] + flags
    t0 = time.perf_counter()
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from sagecal_tpu import cli, pipeline
        args = cli.build_parser().parse_args(
            base + ["--solve-fuse", "off", "--solve-promote", "off"])
        hist = pipeline.run(cli.config_from_args(args), log=lambda *a: None)
    else:
        import torch
        torch.set_num_threads(1)
        from sagecal_tpu_torch import pipeline
        from sagecal_tpu_torch.cli import build_parser, config_from_args
        args = build_parser().parse_args(base)
        hist = pipeline.run(config_from_args(args), device="cpu",
                            log=lambda *a: None)
    return ([(float(h["res_0"]), float(h["res_1"])) for h in hist],
            time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=16)
    ap.add_argument("--chunks", default="1,1,1",
                    help="chunks per cluster, one entry a cluster")
    ap.add_argument("--sources", type=int, default=6)
    ap.add_argument("--timeslots", type=int, default=10)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--policy", default="bf16", choices=("bf16", "f16"))
    ap.add_argument("--flags", default="", help="CLI solver flags")
    ap.add_argument("--mixed", action="store_true",
                    help="every source morphology (chip_smoke.write_sky)")
    ap.add_argument("--package", default="port", choices=("port", "jax"))
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "reduced_spread"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import chip_smoke as cs
    nchunk = tuple(int(c) for c in args.chunks.split(","))
    shutil.rmtree(args.work, ignore_errors=True)
    ms, sky, clus = cs.make_observation(
        args.work, args.stations, args.timeslots, cs.FREQS[:2], len(nchunk),
        args.sources, nchunk, 2, "cpu", seed=9, noise=args.noise,
        mixed=args.mixed)
    flags = args.flags.split()
    red = flags + ["--dtype-policy", args.policy]
    runs = {"f32": (sky, flags), "policy": (sky, red),
            "ulp": (cs.perturb_sky(sky), red)}
    jobs = []
    for name, (s, f) in runs.items():
        shutil.copytree(ms, ms + "." + name)
        jobs.append((args.package, ms + "." + name, s, clus, f,
                     args.timeslots))
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        out = dict(zip(runs, pool.map(_run, jobs)))
    spread = max(abs(a / b - 1.0)
                 for p, q in zip(out["ulp"][0], out["policy"][0])
                 for a, b in zip(p, q))
    drift = [abs(p[1] / q[1] - 1.0)
             for p, q in zip(out["policy"][0], out["f32"][0])]
    print(json.dumps(dict(
        package=args.package, stations=args.stations, chunks=nchunk,
        sources=args.sources, timeslots=args.timeslots, noise=args.noise,
        policy=args.policy, flags=flags, mixed=args.mixed, spread=spread,
        drift=drift, res={k: v[0] for k, v in out.items()},
        seconds={k: v[1] for k, v in out.items()})))
    shutil.rmtree(args.work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
