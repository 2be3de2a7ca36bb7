"""Spread of chip_smoke's card-against-CPU pipeline parity, on the card.

    python3 tools_dev/torch_parity_spread.py [--reps 6] [--tags j1,default]
        [--deterministic] [--times N]

Runs chip_smoke.py's ``slice_parity`` configurations (``--tags``, by
default ``-j 1`` and the default ``-j``; ``j5_cg`` adds a minute of CPU
reference, ``inflight_rtr`` about six) and the extra ones in
:data:`EXTRA` once on the CPU (float64, the reference) and ``--reps``
times on the card (float32). The card's ``index_add_`` sums with atomics
in no fixed order, so its runs differ from each other;
``--deterministic`` runs the card under
``torch.use_deterministic_algorithms(True)`` (a fixed order). Prints one
JSON line per configuration with the max relative residual difference
of every card run against the CPU run, to read against chip_smoke's
1e-3 gate, and every run's per-tile (res_0, res_1, mean_nu, solver
iterations, PCG trips, tCG products) and group relaxations. Each
configuration runs on slice_parity's observation for it (REDUCED_OBS,
BEAM_OBS, through the run's own ``-B`` beam), or at ``--times``
timeslots a tile; ``multims`` and ``resume`` (their own inputs) are not
run here.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


#: configurations beyond slice_parity's: tag -> (stations, chunks per
#: cluster, sources a cluster, tiles, CLI flags). ``c6_phase_cg`` is the
#: input of tests/test_torch_card.py's tile-batch Jones case at -j 5
#: --inner cg --jones phase (OS robust LM with PCG at 16 stations) on
#: clusters of 1 and 2 chunks (ROADMAP C6)
EXTRA = {"c6_phase_cg": (16, (1, 2) * 4, 3, 3,
                         ["-j", "5", "--inner", "cg", "--jones", "phase",
                          "--tile-batch", "2"])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--tags", default="j1,default",
                    help="slice_parity or EXTRA configurations to run")
    ap.add_argument("--times", type=int, default=0,
                    help="timeslots a tile (0: slice_parity's)")
    ap.add_argument("--deterministic", action="store_true",
                    help="card runs under "
                         "torch.use_deterministic_algorithms(True)")
    args = ap.parse_args()
    if args.deterministic:
        # deterministic cuBLAS needs its workspace set before CUDA starts
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    confs = [(tag, n_st, nchunk, 6, cs.PARITY_TILES.get(tag, 2), flags,
              mixed) for tag, n_st, nchunk, flags, _, mixed in cs.PARITY_RUNS]
    confs += [(tag, *conf[:4], conf[4], False) for tag, conf in EXTRA.items()]
    for tag, n_st, nchunk, n_src, n_tiles, flags, mixed in confs:
        if tag not in args.tags.split(","):
            continue
        work = os.path.join(cs.WORK, "spread_" + tag)
        shutil.rmtree(work, ignore_errors=True)
        tilesz, noise = {**cs.REDUCED_OBS, **cs.BEAM_OBS}.get(tag,
                                                               (10, 0.02))
        tilesz = args.times or tilesz
        ms, sky, clus = cs.make_observation(work, n_st, tilesz,
                                            cs.FREQS[:2], len(nchunk), n_src,
                                            nchunk, n_tiles, "cpu", seed=9,
                                            noise=noise, mixed=mixed,
                                            beam=cs._beam_of(flags))

        def run(device):
            path = os.path.join(work, f"run_{len(os.listdir(work))}.ms")
            shutil.copytree(ms, path)
            return cs._parity_run(path, sky, clus, flags, device,
                                  tilesz)[0]

        keys = ("res_0", "res_1", "mean_nu", "solver_iters", "cg_iters",
                "tcg_iters")
        torch.set_num_threads(8)
        ref = run("cpu")
        torch.use_deterministic_algorithms(args.deterministic)
        rels, runs = [], []
        for _ in range(args.reps):
            got = run(None)
            rels.append(max(abs(g[k] - c[k]) / abs(c[k])
                            for g, c in zip(got, ref)
                            for k in ("res_0", "res_1")))
            runs.append(dict(tiles=[[h.get(k) for k in keys] for h in got],
                             omegas=[[g[2] for g in h["groups"]]
                                     for h in got],
                             flip=cs._first_flip(got, ref)))
        torch.use_deterministic_algorithms(False)
        print(json.dumps(dict(device=torch.cuda.get_device_name(0), tag=tag,
                              stations=n_st, nchunk=nchunk, flags=flags,
                              deterministic=args.deterministic,
                              max_rel=rels, worst=max(rels),
                              gate=cs.PARITY_RTOL, keys=keys,
                              cpu=dict(tiles=[[h.get(k) for k in keys]
                                              for h in ref],
                                       omegas=[[g[2] for g in h["groups"]]
                                               for h in ref]),
                              card=runs)),
              flush=True)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
