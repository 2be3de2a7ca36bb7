"""Repeat chip_smoke.py's ``e2e_stochastic`` on the card and print what
each run's minibatch solves did.

    python3 tools_dev/torch_stochastic_spread.py [--reps 3]
        [--flags "-N 2 -M 4 -w 2"] [--nchunk "(1, 1, 2, 1, 4, 1, 2, 1)"]
        [--deterministic] [--tiles 2]

Simulates e2e_rtr's full-width observation on the card (62 stations, 120
timeslots, 8 channels, 8 clusters of 64 sources with ``--nchunk`` hybrid
chunks) and runs stochastic calibration over its first ``--tiles`` tiles
``--reps`` times (``-l 10 -m 7``), each on a fresh copy. Prints one JSON
line a run: per tile res_0/res_1 and the written column's mean magnitude
over the data's, and per minibatch solve and band the LBFGS iterations
and the Armijo tests an iteration (the last test's margin beside it).
``--deterministic`` runs under ``torch.use_deterministic_algorithms``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--flags", default="-N 2 -M 4 -w 2")
    ap.add_argument("--nchunk", default="(1, 1, 2, 1, 4, 1, 2, 1)")
    ap.add_argument("--tiles", type=int, default=2)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import numpy as np
    import torch
    import chip_smoke as cs
    from sagecal_tpu_torch import stochastic
    from sagecal_tpu_torch.cli import build_parser, config_from_args
    from sagecal_tpu_torch.io import dataset as ds
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    nchunk = tuple(eval(args.nchunk, {}))
    work = os.path.join(cs.WORK, "stochastic_spread")
    shutil.rmtree(work, ignore_errors=True)
    ms, sky, clus = cs.make_observation(work, cs.N_STATIONS, cs.TILESZ,
                                        cs.FREQS, len(nchunk), cs.N_SOURCES,
                                        nchunk, args.tiles, "cuda", seed=5,
                                        noise=0.01)
    torch.use_deterministic_algorithms(args.deterministic)
    for rep in range(args.reps):
        path = os.path.join(work, f"run{rep}.ms")
        shutil.copytree(ms, path)
        cfg = config_from_args(build_parser().parse_args(
            ["-d", path, "-s", sky, "-c", clus, "-l", "10", "-m", "7", "-t",
             str(cs.TILESZ)] + args.flags.split()))
        hist = stochastic.run_minibatch(cfg, log=lambda *a: None)
        out, raw = ds.SimMS(path, data_column="CORRECTED_DATA"), ds.SimMS(ms)
        tiles = []
        for h in hist:
            ti = h["tile"]
            tiles.append(dict(
                res_0=h["res_0"], res_1=h["res_1"],
                written_over_data=float(np.abs(out.read_tile(ti).x).mean()
                                        / np.abs(raw.read_tile(ti).x).mean()),
                solves=[[dict(iters=k, tests=[len(t) for t in band],
                              last=[t[-1] if t else None for t in band])
                         for k, band in zip(ks, solve)]
                        for ks, solve in zip(h["lbfgs_iters"],
                                             h["armijo"])]))
        print(json.dumps(dict(device=torch.cuda.get_device_name(0), rep=rep,
                              deterministic=args.deterministic,
                              flags=args.flags, nchunk=nchunk,
                              tiles=tiles)), flush=True)
        shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
