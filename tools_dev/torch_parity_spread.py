"""Spread of chip_smoke's card-against-CPU pipeline parity, on the card.

    python3 tools_dev/torch_parity_spread.py [--reps 6]

Runs chip_smoke.py's ``slice_parity`` configurations (``--tags``, by
default ``-j 1`` and the default ``-j``; ``j5_cg`` adds a minute of CPU
reference) once on the CPU (float64, the reference) and ``--reps`` times
on the card (float32). The card's
``index_add_`` sums with atomics in no fixed order, so its runs differ
from each other; this prints one JSON line per configuration with the
max relative residual difference of every card run against the CPU run,
to read against chip_smoke's 1e-3 gate, and every run's per-tile
(res_0, res_1, mean_nu).
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
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--tags", default="j1,default",
                    help="slice_parity configurations to run")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    for tag, n_st, nchunk, flags, _ in cs.PARITY_RUNS:
        if tag not in args.tags.split(","):
            continue
        work = os.path.join(cs.WORK, "spread_" + tag)
        shutil.rmtree(work, ignore_errors=True)
        ms, sky, clus = cs.make_observation(work, n_st, 10, cs.FREQS[:2],
                                            len(nchunk), 6, nchunk, 2, "cpu",
                                            seed=9, noise=0.02)

        def run(device):
            path = os.path.join(work, f"run_{len(os.listdir(work))}.ms")
            shutil.copytree(ms, path)
            return cs._parity_run(path, sky, clus, flags, device)[0]

        keys = ("res_0", "res_1", "mean_nu")
        ref = run("cpu")
        rels, runs = [], []
        for _ in range(args.reps):
            got = run(None)
            rels.append(max(abs(g[k] - c[k]) / abs(c[k])
                            for g, c in zip(got, ref)
                            for k in ("res_0", "res_1")))
            runs.append([[h[k] for k in keys] for h in got])
        print(json.dumps(dict(device=torch.cuda.get_device_name(0), tag=tag,
                              stations=n_st, nchunk=nchunk, max_rel=rels,
                              worst=max(rels), gate=cs.PARITY_RTOL,
                              cpu=[[h[k] for k in keys] for h in ref],
                              card=runs)),
              flush=True)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
