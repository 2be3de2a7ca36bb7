"""How far float32 alone moves chip_smoke's ``slice_parity`` runs from
float64, on the CPU, and what a run's CPU reference costs.

    python3 tools_dev/torch_parity_float32.py --tags inflight_j1 inflight_rtr
        [--extra "-e 1"] [--times 10]

Makes each tag's parity observation (chip_smoke.py's PARITY_RUNS: its
stations, chunks and tiles, ``--times`` timeslots a tile, noise 0.02)
and runs the port's pipeline (chip_smoke's ``_parity_run``: ``-e 2 -g 10
-l 5 -R 0``, the run's flags, then ``--extra``, which override them) in
float64 and in float32 (plain versions, no kernel: what the card computes
in, without the card), one thread each. Prints one JSON line a tag: the
largest relative difference of the per-tile res_0/res_1 (what
slice_parity gates at 1e-3), both runs' per-tile residuals and seconds.
A depth cut of a parity run is safe on the card when it leaves this
difference where it was.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tags", nargs="+", required=True)
    ap.add_argument("--extra", default="")
    ap.add_argument("--times", type=int, default=10)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "parity_float32"))
    a = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    runs = {r[0]: r for r in cs.PARITY_RUNS}
    extra = a.extra.split()
    for tag in a.tags:
        _, n_st, nchunk, flags, _, mixed = runs[tag]
        work = os.path.join(a.work, tag)
        shutil.rmtree(work, ignore_errors=True)
        ms, sky, clus = cs.make_observation(
            work, n_st, a.times, cs.FREQS[:2], len(nchunk), 6, nchunk,
            cs.PARITY_TILES.get(tag, 2), "cpu", seed=9, noise=0.02,
            mixed=mixed)
        cs.write_option_files(ms)
        shutil.copytree(ms, ms + ".f32")
        h64, s64 = cs._parity_cpu((ms, sky, clus, flags + extra, a.times))
        h32, s32 = cs._parity_cpu((ms + ".f32", sky, clus, flags + extra,
                                   a.times, True))
        rel = max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(h32, h64)
                  for k in ("res_0", "res_1"))
        print(json.dumps(dict(
            tag=tag, flags=flags + extra, times=a.times, rel=rel,
            f64=[[h["res_0"], h["res_1"]] for h in h64],
            f32=[[h["res_0"], h["res_1"]] for h in h32], s64=s64,
            s32=s32)), flush=True)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
