"""Tile walls of the full-width port with and without in-flight cluster
groups, on the card.

    python3 tools_dev/torch_inflight_wall.py [--widths 4 1] [--out FILE]

Builds chip_smoke.py's ``e2e_inflight`` observation (62 stations, 120
timeslots, 8 channels, 16 clusters of 64 sources, 2 tiles, simulated on
the card) and runs the port's CLI over both tiles at ``-j 5 --inner cg``
once per ``--inflight`` width, in the order given, through chip_smoke's
``phase_e2e``: one JSON line per width with the tile walls, the
pipeline's per-tile split (read, EM, refine, residual, write), the
executed iterations, the kernel launches and the rejected groups. The
card's name and power limit come first; ``--out`` also writes the
records as one JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="+", default=[4, 1],
                    help="--inflight widths to run, in this order")
    ap.add_argument("--out", default=None, help="JSON file of the records")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    obs = cs.observation_e2e("inflight_wall", cs.NCHUNK16)
    must = ("coh", "matvec")
    recs = {}
    for G in args.widths:
        recs[G] = cs.phase_e2e(
            obs, f"inflight_{G}", ["-j", "5", "--inner", "cg",
                                   "--inflight", str(G)], 2,
            must + (("visits",) if G > 1 else ("sweep",)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": recs}, f, indent=1)
    shutil.rmtree(os.path.dirname(obs[0]), ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
