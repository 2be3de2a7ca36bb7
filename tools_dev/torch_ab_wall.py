"""Tile walls of two checkouts of the port on one card, alternated.

    python3 tools_dev/torch_ab_wall.py --trees A B [--flags "-j 5 --inner cg"]
        [--clusters 8|16] [--rounds 1] [--out FILE]

Runs chip_smoke.py's full-width observation (62 stations, 120 timeslots,
8 channels, 2 tiles, 8 or 16 clusters of 64 sources, simulated on the
card) through the CLI of each checkout with the solver ``--flags``, in
the order A B B A (``--rounds`` times), each run in a fresh process that
imports the checkout's own ``chip_smoke.py`` and package (so its kernels
build from its own sources). Prints the card's name and power limit, then one JSON
line per run: the checkout, the tile walls, the pipeline's per-tile
split and the kernel launches. Two versions are compared only within one
call of this script: tile walls move ~10% between machines. ``--out``
also writes the records as one JSON file. 16 clusters needs checkouts
from port PR 3 on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: run in the child, with the checkout first on sys.path
CHILD = """
import json, sys
root, flags, clusters = sys.argv[1], sys.argv[2].split(), int(sys.argv[3])
sys.path.insert(0, root)
import chip_smoke as cs
obs = (cs.observation_e2e() if clusters == 8
       else cs.observation_e2e("e2e16", cs.NCHUNK16))
rec = cs.phase_e2e(obs, "ab_wall", flags, 2, ("coh",))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, required=True,
                    help="the two checkouts A and B")
    ap.add_argument("--flags", default="-j 5 --inner cg",
                    help="solver flags of every run")
    ap.add_argument("--clusters", type=int, choices=(8, 16), default=8)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeats of the A B B A order")
    ap.add_argument("--out", default=None, help="JSON file of the records")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    a, b = (os.path.abspath(t) for t in args.trees)
    recs = []
    for tree in (a, b, b, a) * args.rounds:
        p = subprocess.run([sys.executable, "-c", CHILD, tree, args.flags,
                            str(args.clusters)], cwd=tree,
                           capture_output=True, text=True)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
            raise RuntimeError(f"run in {tree} failed ({p.returncode})")
        rec = next(json.loads(ln) for ln in p.stdout.splitlines()
                   if ln.startswith('{"phase": "ab_wall"'))
        rec = dict(tree=tree, wall_s=rec["wall_s"],
                   tile_s=[t["wall_s"] for t in rec["tiles"]],
                   tiles=rec["tiles"], launches=rec["launches"])
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "flags": args.flags,
                       "clusters": args.clusters, "records": recs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
