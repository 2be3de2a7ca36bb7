"""Spread of the card-vs-CPU gate of the robust RTR card test.

    python3 tools_dev/torch_card_rtr_spread.py TREE [TREE ...] [--reps 12]
        [--input point|random] [--deterministic]

Repeats the body of ``tests/test_torch_card.py::
test_robust_rtr_cg_on_card_matches_cpu`` (one robust RTR ``--inner cg``
solve, N = 9 stations, T = 12 timeslots, K = 2 chunks, 6 iterations) with
each checkout's ``sagecal_tpu_torch``: one float64 solve on the CPU, then
``--reps`` float32 solves on the card. The input is this tool's own
checkout's ``robust_rtr_problem`` (tests/test_torch_card.py): the test's
point-source input, or ``--input random`` its former random-coherency
input, on which float64 roundoff alone splits the trajectory.
``--deterministic`` runs the card solves under
``torch.use_deterministic_algorithms(True)``. Prints one JSON line per
checkout with every card run's max|cost - cost_cpu| / max|cost_cpu| (the
test's gate is 1e-3) and the last card and the CPU final costs. Each
checkout runs in its own process, in the order given; compare checkouts
only within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: run in the child, with the checkout first on sys.path and this tool's
#: own tests/ (the input) after it
CHILD = r"""
import json, sys
tree, reps, tests, point, det = sys.argv[1:6]
sys.path.insert(0, tree)
sys.path.append(tests)
import numpy as np
import torch
from sagecal_tpu_torch.solvers import rtr as trtr
from test_torch_card import robust_rtr_problem

x8, coh, sa, sb, cid, J0, N, nb = robust_rtr_problem(point == "point")
B = x8.shape[0]


def solve(dev, rdt, cdt):
    r = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
    c = lambda a: torch.as_tensor(a, dtype=cdt, device=dev)
    i = lambda a: torch.as_tensor(a, device=dev).long()
    _, _, info = trtr.rtr_solve_robust(
        r(x8), c(coh), i(sa), i(sb), i(cid), r(np.ones((B, 8))), c(J0), N,
        row_period=nb, config=trtr.RTRConfig(itmax=6, inner="cg"))
    return info["final_cost"].double().cpu()


cc = solve("cpu", torch.float64, torch.complex128)
if det == "1":
    torch.use_deterministic_algorithms(True)
rels = []
for _ in range(int(reps)):
    gc = solve("cuda", torch.float32, torch.complex64)
    rels.append(float((gc - cc).abs().max()) / float(cc.abs().max()))
print("SPREAD " + json.dumps({"tree": tree, "input": point,
                              "deterministic": det == "1", "rel": rels,
                              "card_cost": gc.tolist(),
                              "cpu_cost": cc.tolist()}), flush=True)
"""

#: this tool's own tests/, whose robust_rtr_problem the child uses
TESTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="checkouts to run, in order")
    ap.add_argument("--reps", type=int, default=12,
                    help="card solves per checkout")
    ap.add_argument("--input", choices=("point", "random"), default="point",
                    help="the card test's input, or its former one")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for tree in args.trees:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        p = subprocess.run([sys.executable, "-c", CHILD, tree,
                            str(args.reps), TESTS, args.input,
                            str(int(args.deterministic))],
                           capture_output=True, text=True, env=env)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
            raise RuntimeError(f"run in {tree} failed ({p.returncode})")
        print(next(ln.split(" ", 1)[1] for ln in p.stdout.splitlines()
                   if ln.startswith("SPREAD ")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
