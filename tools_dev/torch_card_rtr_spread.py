"""Spread of the card-vs-CPU gate of the robust RTR card test.

    python3 tools_dev/torch_card_rtr_spread.py TREE [TREE ...] [--reps 12]

Repeats the body of ``tests/test_torch_card.py::
test_robust_rtr_cg_on_card_matches_cpu`` (one robust RTR ``--inner cg``
solve, N = 9 stations, T = 12 timeslots, K = 2 chunks, 6 iterations) with
each checkout's ``sagecal_tpu_torch``: one float64 solve on the CPU, then
``--reps`` float32 solves on the card. Prints one JSON line per checkout
with every card run's max|cost - cost_cpu| / max|cost_cpu| (the test's
gate is 1e-3) and the last card and the CPU final costs. Each checkout
runs in its own process, in the order given; compare checkouts only
within one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

#: run in the child, with the checkout first on sys.path
CHILD = r"""
import json, sys
tree, reps = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, tree)
import numpy as np
import torch
from sagecal_tpu_torch.solvers import rtr as trtr

rng = np.random.default_rng(6)
N, T, K = 9, 12, 2
p, q = np.triu_indices(N, k=1)
nb = len(p)
B = T * nb
cid = np.minimum((np.arange(B) // nb) // -(-T // K), K - 1)
coh = rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2))
Jt = (rng.normal(size=(K, N, 2, 2))
      + 1j * rng.normal(size=(K, N, 2, 2))) * 0.2 + np.eye(2)
sa, sb = np.tile(p, T), np.tile(q, T)
V = Jt[cid, sa] @ coh @ np.conj(np.swapaxes(Jt[cid, sb], -1, -2))
V = V + 0.05 * (rng.normal(size=V.shape) + 1j * rng.normal(size=V.shape))
x8 = np.stack([V.reshape(B, 4).real, V.reshape(B, 4).imag],
              -1).reshape(B, 8)
J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))


def solve(dev, rdt, cdt):
    r = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
    c = lambda a: torch.as_tensor(a, dtype=cdt, device=dev)
    i = lambda a: torch.as_tensor(a, device=dev).long()
    _, _, info = trtr.rtr_solve_robust(
        r(x8), c(coh), i(sa), i(sb), i(cid), r(np.ones((B, 8))), c(J0), N,
        row_period=nb, config=trtr.RTRConfig(itmax=6, inner="cg"))
    return info["final_cost"].double().cpu()


cc = solve("cpu", torch.float64, torch.complex128)
rels = []
for _ in range(reps):
    gc = solve("cuda", torch.float32, torch.complex64)
    rels.append(float((gc - cc).abs().max()) / float(cc.abs().max()))
print("SPREAD " + json.dumps({"tree": tree, "rel": rels,
                              "card_cost": gc.tolist(),
                              "cpu_cost": cc.tolist()}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="checkouts to run, in order")
    ap.add_argument("--reps", type=int, default=12,
                    help="card solves per checkout")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for tree in args.trees:
        p = subprocess.run([sys.executable, "-c", CHILD, tree,
                            str(args.reps)], capture_output=True, text=True)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
            raise RuntimeError(f"run in {tree} failed ({p.returncode})")
        print(next(ln.split(" ", 1)[1] for ln in p.stdout.splitlines()
                   if ln.startswith("SPREAD ")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
