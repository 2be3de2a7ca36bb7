"""Coherency, sweep, multi-visit sweep and matvec kernel times of two
checkouts of the port on one card.

    python3 tools_dev/torch_ab_kernels.py --trees A B [--rounds 1]
        [--reps 200] [--kernels coh sweep visits matvec] [--out FILE]

Times the coherency kernel (``coherencies_points`` at chip_smoke.py's
full-width inputs: the solve at F = 1 and the residual at F = 8, the
latter with the channel step where the checkout takes one, and again
without it as ``residual_sincos``), the fused sweep (``sweep_blocks``),
the multi-visit sweep (``sweep_blocks_visits`` at V = 4 visits, the
weights shared and per visit, beside the four serial ``sweep_blocks``
calls it replaces) and the blocks matvec at the full-width path's shapes
(62 stations, nb = 1891 baselines, 120 timeslots; K = 1 and 4 chunks,
the matvec with a shift) in each checkout, in the order A B B A
(``--rounds`` times), each run in a fresh process with the checkout
first on ``sys.path`` (so its kernels build from its own sources into
its own ``build/torch_kernels/``). The inputs, timers and
compiler-report reader are this tool's own checkout's
(``chip_smoke.py``), from fixed seeds, the same for both checkouts. Per
kernel and K it reports

- ``device_ms``: CUDA events around ``--reps`` back-to-back wrapper
  calls, divided by the count (close to the device time once the host
  keeps ahead of the card);
- ``call_ms``: the median CUDA-event time of one call after a
  synchronize (what a solver loop that reads the device pays);
- ``kernel_us``: the device time per call of the checkout's own
  coherency, sweep or matvec kernels, and ``all_kernels_us`` that of
  every kernel the call launches (gathers, copies, sums; the multi-visit route's
  kernels have other names in other checkouts, so read this one there),
  from a ``torch.profiler`` trace of 20 calls;
- the registers and spills of the checkout's kernels (``nvcc -Xptxas
  -v`` in its build log).

The matvec is called as each checkout's solver loop calls it: through
``matvec_plan``/``matvec_apply`` where the checkout has them, else
``gn_matvec_blocks`` with prebuilt station lists. Prints the card's name
and power limit, then one JSON line per run; two versions are compared
only within one call of this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: run in the child, with the checkout first on sys.path; the timing and
#: input helpers are those of this tool's own checkout (its chip_smoke.py)
CHILD = r"""
import importlib.util, inspect, json, sys
root, reps, here = sys.argv[1], int(sys.argv[2]), sys.argv[3]
kernels = sys.argv[4].split(",")
sys.path.insert(0, root)
import torch
from sagecal_tpu_torch.ops import coh as tcoh
from sagecal_tpu_torch.ops import cuda_lib
from sagecal_tpu_torch.ops import sweep as swp
spec = importlib.util.spec_from_file_location("ab_smoke", here)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
N = cs.N_STATIONS


def timed(fn, names):
    k_us = cs.kernel_us(fn, names)
    return {"device_ms": cs.device_ms(fn, reps), "call_ms": cs.cuda_ms(fn, 50),
            "kernel_us": k_us, "all_kernels_us": cs.kernel_us(fn, ("",))}


cuda_lib.build_all()
rec = {"tree": root, "coh": {}, "sweep": {}, "visits": {}, "serial": {},
       "matvec": {},
       "ptxas": {n: cs.ptxas_resources(n) for n in ("coh", "sweep",
                                                    "matvec")}}
has_step = "step" in inspect.signature(tcoh.coherencies_points).parameters
for F, per_channel, call in ((1, False, "solve"), (8, True, "residual")) \
        if "coh" in kernels else ():
    args, _, fl = cs._coh_inputs(F, per_channel)
    step = tcoh.channel_step(fl) if has_step else None
    kw = {"step": step} if has_step else {}
    rec["coh"][call] = timed(lambda: tcoh.coherencies_points(*args, **kw),
                             ("coh_",))
    if kw and step is not None:
        rec["coh"][call + "_sincos"] = timed(
            lambda: tcoh.coherencies_points(*args), ("coh_",))
for K in (1, 4):
    if "sweep" in kernels:
        args, _ = cs._sweep_inputs(K, seed=2)
        rec["sweep"][K] = timed(lambda: swp.sweep_blocks(*args),
                                ("sweep_partials", "sweep_reduce",
                                 "sweep_cluster"))
    if "matvec" in kernels:
        (x8, J, coh, sta1, sta2, cid, wt, cw, nb, _), _ = cs._sweep_inputs(
            K, seed=3)
        fac, _, _ = swp.gn_blocks(x8, J, coh, sta1, sta2, cid, wt, N, K, nb)
        gen = torch.Generator(device="cuda").manual_seed(K)
        v = torch.randn((K, 8 * N), device="cuda", generator=gen)
        shift = torch.rand((K,), device="cuda", generator=gen) + 0.1
        lists = swp.station_lists(sta1, sta2, nb, N)
        if hasattr(swp, "matvec_plan"):
            plan = swp.matvec_plan(fac, sta1, sta2, N, shift=shift,
                                   lists=lists)
            fn = lambda: swp.matvec_apply(plan, v)
        else:
            fn = lambda: swp.gn_matvec_blocks(fac, v, sta1, sta2, N,
                                              shift=shift, lists=lists)
        rec["matvec"][K] = timed(fn, ("matvec_",))
    for batched in (False, True) if "visits" in kernels else ():
        vargs, _ = cs._visits_inputs(K, batched)
        x8, J, coh, sta1, sta2, cid, wt, cw, nb, _, V = vargs
        wv = (lambda a, v: a[v]) if batched else (lambda a, v: a)
        key = f"{K}_{'per_visit' if batched else 'shared'}"
        rec["visits"][key] = timed(lambda: swp.sweep_blocks_visits(*vargs),
                                   ("",))
        rec["serial"][key] = timed(lambda: [
            swp.sweep_blocks(x8[v], J[v], coh[v], sta1, sta2, cid, wv(wt, v),
                             wv(cw, v), nb, K) for v in range(V)], ("",))
print("AB_KERNELS " + json.dumps(rec), flush=True)
"""

KERNELS = ("coh", "sweep", "visits", "matvec")

#: this tool's own chip_smoke.py, whose helpers the child uses
SMOKE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, required=True,
                    help="the two checkouts A and B")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeats of the A B B A order")
    ap.add_argument("--reps", type=int, default=200,
                    help="back-to-back calls per device_ms")
    ap.add_argument("--kernels", nargs="+", default=KERNELS,
                    choices=KERNELS, help="the kernels to time")
    ap.add_argument("--out", default=None, help="JSON file of the records")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    a, b = (os.path.abspath(t) for t in args.trees)
    recs = []
    for tree in (a, b, b, a) * args.rounds:
        p = subprocess.run([sys.executable, "-c", CHILD, tree,
                            str(args.reps), SMOKE, ",".join(args.kernels)],
                           cwd=tree,
                           capture_output=True, text=True)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
            raise RuntimeError(f"run in {tree} failed ({p.returncode})")
        rec = next(json.loads(ln.split(" ", 1)[1])
                   for ln in p.stdout.splitlines()
                   if ln.startswith("AB_KERNELS "))
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
