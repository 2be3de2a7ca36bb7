"""Sweep kernel time at each thread block cluster size, on one card.

    python3 tools_dev/torch_sweep_clusters.py [--out FILE]

Times the sweep kernel (``ops/sweep.py:sweep_geometry`` forced to each
cluster size C = 1 .. 8 in turn) at the full-width path's shapes (62
stations, nb = 1891, 120 timeslots, K = 1 and 4): one visit
(``sweep_blocks``), and V = 4 visits (``sweep_blocks_visits``) with the
weights shared and per visit. Per case it prints the kernel's device time
per call from a ``torch.profiler`` trace (``kernel_us``) at each C and
the C that ``sweep_geometry``'s own rule picks, which is how its
``BLOCK_STEPS`` is checked. The inputs and timers are this checkout's
``chip_smoke.py``. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="JSON file of the records")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from sagecal_tpu_torch.ops import cuda_lib
    from sagecal_tpu_torch.ops import sweep as swp
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    cuda_lib.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    real = swp.sweep_geometry
    recs = []
    for K in (1, 4):
        cases = [("V=1", 1, cs._sweep_inputs(K)[0], swp.sweep_blocks)]
        for batched in (False, True):
            cases.append((f"V=4 {'per-visit' if batched else 'shared'} "
                          "weights", 4, cs._visits_inputs(K, batched)[0],
                          swp.sweep_blocks_visits))
        for tag, V, cargs, fn in cases:
            rec = {"case": tag, "K": K, "rule": real(
                cs.TILESZ, cargs[8], K, swp._sweep_slots(dev, K),
                V).cluster, "kernel_us": {}}
            for C in range(1, swp.MAX_CLUSTER + 1):
                swp.sweep_geometry = (
                    lambda T, nb, K, slots, V=1, cluster=None, md=4, C=C:
                    real(T, nb, K, slots, V, cluster=C, md=md))
                swp._geometry_args.cache_clear()
                rec["kernel_us"][C] = cs.kernel_us(lambda: fn(*cargs),
                                                   ("sweep_cluster",))
            swp.sweep_geometry = real
            swp._geometry_args.cache_clear()
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
