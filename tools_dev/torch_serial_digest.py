"""Digests of the port's sequential runs (``--inflight 1``, the default)
on the CPU, to show that two checkouts compute bit-identical results.

    python3 tools_dev/torch_serial_digest.py TREE [--stations 10]
        [--modes 0 1 2 3]

Imports ``sagecal_tpu_torch`` from the checkout TREE, simulates a small
SimMS (4 point-source clusters, one of 2 chunks, 4 timeslots, 2 channels,
2 tiles, float64) and runs the port's CLI over it with ``--platform cpu``
once per solver mode (``-j M``, and ``-j M --inner cg`` for modes 1, 3
and 5). Prints one line per run: the flags and the first 16 hex digits
of a SHA-256 over the solutions file and both tiles' written residuals.
Run it on two checkouts and compare the lines. At 40 stations or fewer
the RTR/NSD modes 4-6 run as their LM downgrades, so give them 41.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import os
import shutil
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", help="checkout whose sagecal_tpu_torch runs")
    ap.add_argument("--stations", type=int, default=10)
    ap.add_argument("--modes", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from sagecal_tpu_torch import cli, skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.rime import predict as rp

    n = args.stations
    ra0, dec0 = (41 / 60) * math.pi / 12, 40 * math.pi / 180
    with tempfile.TemporaryDirectory() as work:
        sky = os.path.join(work, "sky.txt")
        with open(sky, "w") as f:
            f.writelines(f"Q{m} 0 {38 + m} 0 {38 + 0.5 * m:.1f} {10 * m} 0 "
                         f"{1.5 + 0.25 * m:.2f} 0 0 0 0 0 0 0 0 150e6\n"
                         for m in range(4))
        with open(sky + ".cluster", "w") as f:
            f.writelines(f"{m} {2 if m == 1 else 1} Q{m}\n" for m in range(4))
        sk = skymodel.read_sky_cluster(sky, sky + ".cluster", ra0, dec0,
                                       150e6)
        J = ds.random_jones(sk.n_clusters, sk.nchunk, n, seed=4, scale=0.2)
        dsky = rp.sky_to_device(sk, torch.float64, "cpu")
        tiles = [ds.simulate_dataset(dsky, n, 4, [149e6, 151e6], ra0, dec0,
                                     jones=J, nchunk=sk.nchunk,
                                     noise_sigma=0.02, seed=5 + i)
                 for i in range(2)]
        pristine = os.path.join(work, "pristine.ms")
        ds.SimMS.create(pristine, tiles)
        ms, sol = os.path.join(work, "o.ms"), os.path.join(work, "sol.txt")
        runs = [["-j", str(m)] + extra for m in args.modes
                for extra in ([[]] + ([["--inner", "cg"]]
                                      if m in (1, 3, 5) else []))]
        for flags in runs:
            shutil.copytree(pristine, ms)
            cli.main(["-d", ms, "-s", sky, "-c", sky + ".cluster", "-p", sol,
                      "-e", "2", "-g", "5", "-l", "3", "-t", "4",
                      "--platform", "cpu"] + flags)
            h = hashlib.sha256(open(sol, "rb").read())
            out = ds.SimMS(ms, data_column="CORRECTED_DATA")
            for i in range(2):
                h.update(np.ascontiguousarray(out.read_tile(i).x).tobytes())
            print(" ".join(flags), h.hexdigest()[:16], flush=True)
            shutil.rmtree(ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
