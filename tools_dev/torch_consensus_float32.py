"""How far float32 alone moves a consensus run from float64, on the CPU.

    python3 tools_dev/torch_consensus_float32.py [--tag consensus_rtr_inflight]
        [--times 10] [--tiles 2] [--subbands 3] [--stations 16] [--threads 4]
        [--flags "-j 4 --inner cg --inflight 2"]

Builds chip_smoke's consensus parity observation for ``--tag``
(``chip_smoke.CONSENSUS_PARITY``: its clusters and flags) with
``--times`` timeslots a tile, then runs the port's MPI CLI on the CPU in
float64, in float32 (plain versions, no kernel, no atomics: what the
card computes in, without the card) and in float32 with every source
flux one float32 ulp up (``chip_smoke.perturb_sky``). Prints, for each
float32 run against float64: the largest relative difference of the
per-subband residuals, the written columns (in units of the data's
largest magnitude) and the Z file after aligning each (cluster, chunk)
block by one unitary (the consensus problem's gauge freedom), and the
divergence resets. One JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="consensus_rtr_inflight")
    ap.add_argument("--times", type=int, default=10)
    ap.add_argument("--tiles", type=int, default=2)
    ap.add_argument("--subbands", type=int, default=3)
    ap.add_argument("--stations", type=int, default=16)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--flags", default=None,
                    help="solver flags in place of the tag's, e.g. "
                         "'-j 4 --inner cg --inflight 2'")
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "consensus_float32"))
    a = ap.parse_args(argv)
    import torch
    from sagecal_tpu_torch import device as devmod
    torch.set_num_threads(a.threads)
    _, nchunk, flags, _, _ = next(r for r in cs.CONSENSUS_PARITY
                                  if r[0] == a.tag)
    if a.flags is not None:
        flags = a.flags.split()
    shutil.rmtree(a.work, ignore_errors=True)
    centres = 150e6 + np.linspace(-10e6, 10e6, a.subbands)
    lst, sky, clus, paths = cs.make_subbands(
        a.work, a.stations, a.times, centres, cs.FREQS[:2], len(nchunk), 6,
        nchunk,
        a.tiles, "cpu", seed=9, noise=0.02)
    rho = os.path.join(a.work, "rho.txt")
    with open(rho, "w") as f:
        f.write("".join(f"{m} 1 {2.0 + m % 3}\n" for m in range(len(nchunk))))
    common = [rho if x == "@rho" else x
              for x in cs.CONSENSUS_PARITY_COMMON + flags]
    common[common.index("-t") + 1] = str(a.times)
    cs.perturb_sky(sky)
    runs = {}
    real = devmod.real_dtype
    for name, f32, sk in (("f64", False, sky), ("f32", True, sky),
                          ("f32_ulp", True, sky + ".ulp")):
        own = [p + "." + name for p in paths]
        for p, q in zip(paths, own):
            shutil.copytree(p, q)
        with open(lst + "." + name, "w") as f:
            f.write("\n".join(own) + "\n")
        if f32:
            devmod.real_dtype = lambda dev: torch.float32
        try:
            hist, secs, _ = cs._consensus_run(lst + "." + name, sk, clus,
                                              common, "cpu",
                                              lst + "." + name + ".z")
        finally:
            devmod.real_dtype = real
        runs[name] = (hist, secs, own)
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    nck = skymodel.read_sky_cluster(sky, clus, cs.RA0, cs.DEC0, 150e6).nchunk
    Zref = np.asarray(sol.read_solutions(lst + ".f64.z", nck * 2)[1])
    h64, _, p64 = runs["f64"]
    for name in ("f32", "f32_ulp"):
        hist, secs, own = runs[name]
        res = max(abs(x - y) / abs(y) for h, g in zip(hist, h64)
                  for k in ("res_0_f", "res_1_f")
                  for x, y in zip(h[k], g[k]))
        col = 0.0
        for p, q, d in zip(own, p64, paths):
            for i in range(a.tiles):
                x = ds.SimMS(p, data_column="CORRECTED_DATA").read_tile(i).x
                y = ds.SimMS(q, data_column="CORRECTED_DATA").read_tile(i).x
                col = max(col, float(np.abs(x - y).max()
                                     / np.abs(ds.SimMS(d).read_tile(i).x)
                                     .max()))
        Z = np.asarray(sol.read_solutions(lst + "." + name + ".z",
                                          nck * 2)[1])
        print(json.dumps(dict(
            tag=a.tag, stations=a.stations, times=a.times, tiles=a.tiles,
            flags=common, run=name,
            res_rel=res, col_rel=col,
            z_rel=float(np.abs(Z - Zref).max() / np.abs(Zref).max()),
            z_rel_aligned=cs.z_rel_aligned(Z, Zref),
            resets=[h["reset"] for h in hist],
            resets_f64=[h["reset"] for h in h64], seconds=secs)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
