"""How far float32 alone moves a federated (``-N``) run from float64, on
the CPU.

    python3 tools_dev/torch_federated_float32.py [--times 20 40] [--minibatches 2]

Makes chip_smoke's federated parity observation (``chip_smoke.
FEDERATED_PARITY``: 2 slave subbands of 16 stations, 8 channels, 8
clusters, one tile) at each ``--times`` (timeslots a tile) and runs the
MPI CLI's ``-N`` on it through ``chip_smoke._consensus_run`` in float64
and in float32 (plain versions, no kernel: what the card computes in,
without the card). Prints one JSON line a length: the largest difference
of any slave's written column over the data's largest magnitude
(``col``, what slice_parity gates), the relative difference of res_0 and
res_1 and of each slave's first and last residual, and both runs'
seconds. ROADMAP C8: the spread falls as a minibatch holds more
timeslots.
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
    ap.add_argument("--times", type=int, nargs="+", default=[20, 40])
    ap.add_argument("--minibatches", type=int, default=2)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "federated_float32"))
    a = ap.parse_args(argv)
    import torch
    from sagecal_tpu_torch import device as devmod
    from sagecal_tpu_torch.io import dataset as ds
    torch.set_num_threads(a.threads)
    n_st, nchunk, _, flags = cs.FEDERATED_PARITY
    real = devmod.real_dtype
    for t in a.times:
        fl = list(flags)
        fl[fl.index("-t") + 1] = str(t)
        fl[fl.index("-M") + 1] = str(a.minibatches)
        work = os.path.join(a.work, f"t{t}")
        shutil.rmtree(work, ignore_errors=True)
        lst, sky, clus, paths = cs.make_subbands(
            work, n_st, t, cs.CONSENSUS_PARITY_CENTRES[:2], cs.FREQS,
            len(nchunk), 6, nchunk, 1, "cpu", seed=9, noise=0.02)
        out = {}
        for name in ("f64", "f32"):
            own = [p + "." + name for p in paths]
            for p, q in zip(paths, own):
                shutil.copytree(p, q)
            with open(lst + "." + name, "w") as f:
                f.write("\n".join(own) + "\n")
            if name == "f32":
                devmod.real_dtype = lambda dev: torch.float32
            try:
                hist, secs, _ = cs._consensus_run(
                    lst + "." + name, sky, clus, fl, "cpu",
                    lst + "." + name + ".sol")
            finally:
                devmod.real_dtype = real
            out[name] = (hist[0], own, secs)
        col = 0.0
        for p, q, d in zip(out["f32"][1], out["f64"][1], paths):
            x = ds.SimMS(p, data_column="CORRECTED_DATA").read_tile(0).x
            y = ds.SimMS(q, data_column="CORRECTED_DATA").read_tile(0).x
            col = max(col, float(np.abs(x - y).max()
                                 / np.abs(ds.SimMS(d).read_tile(0).x).max()))
        h32, h64 = out["f32"][0], out["f64"][0]
        print(json.dumps(dict(
            times=t, flags=fl, col=col,
            res=[abs(h32[k] - h64[k]) / abs(h64[k])
                 for k in ("res_0", "res_1")],
            slave_res=[[abs(x - y) / abs(y) for x, y in zip(g, c)]
                       for g, c in zip(h32["slave_res"], h64["slave_res"])],
            seconds=[out["f64"][2], out["f32"][2]])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
