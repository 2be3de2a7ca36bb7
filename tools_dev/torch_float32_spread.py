"""Float32 against float64 for the port's full-batch pipeline on the CPU,
under perturbations of the data below float32's resolution.

    python3 tools_dev/torch_float32_spread.py [--nchunk "(1, 2) * 4"]
        [--flags "-j 5 --inner cg --jones phase --tile-batch 2"]
        [--seeds 1 2 3 4 5] [--eps 6e-8]

Simulates chip_smoke.py's small parity observation (16 stations, 8
clusters of 3 sources with ``--nchunk`` chunks, 3 tiles of 10 timeslots, 2
channels; the input of tests/test_torch_card.py's tile-batch Jones case)
and runs the port's pipeline (chip_smoke's ``_parity_run``: ``-e 2 -g 10
-l 5 -R 0``) once in float64, once in float32 and once in float32 for
each seed, with every real and imaginary part of the data scaled by 1 +-
``--eps`` (signs from the seed). Prints per run the max relative
difference of the per-tile res_0/res_1 from the float64 run: the spread
that float32 roundoff alone gives, on the CPU, with no kernel and no
atomics (ROADMAP queue C item C6).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nchunk", default="(1, 2) * 4")
    ap.add_argument("--flags",
                    default="-j 5 --inner cg --jones phase --tile-batch 2")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--eps", type=float, default=6e-8)
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke
    from sagecal_tpu_torch import device as devmod
    from sagecal_tpu_torch.io import dataset as ds
    nchunk = tuple(eval(args.nchunk, {}))
    flags = args.flags.split()
    with tempfile.TemporaryDirectory() as work:
        ms, sky, clus = chip_smoke.make_observation(
            work, 16, 10, chip_smoke.FREQS[:2], len(nchunk), 3, nchunk, 3,
            "cpu", seed=9, noise=0.02)

        def run(name, seed=None):
            path = f"{ms}.{name}"
            shutil.copytree(ms, path)
            if seed is not None:
                d = ds.SimMS(path)
                rng = np.random.default_rng(seed)
                for i in range(d.n_tiles):
                    t = d.read_tile(i)
                    s = rng.choice([-1.0, 1.0], size=(2,) + t.x.shape)
                    t.x = t.x.real * (1 + args.eps * s[0]) \
                        + 1j * t.x.imag * (1 + args.eps * s[1])
                    d.write_tile(i, t, column="DATA")
            return chip_smoke._parity_run(path, sky, clus, flags, "cpu")[0]

        ref = run("f64")
        real_dtype = devmod.real_dtype
        devmod.real_dtype = lambda dev: torch.float32
        try:
            for seed in [None] + args.seeds:
                got = run(f"f32_{seed}", seed)
                rel = max(abs(g[k] - c[k]) / abs(c[k])
                          for g, c in zip(got, ref) for k in ("res_0",
                                                              "res_1"))
                print(f"nchunk {nchunk} flags {args.flags!r} float32 seed "
                      f"{seed} eps {args.eps if seed else 0}: {rel:.3e}",
                      flush=True)
        finally:
            devmod.real_dtype = real_dtype
    return 0


if __name__ == "__main__":
    sys.exit(main())
