"""chip_smoke's row-sharding phases alone, on the card.

    python3 tools_dev/torch_shard_smoke.py [--no-parity] [--no-e2e]
        [--reps N]

Builds the kernels, then runs the ``slice_parity`` runs of one subband's
rows over ranks (``shard2``: 2 ranks on the one card through gloo;
``shard_nccl1``: one rank through NCCL; ``shard_xla_inflight``: the XLA
route's groups over 2 ranks), each against its one-process CPU float64
run (in worker processes beside them) and its 2-rank CPU run, then
``e2e_rtr`` on one full-width tile and ``e2e_shard`` (that tile as 2
ranks on the card), each record one JSON line as chip_smoke prints
them; ``--reps N`` runs that pair N times in turn (the card's
run-to-run spread of both; e2e_shard's gate is then reported, not
raised). The quick way to run the ``--shard-baselines`` path on the
card without the rest of chip_smoke (~3-5 minutes).
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    t0 = time.perf_counter()
    print(cs.phase_env(), flush=True)
    cs.phase_build()
    if "--no-parity" not in argv:
        failures, out = [], {}
        with multiprocessing.get_context("spawn").Pool(2) as pool:
            h = cs.shard_start(pool)
            h["cpu_done"] = {tag: r.get() for tag, r in h["cpu"].items()}
        cs.shard_finish(h, out, failures)
        if failures:
            raise AssertionError("; ".join(failures))
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 1
    if "--no-e2e" not in argv:
        obs = cs.observation_e2e("e2e_shard_obs", n_tiles=1)
        for rep in range(reps):
            rtr = cs.phase_e2e(obs, "e2e_rtr", ["-j", "5", "--inner", "cg"],
                               1, ("coh", "sweep", "matvec"), em=1)
            try:
                cs.phase_e2e_shard(obs, rtr)
            except AssertionError as e:
                if reps == 1:
                    raise
                print(f"rep {rep}: {e}", flush=True)
    print(f"shard phases done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
