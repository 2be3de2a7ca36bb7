"""chip_smoke's consensus phases alone, on the card.

    python3 tools_dev/torch_consensus_smoke.py [--no-parity] [--processes]

Builds the kernels, then runs ``e2e_stochastic_consensus`` (on a
one-tile full-width observation), ``e2e_consensus`` (the MPI CLI on 4
full-width subbands), ``e2e_federated`` (the MPI CLI's ``-N`` on 2) and,
unless ``--no-parity``, the consensus ``slice_parity`` runs
(``consensus``, ``consensus_rtr_inflight``, ``consensus_blocked``,
``consensus_stale``, ``consensus_time_shard`` and ``federated``: the card
runs one after another, their CPU float64 references in worker processes
beside them) with their gates, each record one JSON line, as chip_smoke
prints them. The quick way to run the consensus path on the card
without the rest of chip_smoke (its full run takes ~15 minutes).
``--processes`` runs only the consensus runs over processes: the
``slice_parity`` runs ``consensus_mp`` (2 ranks on the card) and
``consensus_nccl1`` (one rank on NCCL) against their CPU reference, then
``e2e_consensus`` and ``e2e_consensus_mp`` (its observation as 2 ranks).
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
    if "--processes" in argv:
        failures, out = [], {}
        with multiprocessing.get_context("spawn").Pool(1) as pool:
            h = cs.consensus_mp_start(pool)
            h["cpu_done"] = h["cpu"].get()
        cs.consensus_mp_finish(h, out, failures)
        if failures:
            raise AssertionError("; ".join(failures))
        cs.phase_e2e_consensus_mp(cs.phase_e2e_consensus())
        print(f"consensus runs over processes done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    obs = cs.observation_e2e("e2e_consensus_obs", n_tiles=1)
    cs.phase_e2e_stochastic_consensus(obs)
    cs.phase_e2e_consensus()
    cs.phase_e2e_federated()
    if "--no-parity" not in argv:
        with multiprocessing.get_context("spawn").Pool(4) as pool:
            cons_obs, cpu = cs.consensus_parity_start(pool)
            card = cs.consensus_parity_card(cons_obs)
            cpu = {tag: r.get() for tag, r in cpu.items()}
        failures = []
        cs.consensus_parity_check(cons_obs, card, cpu, {}, failures)
        if failures:
            raise AssertionError("; ".join(failures))
    print(f"consensus phases done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
