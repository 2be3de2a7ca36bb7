"""Storage-rounding flips of the sweep's planes, on one card.

    python3 tools_dev/torch_sweep_flips.py [--out FILE]

At chip_smoke.py's full-width sweep inputs (62 stations, nb = 1891, 120
timeslots, K = 4, the rows in bf16 and in f16) it forms the planes that
the reduced policies round to the storage dtype (A = C Jq^H, Bm = Jp C,
V = Jp A of every row and chunk) in two ways: by complex matrix products
(``torch.matmul`` of complex64 on the card, the plain version's first
formation) and by ``ops/sweep.py:_planes`` (each product and sum rounded
on its own, as the kernel's reduced instances form them). It counts the
planes whose two float32 values round to different storage values (the
flips that set the two apart), and holds the sweep kernel against the
plain version with each formation of the plain version's planes,
printing both errors (chip_smoke's gate is 1e-4). Prints the card's
name and power limit first.
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
    from sagecal_tpu_torch import dtypes
    from sagecal_tpu_torch.ops import cuda_lib
    from sagecal_tpu_torch.ops import sweep as swp
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    cuda_lib.build_all()
    K = 4
    args0, (B, nb) = cs._sweep_inputs(K)
    _, J, coh, sta1, sta2, cid, _, _, _, _ = args0
    Jp, Jq = J[:, sta1[:nb]], J[:, sta2[:nb]]
    C = coh.reshape(-1, nb, 2, 2)
    real = swp._planes
    recs = []
    for policy in cs.REDUCED:
        st = dtypes.storage_dtype(policy)
        flips, planes = 0, 0
        for k in range(K):
            mine = real(C, Jp[k], Jq[k])
            A = C @ Jq[k].conj().transpose(-1, -2)
            Bm = Jp[k] @ C
            V = Jp[k] @ A
            mats = (A.real, A.imag, Bm.real, Bm.imag, V.real, V.imag)
            for a, b in zip(mine, mats):
                flips += int((a.to(st) != b.to(st)).sum())
                planes += a.numel()

        def matmul_planes(C_, Jp_, Jq_):
            A = C_ @ Jq_.conj().transpose(-1, -2)
            Bm = Jp_ @ C_
            V = Jp_ @ A
            return A.real, A.imag, Bm.real, Bm.imag, V.real, V.imag

        x8, J_, coh_, s1, s2, cid_, wt, cw, _, _ = cs._stored(args0, policy)
        got = swp.sweep_blocks(x8, J_, coh_, s1, s2, cid_, wt, cw, nb, K)
        errs = {}
        for tag, fn in (("planes", real), ("matmul", matmul_planes)):
            swp._planes = fn
            try:
                ref = swp.sweep_blocks_plain(
                    x8, J_[:, s1[:nb]], J_[:, s2[:nb]], coh_, cid_, wt, cw,
                    nb)
            finally:
                swp._planes = real
            errs[tag] = {n: cs.rel_err(g, r)[1] for n, g, r in zip(
                ("pp", "qq", "pq", "jtep", "jteq", "cost"), got, ref)}
        rec = dict(policy=policy, K=K, B=B, planes=planes, flips=flips,
                   kernel_vs_plain=errs)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
