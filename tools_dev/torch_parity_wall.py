"""chip_smoke's ``slice_parity`` phase for checkouts in turn, on the card.

    python3 tools_dev/torch_parity_wall.py --trees build/parent .

Each tree's own ``chip_smoke.py`` runs in a fresh process from that
tree: its kernels built (``phase_build``), then ``phase_slice_parity``
(the card runs and the CPU float64 references of its
PARITY_WORKERS-process queue). Prints one JSON line a tree: the phase's
wall, its ``slice_parity_wall`` record (when the card runs and when
every run was in), whether its gates passed and the process's exit
code; each tree's full output goes to ``chiprun_out/parity_wall_<i>.log``
(the directory made if missing). Unpack another commit with ``git
archive <commit> | tar -x -C build/parent``. Compare trees only within
one call: hosts differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
print(cs.phase_env(), flush=True)
cs.phase_build()
t0 = time.perf_counter()
ok = True
try:
    cs.phase_slice_parity()
except AssertionError as e:
    ok = False
    print("GATE", e, flush=True)
print(json.dumps({"wall_s": time.perf_counter() - t0, "ok": ok}), flush=True)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs="+", default=["."])
    args = p.parse_args(argv)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CODE, tree], cwd=tree,
                              capture_output=True, text=True)
        with open(os.path.join(out, f"parity_wall_{i}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        lines = proc.stdout.splitlines()
        walls = [json.loads(ln) for ln in lines
                 if ln.startswith('{"phase": "slice_parity_wall"')]
        last = json.loads(lines[-1]) if lines and lines[-1].startswith(
            '{"wall_s"') else {}
        print(json.dumps(dict(tree=tree, rc=proc.returncode,
                              process_s=time.perf_counter() - t0,
                              wall_s=last.get("wall_s"), ok=last.get("ok"),
                              slice_parity_wall=walls[-1] if walls
                              else None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
