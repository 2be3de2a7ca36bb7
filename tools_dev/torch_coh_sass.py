"""Instructions a term of the coherency kernel, read from its SASS.

    python3 tools_dev/torch_coh_sass.py [--lib LIB | --sass FILE]

Builds the port's kernels (``ops/cuda_lib.py``) and disassembles the
coherency library with ``cuobjdump -sass`` (CUDA toolkit), or another
built library (``--lib``, e.g. another checkout's
``build/torch_kernels/libcoh-*.so``), or reads a saved disassembly
(``--sass``). For every instance of ``coh_points_kernel<FT, RECUR>`` (a
kernel that is no template, the first design of one channel a thread,
counts as FT = 1) it finds the source loop (the backward
branch whose body holds the most FFMAs) and the two paths through it, a
point source's and a gaussian's (the loop's forward branch on the
is-gaussian flag), and prints one JSON line per instance: the kernel's
instructions, each path's instructions per source and row and per term
(over the FT channels of a tile), and the loop body's static counts (all
its instructions, its FFMAs and its MUFUs, both paths and any slow path
included). The path counts are heuristic: which branches a path takes
is read from the code's shape, as ``source_loop`` says; the body counts
are not, and bound the path counts from above. ``--save FILE`` keeps the
disassembly. Prints the card's name and power limit first when run on
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(sass: str) -> dict:
    """{function name: [(address, predicate, opcode, operands)]}."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ins = []
        for ln in chunk.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                          r"([A-Z0-9_.]+)\s*([^;]*);", ln)
            if m:
                ins.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                            m.group(3), m.group(4)))
        out[name] = ins
    return out


def _target(op: str, args: str):
    if op.split(".")[0] != "BRA":
        return None
    m = re.search(r"0x([0-9a-f]+)", args)
    return int(m.group(1), 16) if m else None


def source_loop(ins):
    """(point path, gaussian path) instruction counts of the source loop
    and the loop body's instructions:
    the backward branch whose body holds the most FFMAs, walked from its
    head to its back edge. A conditional branch falls through, except: the
    innermost forward branch around an inner loop or a CALL is a slow-path
    guard (the first design's inline Payne-Hanek reductions of sinf and
    sincosf, its division fix-up), and is taken (this walks their inf
    check, 4 instructions more than the fast path); and the gaussian
    branch, the first whose one side holds the envelope's MUFU.EX2 and
    whose other side does not, where a point source takes the side
    without it."""
    addr = [a for a, _, _, _ in ins]
    best = None
    for i, (a, _, op, args) in enumerate(ins):
        t = _target(op, args)
        if t is not None and t < a:
            lo = addr.index(t)
            ffma = sum(o.startswith("FFMA") for _, _, o, _ in ins[lo:i + 1])
            if best is None or ffma > best[0]:
                best = (ffma, lo, i)
    _, lo, hi = best
    body = ins[lo:hi + 1]
    at = {a: k for k, (a, _, _, _) in enumerate(body)}

    slow = set()
    for k, (a, _, op, args) in enumerate(body[:-1]):
        t = _target(op, args)
        if op.startswith("CALL") or (t is not None and t < a):
            around = [(at[_target(o, g)] - j, j)
                      for j, (b, p, o, g) in enumerate(body[:k])
                      if p and _target(o, g) in at and _target(o, g) > a]
            if around:
                slow.add(min(around)[1])

    def has_ex2(lo, hi):
        return any(o.startswith("MUFU.EX2") for _, _, o, _ in body[lo:hi])

    gauss_branch, point_takes = None, False
    for k, (a, pred, op, args) in enumerate(body):
        t = _target(op, args)
        if pred and t in at and t > a:
            # if-else: the fall-through side ends in a jump past the taken
            # side; if-then: the taken side is empty
            _, p, o, g = body[at[t] - 1]
            y = _target(o, g)
            taken = has_ex2(at[t], at[y]) if not p and y in at and y > t \
                else False
            fall = has_ex2(k + 1, at[t])
            if fall != taken:
                gauss_branch, point_takes = k, fall
                break

    def walk(take_gauss_branch: bool) -> int:
        k, n = 0, 0
        while True:
            n += 1
            if k == len(body) - 1:
                return n
            _, pred, op, args = body[k]
            t = _target(op, args)
            jump = t in at and (not pred or k in slow or (
                k == gauss_branch and take_gauss_branch))
            k = at[t] if jump else k + 1

    return walk(point_takes), walk(not point_takes), body


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", default=None,
                    help="a saved cuobjdump -sass of the coh library")
    ap.add_argument("--lib", default=None, help="a built coh library")
    ap.add_argument("--save", default=None, help="write the disassembly")
    args = ap.parse_args()
    if args.sass:
        sass = open(args.sass).read()
    else:
        sys.path.insert(0, ROOT)
        from sagecal_tpu_torch.ops import cuda_lib
        if args.lib is None:
            cuda_lib.build_all()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(json.dumps({"card": smi}), flush=True)
        tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
        lib = args.lib or str(cuda_lib._lib_path("coh"))
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        if args.save:
            with open(args.save, "w") as f:
                f.write(sass)
    for name, ins in sorted(parse(sass).items()):
        m = re.match(r"_Z\d+coh_points_kernel(ILi(\d+)ELb([01])E)?", name)
        if not m:
            continue
        ft, recur = (int(m.group(2)), m.group(3) == "1") if m.group(1) \
            else (1, False)
        point, gauss, body = source_loop(ins)
        print(json.dumps({
            "kernel": (f"coh_points_kernel<{ft}, {str(recur).lower()}>"
                       if m.group(1) else "coh_points_kernel"),
            "instructions": len(ins), "point_per_source": point,
            "gauss_per_source": gauss, "point_per_term": point / ft,
            "gauss_per_term": gauss / ft, "body": len(body),
            "body_ffma": sum(o.startswith("FFMA") for _, _, o, _ in body),
            "body_mufu": sum(o.startswith("MUFU") for _, _, o, _ in body)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
