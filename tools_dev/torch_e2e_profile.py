"""Where the time of one full-width port tile goes, on the card.

    python3 tools_dev/torch_e2e_profile.py [--out build/e2e_profile]
        [--flags "-j 5 --inner cg"] [--clusters 8|16]

Builds chip_smoke.py's full-width synthetic observation (62 stations,
120 timeslots, 8 channels, 8 or 16 clusters x 64 sources, nchunk up to
4; 16 is the ``e2e_inflight`` observation),
runs its first tile through the port's pipeline unprofiled (the x6
boosted tile), then profiles the second tile with ``torch.profiler``
(CPU and CUDA activities). Prints one JSON line: the tile's wall
seconds, the summed device-kernel time, the device idle share over the
tile, and the top operators by device time and by host time; the full
operator tables go to ``--out``. ``--flags`` gives the solver flags of
the run (default ``-j 1``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "e2e_profile"))
    ap.add_argument("--flags", default="-j 1",
                    help="solver flags of the profiled run")
    ap.add_argument("--clusters", type=int, choices=(8, 16), default=8)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.cli import build_parser, config_from_args
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.pipeline import FullBatchPipeline

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    work = os.path.join(cs.WORK, "profile")
    shutil.rmtree(work, ignore_errors=True)
    nchunk = cs.NCHUNK if args.clusters == 8 else cs.NCHUNK16
    ms_path, sky, clus = cs.make_observation(
        work, cs.N_STATIONS, cs.TILESZ, cs.FREQS, len(nchunk),
        cs.N_SOURCES, nchunk, 2, "cuda", seed=5, noise=0.01)
    cfg = config_from_args(build_parser().parse_args(
        ["-d", ms_path, "-s", sky, "-c", clus, "-e", "3", "-g", "10", "-l",
         "10", "-m", "7"] + args.flags.split()))
    ms = ds.SimMS(ms_path)
    meta = ms.meta
    sk = skymodel.read_sky_cluster(sky, clus, meta["ra0"], meta["dec0"],
                                   meta["freq0"])
    pipe = FullBatchPipeline(cfg, ms, sk, log=lambda *a: None)

    def tile(ti, J, boost):
        t = ms.read_tile(ti)
        stg = pipe.stage(t)
        Jn, info = pipe.solve(stg, J, ti, boost, warm=ti > 0)
        t.x = pipe.residuals(Jn, t, stg)
        ms.write_tile(ti, t)
        return Jn, info

    t0 = time.perf_counter()
    J, _ = tile(0, pipe.initial_jones(), pipe.boost)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = tile(1, J, 1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_attr = ("device_time_total" if hasattr(ka[0], "device_time_total")
                else "cuda_time_total")
    rows = []
    for e in ka:
        rows.append(dict(name=e.key, calls=e.count,
                         device_ms=getattr(e, "self_" + dev_attr, 0) / 1e3,
                         host_ms=e.self_cpu_time_total / 1e3))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top_dev = sorted(rows, key=lambda r: -r["device_ms"])[:12]
    top_host = sorted(rows, key=lambda r: -r["host_ms"])[:12]
    with open(os.path.join(args.out, "table.txt"), "w") as f:
        f.write(ka.table(sort_by="self_" + dev_attr, row_limit=60))
        f.write("\n\n")
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=60))
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), wall_tile0_s=wall0,
        wall_tile1_s=wall1, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / (wall1 * 1e3),
        flags=args.flags, clusters=args.clusters,
        rejected_groups=info["rejected_groups"],
        solver_iters=info["solver_iters"],
        tcg_iters=info.get("tcg_iters", 0), lbfgs_iters=info["lbfgs_iters"],
        top_device=top_dev, top_host=top_host)), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
