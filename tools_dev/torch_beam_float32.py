"""Float32 against float64 for chip_smoke's beam parity runs, on the CPU
(the port's plain versions, no kernel; ROADMAP C11).

    python3 tools_dev/torch_beam_float32.py --tag beam_full [--times 10]
        [--extra "-g 30"] [--variants f64,f32,f64tab32,f32tab64,f64coh32,ulp]
    python3 tools_dev/torch_beam_float32.py --tag beam_stochastic --times 20

Builds the run's observation (chip_smoke.make_observation through the
run's own ``-B`` beam; ``--times`` timeslots a tile, by default
slice_parity's) and runs the port's pipeline in each variant:
``f64`` (the reference), ``f32`` (the card's dtype), ``f64tab32`` (a
float64 solve with the beam tables computed in float32), ``f32tab64``
(a float32 solve with float64 tables), ``f64coh32`` (a float64 solve with
the whole predict in float32) and ``ulp`` (float64 with every source
flux one float32 ulp up: the float64 run's own spread). Prints one JSON
line per variant with the largest relative deviation of its per-tile
res_0/res_1 (and, for ``beam_stochastic``, its solutions) from ``f64``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _patch(variant, mp):
    """Install ``variant``'s dtype changes (``mp``: a list of undo
    callbacks)."""
    import torch
    from sagecal_tpu_torch import device as devmod
    from sagecal_tpu_torch.rime import beam as bm
    from sagecal_tpu_torch.rime import predict as rp

    def setattr_(obj, name, value):
        old = getattr(obj, name)
        setattr(obj, name, value)
        mp.append(lambda: setattr(obj, name, old))

    def cast(t, dt):
        return t.to(dt) if torch.is_tensor(t) and t.is_floating_point() \
            else t

    if variant in ("f32", "f32tab64"):
        setattr_(devmod, "real_dtype", lambda dev: torch.float32)
    if variant in ("f64tab32", "f32tab64"):
        real, rdt = bm.cluster_beam, (torch.float32 if variant == "f64tab32"
                                      else torch.float64)
        back = torch.float64 if variant == "f64tab32" else torch.float32

        def cluster_beam(beam, ra, dec, freqs, dobeam):
            af, E = real(bm.BeamArrays(*(cast(f, rdt) for f in beam)),
                         cast(ra, rdt), cast(dec, rdt), freqs, dobeam)
            return (None if af is None else af.to(back),
                    None if E is None else E.to(
                        torch.complex128 if back == torch.float64
                        else torch.complex64))
        setattr_(bm, "cluster_beam", cluster_beam)
    if variant == "f64coh32":
        real_coh = rp.coherencies

        def coherencies(sky, u, v, w, freqs, fdelta, per_channel_flux=False,
                        beam=None, dobeam=0, tslot=None, sta1=None,
                        sta2=None):
            f = lambda t: cast(t, torch.float32)
            sky32 = rp.SkyArrays(*(f(x) for x in sky)) \
                if isinstance(sky, rp.SkyArrays) else rp.SplitSky(
                    *(rp.SkyArrays(*(f(x) for x in h))
                      if isinstance(h, rp.SkyArrays) else h for h in sky))
            b32 = None if beam is None else bm.BeamArrays(
                *(f(x) for x in beam))
            return real_coh(sky32, f(u), f(v), f(w), freqs, fdelta,
                            per_channel_flux=per_channel_flux, beam=b32,
                            dobeam=dobeam, tslot=tslot, sta1=sta1,
                            sta2=sta2).to(torch.complex128)
        setattr_(rp, "coherencies", coherencies)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="beam_full")
    ap.add_argument("--times", type=int, default=0)
    ap.add_argument("--extra", default="", help="CLI flags after the run's")
    ap.add_argument("--variants", default="f64,f32")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import solutions as sol
    torch.set_num_threads(args.threads)
    stochastic = args.tag == "beam_stochastic"
    if stochastic:
        n_st, nchunk, times, nchan, flags = cs.STOCHASTIC_PARITY
        times = args.times or cs.BEAM_STOCHASTIC_TIMES
        flags = flags + ["-t", str(times), "-B", "2"]
    else:
        _, n_st, nchunk, flags, _, _ = next(
            r for r in cs.PARITY_RUNS if r[0] == args.tag)
        times = args.times or cs.BEAM_OBS[args.tag][0]
        nchan = 2
    flags = list(flags) + args.extra.split()
    work = os.path.join(cs.WORK, f"f32_{args.tag}_{times}")
    shutil.rmtree(work, ignore_errors=True)
    ms, sky, clus = cs.make_observation(
        work, n_st, times, cs.FREQS[:nchan], len(nchunk), 6, nchunk, 2,
        "cpu", seed=9, noise=0.02, beam=cs._beam_of(flags))
    nchunk_sky = skymodel.read_sky_cluster(
        sky, clus, cs.RA0, cs.DEC0, float(np.mean(cs.FREQS[:nchan]))).nchunk
    out = {}
    for variant in ["f64"] + [v for v in args.variants.split(",")
                              if v != "f64"]:
        path = f"{ms}.{variant}"
        shutil.copytree(ms, path)
        sk = cs.perturb_sky(sky) if variant == "ulp" else sky
        undo = []
        _patch(variant, undo)
        try:
            if stochastic:
                hist, _, solpath = cs._stochastic_run(path, sk, clus, flags,
                                                      "cpu")
                J = np.asarray(sol.read_solutions(solpath, nchunk_sky)[1])
            else:
                hist, _ = cs._parity_run(path, sk, clus, flags, "cpu", times)
                J = None
        finally:
            for u in reversed(undo):
                u()
        res = np.array([[h["res_0"], h["res_1"]] for h in hist])
        out[variant] = (res, J)
        rec = dict(tag=args.tag, times=times, flags=flags, variant=variant,
                   res=res.tolist())
        if variant != "f64":
            r64, J64 = out["f64"]
            rec["rel"] = float(np.abs((res - r64) / r64).max())
            if J is not None:
                rec["j_rel"] = float(np.abs(J - J64).max()
                                     / np.abs(J64).max())
        print(json.dumps(rec), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
