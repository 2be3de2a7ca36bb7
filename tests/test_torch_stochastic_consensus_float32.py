"""Float32 against float64 for stochastic consensus on the CPU (the
port's plain versions, no kernel): ROADMAP queue C item C14, and
chip_smoke.py's ``slice_parity`` ``stochastic_consensus`` gate without
the card.

On chip_smoke.py's STOCHASTIC_PARITY observation (16 stations, 8
clusters of 1 and 2 chunks, 2 tiles of 20 timeslots, 8 channels) at
``-N 1 -M 2 -w 2 -A 2``:

- at the default rho (5; the consensus term weighed by the clusters' rho
  summed, as the JAX package weighs it: C12) the port computing in
  float32 lies beyond the card gate (1e-3) of its float64 run in the
  solutions, with no kernel and no atomics involved (the JAX package in
  float32 moves alike: ROADMAP C14), while a float32 run with every
  source flux one float32 ulp up stays within a tenth of the gate of the
  float32 run: float32 arithmetic moves the run, the same way each time;
- at rho 0.5 (chip_smoke.py's STOCHASTIC_CONSENSUS) float32 stays within
  the gate of float64.

Each case prints what it measured (``pytest -s``)."""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from sagecal_tpu_torch import device as devmod, skymodel
from sagecal_tpu_torch.io import solutions as tsol

DEFAULT_RHO = ["-N", "1", "-M", "2", "-w", "2", "-A", "2"]


@pytest.mark.parametrize("case", ["default_rho", "chip"])
def test_stochastic_consensus_float32(tmp_path, monkeypatch, case):
    flags = DEFAULT_RHO if case == "default_rho" \
        else chip_smoke.STOCHASTIC_CONSENSUS
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        n_st, chunks, times, chans, _ = chip_smoke.STOCHASTIC_PARITY
        ms, sky, clus = chip_smoke.make_observation(
            str(tmp_path / "obs"), n_st, times, chip_smoke.FREQS[:chans],
            len(chunks), 6, chunks, 2, "cpu", seed=9, noise=0.02)
        chip_smoke.perturb_sky(sky)
        nck = skymodel.read_sky_cluster(sky, clus, chip_smoke.RA0,
                                        chip_smoke.DEC0, 150e6).nchunk
        runs = (("f64", False, sky), ("f32", True, sky))
        if case == "default_rho":
            runs += (("ulp", True, sky + ".ulp"),)
        J = {}
        for name, f32, sk in runs:
            shutil.copytree(ms, ms + "." + name)
            with monkeypatch.context() as m:
                if f32:
                    m.setattr(devmod, "real_dtype",
                              lambda dev: torch.float32)
                _, _, solpath = chip_smoke._stochastic_run(
                    ms + "." + name, sk, clus,
                    flags + ["-t", str(times)], "cpu")
            J[name] = np.asarray(tsol.read_solutions(solpath, nck)[1])
    finally:
        torch.set_num_threads(n)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    f32 = rel(J["f32"], J["f64"])
    print(f"{case}: float32 against float64 {f32:.3e}")
    if case == "chip":
        assert f32 <= 1e-3
        return
    ulp = rel(J["ulp"], J["f32"])
    print(f"{case}: one ulp {ulp:.3e}")
    assert f32 > 1e-3
    assert ulp < 1e-4
