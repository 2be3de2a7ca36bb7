"""Float32 against float64 for stochastic calibration on the CPU (the
port's plain versions, no kernel): the card's ``slice_parity``
``stochastic`` gate without the card, and ROADMAP queue C item C8.

- At chip_smoke.py's STOCHASTIC_PARITY configuration (16 stations, 8
  clusters of 1 and 2 chunks, 2 tiles of 20 timeslots, 8 channels, ``-N 2
  -M 2 -w 2``: minibatches of 10 timeslots, bands of 4 channels) the
  port computing in float32 stays within the card gate of its float64
  run: per-tile res_0/res_1 and the solutions within 1e-3.
- At 10 timeslots and 4 channels (minibatches of 5 timeslots, bands of
  2: about 5 data reals a parameter a band) float32 arithmetic alone
  moves the solutions by more than 1e-3 while the residuals stay within
  it: the ten-iteration LBFGS solves amplify the float32 roundoff of the
  model and gradient (C8), with no kernel and no atomics involved.

Each test prints what it measured (``pytest -s``)."""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from sagecal_tpu_torch import device as devmod, skymodel
from sagecal_tpu_torch.io import solutions as tsol


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deviation(tmp, times, chans, monkeypatch):
    """(residual, solutions) relative deviation of the float32 run from
    the float64 run at ``times`` timeslots and ``chans`` channels."""
    n_st, chunks, _, _, flags = chip_smoke.STOCHASTIC_PARITY
    flags = flags + ["-t", str(times)]
    ms, sky, clus = chip_smoke.make_observation(
        str(tmp), n_st, times, chip_smoke.FREQS[:chans], len(chunks), 6,
        chunks, 2, "cpu", seed=9, noise=0.02)
    shutil.copytree(ms, ms + ".f32")
    h64, _, p64 = chip_smoke._stochastic_run(ms, sky, clus, flags, "cpu")
    with monkeypatch.context() as mp:
        mp.setattr(devmod, "real_dtype", lambda dev: torch.float32)
        h32, _, p32 = chip_smoke._stochastic_run(ms + ".f32", sky, clus,
                                                 flags, "cpu")
    nchunk = skymodel.read_sky_cluster(sky, clus, chip_smoke.RA0,
                                       chip_smoke.DEC0, 150e6).nchunk
    J64 = np.asarray(tsol.read_solutions(p64, nchunk)[1])
    J32 = np.asarray(tsol.read_solutions(p32, nchunk)[1])
    res = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(h32, h64)
              for k in ("res_0", "res_1"))
    assert all(h["res_1"] < h["res_0"] for h in h32 + h64)
    return res, float(np.abs(J32 - J64).max() / np.abs(J64).max())


def test_parity_configuration_float32_within_gate(tmp_path, monkeypatch):
    _, _, times, chans, _ = chip_smoke.STOCHASTIC_PARITY
    res, j = _deviation(tmp_path, times, chans, monkeypatch)
    print("float32 against float64 at STOCHASTIC_PARITY", res, j)
    assert res <= chip_smoke.PARITY_RTOL and j <= chip_smoke.PARITY_RTOL


def test_sparse_configuration_float32_moves_solutions(tmp_path,
                                                      monkeypatch):
    res, j = _deviation(tmp_path, 10, 4, monkeypatch)
    print("float32 against float64 at 10 timeslots, 4 channels", res, j)
    assert res <= chip_smoke.PARITY_RTOL < j
