"""Float32 against float64 under the station beam on the CPU (the port's
plain versions, no kernel): chip_smoke.py's ``slice_parity`` beam gate
without the card, and ROADMAP queue C item C11.

- At chip_smoke.py's BEAM_OBS (16 stations, 3 clusters of 6 sources, 2
  tiles of 20 timeslots, 2 channels, simulated through the run's own
  beam), ``beam_full`` (the default mode, ``-B 2``) and ``beam_array``
  (``-j 1 -g 30 -B 1``) computing in float32 stay within the card gate
  (1e-3) of their float64 runs.
- At the parity observation's 10 timeslots ``beam_full`` in float32 lies
  beyond it: float32 arithmetic alone, with no kernel and no atomics
  (the beam tables in float32 inside a float64 solve move it by ~1e-5,
  the element-sandwich sums of the predict in float32 as far as the
  whole float32 run; tools_dev/torch_beam_float32.py).

Each test prints what it measured (``pytest -s``)."""

import shutil

import pytest
import torch

import chip_smoke
from sagecal_tpu_torch import device as devmod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deviation(tmp, tag, times, monkeypatch):
    """Largest relative deviation of the per-tile res_0/res_1 of the
    float32 run of slice_parity's ``tag`` from its float64 run, on an
    observation of ``times`` timeslots a tile."""
    _, n_st, nchunk, flags, _, _ = next(
        r for r in chip_smoke.PARITY_RUNS if r[0] == tag)
    ms, sky, clus = chip_smoke.make_observation(
        str(tmp), n_st, times, chip_smoke.FREQS[:2], len(nchunk), 6, nchunk,
        2, "cpu", seed=9, noise=0.02, beam=chip_smoke._beam_of(flags))
    shutil.copytree(ms, ms + ".f32")
    h64, _ = chip_smoke._parity_run(ms, sky, clus, flags, "cpu", times)
    with monkeypatch.context() as mp:
        mp.setattr(devmod, "real_dtype", lambda dev: torch.float32)
        h32, _ = chip_smoke._parity_run(ms + ".f32", sky, clus, flags,
                                        "cpu", times)
    assert all(h["res_1"] < h["res_0"] for h in h32 + h64)
    return max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(h32, h64)
               for k in ("res_0", "res_1"))


@pytest.mark.parametrize("tag", ["beam_full", "beam_array"])
def test_beam_parity_configuration_float32_within_gate(tmp_path, tag,
                                                       monkeypatch):
    times = chip_smoke.BEAM_OBS[tag][0]
    dev = _deviation(tmp_path, tag, times, monkeypatch)
    print(f"float32 against float64, {tag} at {times} timeslots", dev)
    assert dev <= chip_smoke.PARITY_RTOL


def test_ten_timeslot_beam_float32_outside_gate(tmp_path, monkeypatch):
    dev = _deviation(tmp_path, "beam_full", 10, monkeypatch)
    print("float32 against float64, beam_full at 10 timeslots", dev)
    assert dev > chip_smoke.PARITY_RTOL
