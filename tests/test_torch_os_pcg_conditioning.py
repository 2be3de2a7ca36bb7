"""Witness for ROADMAP queue C item C6: the input of
tests/test_torch_card.py's tile-batch Jones case run at ``-j 5 --inner cg
--jones phase`` on clusters of 1 and 2 chunks (16 stations, which the
pipeline runs as OS robust LM with PCG; 8 clusters of 3 sources, 3 tiles
of 10 timeslots, 2 channels, ``--tile-batch 2``), where one card run read
1.15e-3 against the 1e-3 gate.

- Both packages' float64 pipelines under a one-ulp perturbation of the
  data (every real and imaginary part scaled by 1 +- 2^-52, signs from a
  seed) move per-tile res_0/res_1 by at most 1e-10 relative: the input
  is well posed, not C4's conditioning.
- The port's pipeline computing in float32 on the CPU (plain versions of
  every kernel) stays within 1e-4 of its float64 run on this input.
- But float32 roundoff alone decides the outcome: on single-chunk
  clusters at the same flags (the card test's case), the float32 run is
  within the gate, and the same run on data scaled by 1 +- 6e-8 (below
  float32's resolution; signs from seed 4) is more than 1e-3 away. The
  one-ulp probe of float64 cannot see a decision whose margin lies
  between float64's and float32's roundoff; card runs, whose atomic sums
  and kernels round otherwise, land in either mode
  (``tools_dev/torch_float32_spread.py`` over seeds 1-5,
  ``tools_dev/torch_parity_spread.py --tags c6_phase_cg`` on the card).

Each test prints the spreads it measured (``pytest -s``)."""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from sagecal_tpu import cli, pipeline
from sagecal_tpu_torch import device as devmod
from sagecal_tpu_torch.io import dataset as tds

FLAGS = ["-j", "5", "--inner", "cg", "--jones", "phase", "--tile-batch",
         "2"]


@pytest.fixture(scope="module")
def c6(tmp_path_factory):
    """The C6 input, its one-ulp perturbed copy, and the port's float64
    run on the original: (ms, perturbed ms, sky, cluster, history)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("c6")
    ms, sky, clus = chip_smoke.make_observation(
        str(tmp), 16, 10, chip_smoke.FREQS[:2], 8, 3, (1, 2) * 4, 3, "cpu",
        seed=9, noise=0.02)
    pert = ms + ".ulp"
    _perturb(ms, pert, 1, 2.0 ** -52)
    yield ms, pert, sky, clus, _port(ms, sky, clus, "run")
    torch.set_num_threads(n)


def _perturb(src, dst, seed, eps):
    """A copy of the SimMS ``src`` with every real and imaginary part of
    the data scaled by 1 +- ``eps``, signs from ``seed``."""
    shutil.copytree(src, dst)
    d = tds.SimMS(dst)
    rng = np.random.default_rng(seed)
    for i in range(d.n_tiles):
        t = d.read_tile(i)
        s = rng.choice([-1.0, 1.0], size=(2,) + t.x.shape) * eps
        t.x = t.x.real * (1 + s[0]) + 1j * t.x.imag * (1 + s[1])
        d.write_tile(i, t, column="DATA")


def _port(ms, sky, clus, name):
    path = ms + "." + name
    shutil.copytree(ms, path)
    return chip_smoke._parity_run(path, sky, clus, FLAGS, device="cpu")[0]


def _reference(ms, sky, clus):
    args = cli.build_parser().parse_args(
        ["-d", ms, "-s", sky, "-c", clus, "-e", "2", "-g", "10", "-l", "5",
         "-R", "0", "-t", "10"] + FLAGS
        + ["--solve-fuse", "off", "--solve-promote", "off"])
    return pipeline.run(cli.config_from_args(args), log=lambda *a: None)


def _spread(a, b):
    return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b)
               for k in ("res_0", "res_1"))


def test_c6_input_is_well_posed_in_both_packages(c6):
    ms, pert, sky, clus, base = c6
    assert len(base) == 3 and all(h["res_1"] < h["res_0"] for h in base)
    ref = _reference(ms, sky, clus)
    spreads = {"port": _spread(_port(pert, sky, clus, "run"), base),
               "reference": _spread(_reference(pert, sky, clus), ref),
               "port_vs_reference": _spread(base, ref)}
    print("C6 one-ulp spreads", spreads)
    assert spreads["port"] <= 1e-10 and spreads["reference"] <= 1e-10
    assert spreads["port_vs_reference"] <= 1e-8


def test_c6_float32_on_the_cpu_within_gate(c6, monkeypatch):
    ms, _, sky, clus, base = c6
    monkeypatch.setattr(devmod, "real_dtype", lambda dev: torch.float32)
    spread = _spread(_port(ms, sky, clus, "f32"), base)
    print("C6 float32 on the CPU against float64", spread)
    assert spread <= 1e-4


def test_c6_float32_roundoff_decides_single_chunk_case(tmp_path,
                                                       monkeypatch):
    torch.set_num_threads(1)
    ms, sky, clus = chip_smoke.make_observation(
        str(tmp_path), 16, 10, chip_smoke.FREQS[:2], 8, 3, (1,) * 8, 3,
        "cpu", seed=9, noise=0.02)
    _perturb(ms, ms + ".eps", 4, 6e-8)
    base = _port(ms, sky, clus, "run")
    monkeypatch.setattr(devmod, "real_dtype", lambda dev: torch.float32)
    plain, moved = (_spread(_port(m, sky, clus, "f32"), base)
                    for m in (ms, ms + ".eps"))
    print("C6 single-chunk float32 against float64", plain, "and on data "
          "scaled by 1 +- 6e-8", moved)
    assert plain <= 1e-3 < moved
