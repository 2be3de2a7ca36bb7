"""Stochastic calibration (``-N``) end to end: both CLIs on a SimMS of 2
tiles (8 stations, 5 timeslots, 4 channels; 3 clusters, a point, a
2-chunk gaussian and a point), float64 on the CPU:

- ``-N 1 -M 2`` (one band; minibatches of 3 and 2 timeslots, the last
  padded);
- ``-N 2 -M 3 -w 2`` (two bands as lanes, 3 minibatches, 2 epochs);
- ``-N 1 -M 2 -w 2 --loss huber``;
- ``-N 1 -M 2 -w 3`` on 4 channels (2-channel bands: the empty third
  band is dropped);
- ``-N 1 -M 2 -x UVMIN`` (the uv cut flags a copy: the written flags are
  the data's);
- ``-N 1 -M 3 -w 2 -k 1`` (the residual corrected by cluster 1).

Gates: per-tile res_0/res_1 rtol 1e-8; solutions atol 1e-6, the
multi-band files read by both packages' readers; the written residual
column 1e-7 of the data's largest magnitude. The raises that stay:
``--prefetch 0``, ``--tile-bucket`` and ``--diag`` under ``-N``
(stochastic consensus, ``-N 1 -A 2 -w 2``, is in
test_torch_stochastic_consensus.py; ``-q`` under ``-N`` is in
test_torch_pipeline_stochastic_options.py; ``-B`` under ``-N`` in
test_torch_pipeline_beam_options.py)."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagecal_tpu import cli, skymodel, stochastic
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import stochastic as tstochastic
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol
from sagecal_tpu_torch.rime import predict as trp

SKY = """\
P0A 0 40 0 40 0 0 3.0 0 0 0 0 0 0 0 0 150e6
G1A 1 20 0 38 0 0 2.5 0 0 0 -0.7 0 0.0004 0.0002 0.5 150e6
P2A 0 50 0 41 0 0 2.0 0 0 0 0 0 0 0 0 150e6
"""
CLUSTER = "0 1 P0A\n1 2 G1A\n2 1 P2A\n"
FREQS = [148e6, 150e6, 152e6, 154e6]
N_ST, TILESZ = 8, 5
#: -x: about a fifth of the rows below it
UVMIN = 60.0
COMMON = ["-t", str(TILESZ), "-l", "6", "-m", "5"]
RUNS = {
    "n1_m2": ["-N", "1", "-M", "2"],
    "n2_m3_w2": ["-N", "2", "-M", "3", "-w", "2"],
    "huber": ["-N", "1", "-M", "2", "-w", "2", "--loss", "huber"],
    "w3": ["-N", "1", "-M", "2", "-w", "3"],
    "uvcut": ["-N", "1", "-M", "2", "-x", str(UVMIN)],
    "correct": ["-N", "1", "-M", "3", "-w", "2", "-k", "1"],
}


def write_obs(tmp, n_tiles=2):
    """Sky, cluster file and ``pristine.ms`` of the module's observation
    in ``tmp``."""
    (tmp / "sky.txt").write_text(SKY)
    (tmp / "sky.txt.cluster").write_text(CLUSTER)
    ra0, dec0 = (41 / 60) * math.pi / 12, 40 * math.pi / 180
    sky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / "sky.txt"), ra0, dec0, 150e6),
        skymodel.parse_cluster_file(str(tmp / "sky.txt.cluster")))
    J = ds.random_jones(sky.n_clusters, sky.nchunk, N_ST, seed=2, scale=0.15)
    ds.SimMS.create(str(tmp / "pristine.ms"), [
        ds.simulate_dataset(rp.sky_to_device(sky, jnp.float64), N_ST, TILESZ,
                            FREQS, ra0, dec0, jones=J, nchunk=sky.nchunk,
                            noise_sigma=0.01, seed=3 + i)
        for i in range(n_tiles)])
    return sky


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' stochastic runs per RUNS entry, from their CLIs'
    parsers, on fresh copies of the SimMS: tag -> (JAX history, port
    history)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_pipeline_stochastic")
    sky = write_obs(tmp)
    out = {}
    for tag, flags in RUNS.items():
        common = ["-s", str(tmp / "sky.txt"), "-c",
                  str(tmp / "sky.txt.cluster")] + COMMON + flags
        for side in ("jax", "torch"):
            shutil.copytree(tmp / "pristine.ms", tmp / f"{tag}_{side}.ms")
        jargs = cli.build_parser().parse_args(
            ["-d", str(tmp / f"{tag}_jax.ms"), "-p",
             str(tmp / f"{tag}_jax.sol")] + common)
        jhist = stochastic.run_minibatch(cli.config_from_args(jargs),
                                         log=lambda *a: None)
        targs = tcli.build_parser().parse_args(
            ["-d", str(tmp / f"{tag}_torch.ms"), "-p",
             str(tmp / f"{tag}_torch.sol"), "--platform", "cpu"] + common)
        tcli.check_flags(targs)
        thist = tstochastic.run_minibatch(tcli.config_from_args(targs),
                                          device="cpu", log=lambda *a: None)
        out[tag] = (jhist, thist)
    yield tmp, sky, out
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(RUNS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_stochastic_residual_norms_match(runs, tag, key):
    j, t = runs[2][tag]
    assert len(j) == len(t) == 2
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_stochastic_solutions_and_column_match(runs, tag):
    """The solutions (each reader on each file, every band) atol 1e-6,
    the written residual column 1e-7 of the data's largest magnitude."""
    tmp, sky, _ = runs
    nchunk = sky.nchunk
    want = sol.read_solutions(str(tmp / f"{tag}_jax.sol"), nchunk)
    nbands = want[0]["nsolbw"]
    for reader in (sol.read_solutions, tsol.read_solutions):
        header, blocks = reader(str(tmp / f"{tag}_torch.sol"), nchunk)
        assert header == want[0]
        assert len(blocks) == len(want[1]) == 2
        for a, b in zip(blocks, want[1]):
            a, b = (np.asarray(x) for x in (a, b))
            assert a.shape == b.shape
            assert a.shape[0] == nbands if nbands > 1 else a.ndim == 5
            np.testing.assert_allclose(a, b, atol=1e-6)
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / "pristine.ms"))
    for i in range(2):
        scale = np.abs(raw.read_tile(i).x).max()
        got = tms.read_tile(i)
        np.testing.assert_allclose(got.x, jms.read_tile(i).x,
                                   atol=1e-7 * scale)
        # the written flags are the data's (the uv cut is solve-scoped)
        np.testing.assert_array_equal(got.flags, raw.read_tile(i).flags)


def test_stochastic_runs_calibrate(runs):
    """Residuals fall on every tile, no solve kernel or XLA solve is
    counted on the CPU, and the plans are the reference's: -w 3 on 4
    channels writes 2 bands, the uv cut removes rows from the solve."""
    tmp, sky, out = runs
    for tag, (_, t) in out.items():
        for h in t:
            assert np.isfinite(h["res_1"]) and h["res_1"] < h["res_0"], tag
            assert h["launches"] == {"coh": 0, "sweep": 0, "matvec": 0,
                                     "visits": 0} and h["xla_solves"] == 0
            assert h["lbfgs_exhausted"] == sum(
                len(it) == 15 and all(m > 0 for m in it)
                for solve in h["armijo"] for band in solve for it in band)
    n_solves = {"n1_m2": 2, "n2_m3_w2": 6, "huber": 2, "w3": 2, "uvcut": 2,
                "correct": 3}
    for tag, n in n_solves.items():
        iters = out[tag][1][0]["lbfgs_iters"]
        assert len(iters) == n and all(0 < k <= 6 for it in iters
                                       for k in it), (tag, iters)
    header, _ = tsol.read_solutions(str(tmp / "w3_torch.sol"), sky.nchunk)
    assert header["nsolbw"] == 2 and header["nchan"] == 4
    tile = tds.SimMS(str(tmp / "pristine.ms")).read_tile(0)
    cut = trp.apply_uvcut(tile.flags, tile, UVMIN, 1e9)
    assert 0 < int((cut == 2).sum()) < len(cut) // 2
    assert not (tile.flags == 2).any()
    # the cut changes the solve
    assert out["uvcut"][1][0]["res_1"] != out["n1_m2"][1][0]["res_1"]


def test_cli_routes_stochastic(runs, tmp_path):
    """``sagecal-tpu-torch -N ...`` runs the stochastic path: the same
    solutions file as the run above."""
    tmp = runs[0]
    shutil.copytree(tmp / "pristine.ms", tmp_path / "obs.ms")
    argv = ["-d", str(tmp_path / "obs.ms"), "-s", str(tmp / "sky.txt"), "-c",
            str(tmp / "sky.txt.cluster"), "-p", str(tmp_path / "sol.txt"),
            "--platform", "cpu"] + COMMON + RUNS["n2_m3_w2"]
    assert tcli.main(argv) == 0
    assert (tmp_path / "sol.txt").read_text() == \
        (tmp / "n2_m3_w2_torch.sol").read_text()


@pytest.mark.parametrize("extra", [["--prefetch", "0"],
                                   ["--tile-bucket", "8"], ["--diag", "d"]],
                         ids=["prefetch", "tile_bucket", "diag"])
def test_stochastic_unported_flags_raise(runs, extra):
    tmp = runs[0]
    argv = ["-d", str(tmp / "pristine.ms"), "-s", str(tmp / "sky.txt"),
            "-c", str(tmp / "sky.txt.cluster"), "--platform", "cpu", "-N",
            "1"] + extra
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(argv)


def test_stochastic_takes_admm_without_bands(runs, tmp_path):
    """-A 2 with -w 1 under -N runs plain minibatch calibration, as the
    JAX CLI dispatches it."""
    tmp = runs[0]
    shutil.copytree(tmp / "pristine.ms", tmp_path / "obs.ms")
    argv = ["-d", str(tmp_path / "obs.ms"), "-s", str(tmp / "sky.txt"), "-c",
            str(tmp / "sky.txt.cluster"), "-p", str(tmp_path / "sol.txt"),
            "--platform", "cpu", "-A", "2"] + COMMON + RUNS["n1_m2"]
    assert tcli.main(argv) == 0
    assert (tmp_path / "sol.txt").read_text() == \
        (tmp / "n1_m2_torch.sol").read_text()
