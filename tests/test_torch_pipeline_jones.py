"""Constrained Jones solves (``--jones diag|phase``) end to end: both CLIs
on the tests/test_torch_pipeline.py fixtures (10 stations, 2 tiles of 4
timeslots, 2 channels), float64, ``-R 0``:

- ``-j 1 --jones diag --kernel pallas`` (clusters of 1 and 2 chunks);
- ``-j 5 --inner cg --jones phase --kernel pallas`` (the same);
- ``-j 5 --jones diag`` with each CLI's default assembly (the reference's
  XLA normal equations, the port's fused sweep; single-chunk clusters,
  as the default-mode runs of tests/test_torch_pipeline.py, since 10
  stations run it as OS-LM);
- ``-j 1 --inflight 2 --jones phase --kernel pallas`` on 8 clusters.

Gates as there: per-tile res_0/res_1 rtol 1e-8 with nu equal, solutions
atol 1e-6, the written residual column 1e-7 of the data's largest
magnitude. Each run's solutions have off-diagonals exactly 0 (the
solutions file holds full 2x2 Jones, as the reference writes them), and
its residuals fall on every tile."""

import math
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import cli, pipeline, skymodel
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

from test_torch_pipeline import (CLUSTER, CLUSTER8, CLUSTER_ONE_CHUNK,
                                 NO_LAUNCHES, SKY, SKY8)

COMMON = ["-e", "2", "-g", "6", "-l", "4", "-t", "4", "-R", "0"]
#: tag -> (CLI flags, sky, cluster file, pristine SimMS)
RUNS = {
    "diag_j1": (["-j", "1", "--jones", "diag", "--kernel", "pallas"],
                "sky.txt", "sky.txt.cluster", "pristine.ms"),
    "phase_cg": (["-j", "5", "--inner", "cg", "--jones", "phase",
                  "--kernel", "pallas"],
                 "sky.txt", "sky.txt.cluster", "pristine.ms"),
    "diag_default": (["-j", "5", "--jones", "diag"],
                     "sky.txt", "one_chunk.cluster", "pristine.ms"),
    "phase_inflight": (["-j", "1", "--inflight", "2", "--jones", "phase",
                        "--kernel", "pallas"],
                       "sky8.txt", "sky8.txt.cluster", "pristine8.ms"),
}


def _simulate(tmp, sky_name, cluster_name, out, seed, ra0, dec0):
    sky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / sky_name), ra0, dec0, 150e6),
        skymodel.parse_cluster_file(str(tmp / cluster_name)))
    J = ds.random_jones(sky.n_clusters, sky.nchunk, 10, seed=seed,
                        scale=0.2)
    ds.SimMS.create(str(tmp / out), [
        ds.simulate_dataset(rp.sky_to_device(sky, jnp.float64),
                            n_stations=10, tilesz=4, freqs=[149e6, 151e6],
                            ra0=ra0, dec0=dec0, jones=J, nchunk=sky.nchunk,
                            noise_sigma=0.02, seed=seed + 1 + i)
        for i in range(2)])


@pytest.fixture(scope="module")
def jones_runs(tmp_path_factory):
    """Both CLIs per RUNS entry on fresh copies of its SimMS: tag ->
    (JAX history, port history)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_pipeline_jones")
    for name, text in (("sky.txt", SKY), ("sky.txt.cluster", CLUSTER),
                       ("one_chunk.cluster", CLUSTER_ONE_CHUNK),
                       ("sky8.txt", SKY8), ("sky8.txt.cluster", CLUSTER8)):
        (tmp / name).write_text(text)
    ra0 = (0 + 41 / 60) * math.pi / 12
    dec0 = 40 * math.pi / 180
    _simulate(tmp, "sky.txt", "sky.txt.cluster", "pristine.ms", 2, ra0, dec0)
    _simulate(tmp, "sky8.txt", "sky8.txt.cluster", "pristine8.ms", 4, ra0,
              dec0)
    out = {}
    for tag, (flags, sky, clus, pristine) in RUNS.items():
        common = ["-s", str(tmp / sky), "-c", str(tmp / clus)] + COMMON
        for side in ("jax", "torch"):
            shutil.copytree(tmp / pristine, tmp / f"{tag}_{side}.ms")
        jargs = cli.build_parser().parse_args(
            ["-d", str(tmp / f"{tag}_jax.ms"), "-p",
             str(tmp / f"{tag}_jax.sol")] + common + flags
            + ["--solve-fuse", "off", "--solve-promote", "off"])
        jhist = pipeline.run(cli.config_from_args(jargs), log=lambda *a: None)
        targs = tcli.build_parser().parse_args(
            ["-d", str(tmp / f"{tag}_torch.ms"), "-p",
             str(tmp / f"{tag}_torch.sol")] + common + flags
            + ["--platform", "cpu"])
        thist = tpipeline.run(tcli.config_from_args(targs), device="cpu",
                              log=lambda *a: None)
        out[tag] = (jhist, thist)
    yield tmp, out
    torch.set_num_threads(n)


def _solutions(tmp, tag, side):
    nchunk = [c[1] for c in skymodel.parse_cluster_file(
        str(tmp / RUNS[tag][2]))]
    reader = sol.read_solutions if side == "jax" else tsol.read_solutions
    return reader(str(tmp / f"{tag}_{side}.sol"), nchunk)[1]


@pytest.mark.parametrize("tag", sorted(RUNS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_jones_residual_norms_match(jones_runs, tag, key):
    j, t = jones_runs[1][tag]
    assert len(j) == len(t) == 2
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)
    assert [h["mean_nu"] for h in t] == [h["mean_nu"] for h in j]


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_jones_solutions_and_column_match(jones_runs, tag):
    tmp = jones_runs[0]
    jb, tb = _solutions(tmp, tag, "jax"), _solutions(tmp, tag, "torch")
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / RUNS[tag][3]))
    for i in range(2):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(tms.read_tile(i).x, jms.read_tile(i).x,
                                   atol=1e-7 * scale)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_jones_solutions_are_constrained(jones_runs, tag):
    """The solutions' off-diagonals are exactly 0 (in both packages), the
    diagonals are not; residuals fall on every tile; the CPU run launches
    no kernel; -j 5 --inner cg takes PCG trips and --inflight 2 solves in
    groups of 2."""
    tmp, out = jones_runs
    for side in ("jax", "torch"):
        for J in _solutions(tmp, tag, side):
            J = np.asarray(J)
            assert not J[..., 0, 1].any() and not J[..., 1, 0].any()
            assert np.abs(J[..., 0, 0]).min() > 0
    for h in out[tag][1]:
        assert np.isfinite(h["res_1"]) and h["res_1"] < h["res_0"]
        assert h["launches"] == NO_LAUNCHES
        assert h["solver_iters"] > 0 and h["lbfgs_iters"] > 0
        assert bool(h["groups"]) == (tag == "phase_inflight")
        assert (h["cg_iters"] > 0) == (tag == "phase_cg")
