"""Both CLIs on the routes of the XLA normal-equation assembly and on mixed
skies, against each other (float64, the JAX CLI with fuse/promote off,
the port with ``--platform cpu``), at the gates of
tests/test_torch_pipeline.py: per-tile res_0/res_1 rtol 1e-8 with nu
equal, solutions atol 1e-6, written residual column 1e-7 of the data's
largest magnitude.

Modes, on 10 stations and 2 tiles of 2 channels:
- ``xla_j1``: ``-j 1 --kernel xla`` (clusters of 1 and 2 chunks);
- ``xla_default``: ``-j 5 --kernel xla``, which 10 stations run as OS-LM
  then OS robust LM (mode 3) under Cholesky, on single-chunk clusters
  (OS with a multi-chunk cluster under Cholesky amplifies float64
  roundoff in both packages: ROADMAP queue C item 4);
- ``xla_cg``: ``-j 5 --inner cg --kernel xla`` (1 and 2 chunks);
- ``xla_inflight``: ``-j 1 --inflight 2 --kernel xla`` on 8 clusters (a
  folded group through the XLA assembly);
- ``kmax5``: ``-j 1`` with no ``--kernel`` flag and one cluster in 5
  hybrid chunks: the fused sweep does not fit, so the port falls back to
  the XLA assembly as the JAX package does (which the JAX CLI runs
  anyway, its default being ``xla``);
- ``mixed_F1``: a sky of points, gaussians, disks, rings and shapelets
  in ``-F 1`` format (nonzero 2nd/3rd-order spectral indices), default
  flags: the port splits the predict (coherency kernel's plain version
  plus eager envelopes), the JAX CPU run does not.

This file is its own so that ``--dist loadfile`` gives it a worker."""

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
from sagecal_tpu_torch.solvers import lm as tlm

from test_torch_pipeline import (CLUSTER, CLUSTER8, CLUSTER_ONE_CHUNK, SKY,
                                 SKY8)
from test_torch_predict_mixed import write_mixed_sky

RA0 = (0 + 41 / 60) * math.pi / 12
DEC0 = 40 * math.pi / 180
COMMON = ["-e", "2", "-g", "6", "-l", "4", "-R", "0"]
#: tag -> (CLI flags, sky, cluster file, pristine SimMS)
MODES = {
    "xla_j1": (["-j", "1", "--kernel", "xla", "-t", "4"], "sky.txt",
               "sky.txt.cluster", "pristine.ms"),
    "xla_default": (["--kernel", "xla", "-t", "4"], "sky.txt",
                    "one_chunk.cluster", "pristine.ms"),
    "xla_cg": (["-j", "5", "--inner", "cg", "--kernel", "xla", "-t", "4"],
               "sky.txt", "sky.txt.cluster", "pristine.ms"),
    "xla_inflight": (["-j", "1", "--inflight", "2", "--kernel", "xla", "-t",
                      "4"], "sky8.txt", "sky8.txt.cluster", "pristine8.ms"),
    "kmax5": (["-j", "1", "-t", "5"], "sky.txt", "kmax5.cluster",
              "pristine5.ms"),
    "mixed_F1": (["-F", "1", "-t", "4"], "mixed/sky.txt",
                 "mixed/sky.txt.cluster", "pristine_mixed.ms"),
}
#: what the CPU runs launch: no kernel
NO_LAUNCHES = {"coh": 0, "sweep": 0, "matvec": 0, "visits": 0}


def _simulate(tmp, sky_txt, clusters, name, tilesz, seed, format_3=False):
    """A pristine 2-tile SimMS of the sky, written by the JAX package."""
    sky = skymodel.read_sky_cluster(str(tmp / sky_txt), str(tmp / clusters),
                                    RA0, DEC0, 150e6, format_3)
    J = ds.random_jones(sky.n_clusters, sky.nchunk, 10, seed=seed,
                        scale=0.2)
    dsky = rp.sky_to_device(sky, jnp.float64)
    ds.SimMS.create(str(tmp / name), [
        ds.simulate_dataset(dsky, n_stations=10, tilesz=tilesz,
                            freqs=[149e6, 151e6], ra0=RA0, dec0=DEC0,
                            jones=J, nchunk=sky.nchunk, noise_sigma=0.02,
                            seed=seed + 1 + i)
        for i in range(2)])


def _both(tmp, tag):
    flags, sky, clusters, pristine = MODES[tag]
    for side in ("jax", "torch"):
        shutil.copytree(tmp / pristine, tmp / f"{tag}_{side}.ms")
    common = ["-s", str(tmp / sky), "-c", str(tmp / clusters)] + COMMON \
        + flags
    jargs = cli.build_parser().parse_args(
        ["-d", str(tmp / f"{tag}_jax.ms"), "-p", str(tmp / f"{tag}_jax.sol")]
        + common + ["--solve-fuse", "off", "--solve-promote", "off"])
    jhist = pipeline.run(cli.config_from_args(jargs), log=lambda *a: None)
    targs = tcli.build_parser().parse_args(
        ["-d", str(tmp / f"{tag}_torch.ms"), "-p",
         str(tmp / f"{tag}_torch.sol"), "--platform", "cpu"] + common)
    thist = tpipeline.run(tcli.config_from_args(targs), device="cpu",
                          log=lambda *a: None)
    return jhist, thist


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_pipeline_xla")
    (tmp / "sky.txt").write_text(SKY)
    (tmp / "sky.txt.cluster").write_text(CLUSTER)
    (tmp / "one_chunk.cluster").write_text(CLUSTER_ONE_CHUNK)
    (tmp / "kmax5.cluster").write_text("0 1 P0A P0B\n1 5 P1A\n")
    (tmp / "sky8.txt").write_text(SKY8)
    (tmp / "sky8.txt.cluster").write_text(CLUSTER8)
    (tmp / "mixed").mkdir()
    write_mixed_sky(tmp / "mixed", ["PGDRS", "SRGP", "GDS"], seed=3,
                    format_3=True)
    _simulate(tmp, "sky.txt", "sky.txt.cluster", "pristine.ms", 4, 3)
    _simulate(tmp, "sky8.txt", "sky8.txt.cluster", "pristine8.ms", 4, 5)
    _simulate(tmp, "sky.txt", "kmax5.cluster", "pristine5.ms", 5, 7)
    _simulate(tmp, "mixed/sky.txt", "mixed/sky.txt.cluster",
              "pristine_mixed.ms", 4, 9, format_3=True)
    out = {tag: _both(tmp, tag) for tag in MODES}
    yield tmp, out
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(MODES))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_xla_mode_residual_norms_match(runs, tag, key):
    j, t = runs[1][tag]
    assert len(j) == len(t) == 2
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)
    assert [h["mean_nu"] for h in t] == [h["mean_nu"] for h in j]


@pytest.mark.parametrize("tag", sorted(MODES))
def test_xla_mode_solutions_and_column_match(runs, tag):
    tmp = runs[0]
    _, _, clusters, pristine = MODES[tag]
    nchunk = [c[1] for c in skymodel.parse_cluster_file(str(tmp / clusters))]
    _, jb = sol.read_solutions(str(tmp / f"{tag}_jax.sol"), nchunk)
    _, tb = tsol.read_solutions(str(tmp / f"{tag}_torch.sol"), nchunk)
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / pristine))
    for i in range(2):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(tms.read_tile(i).x, jms.read_tile(i).x,
                                   atol=1e-7 * scale)


@pytest.mark.parametrize("tag", sorted(MODES))
def test_xla_modes_take_their_route(runs, tag):
    """Every solve of the --kernel xla and kmax5 runs takes the XLA
    assembly, and none of mixed_F1's (the fused sweep's plain version);
    the CPU runs launch no kernel; residuals fall on every tile."""
    t = runs[1][tag][1]
    for h in t:
        assert np.isfinite(h["res_1"]) and h["res_1"] < h["res_0"]
        assert h["launches"] == NO_LAUNCHES
        assert h["solver_iters"] > 0
        if tag == "mixed_F1":
            assert h["xla_solves"] == 0
        else:
            assert h["xla_solves"] > 0
    if tag == "xla_cg":
        assert all(h["cg_iters"] > 0 for h in t)
    if tag == "xla_inflight":
        assert all(h["groups"] for h in t)


def test_route_is_chosen_from_shapes():
    """The route chooser: the fused sweep only under pallas with at most
    MAX_CHUNKS chunks and baseline-major rows."""
    assert tlm.use_sweep("pallas", 4, 45, 180)
    assert not tlm.use_sweep("xla", 1, 45, 180)
    assert not tlm.use_sweep("pallas", 5, 45, 180)
    assert not tlm.use_sweep("pallas", 1, 0, 180)
    assert not tlm.use_sweep("pallas", 1, 45, 181)
    assert "kmax=5" in tlm.route_name("pallas", 5, 45, 180)


def test_verbose_log_names_the_route(runs, tmp_path):
    """-V logs the route once per tile and reports xla_solves."""
    tmp = runs[0]
    shutil.copytree(tmp / "pristine5.ms", tmp_path / "obs.ms")
    lines = []
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(
        ["-d", str(tmp_path / "obs.ms"), "-s", str(tmp / "sky.txt"), "-c",
         str(tmp / "kmax5.cluster"), "-j", "1", "-e", "1", "-g", "2", "-l",
         "0", "-t", "5", "-T", "1", "-V", "--platform", "cpu"]))
    tpipeline.run(cfg, device="cpu", log=lines.append)
    route = [ln for ln in lines if "solver route" in ln]
    assert len(route) == 1 and "XLA assembly" in route[0]
    assert any('"xla_solves"' in ln for ln in lines)
