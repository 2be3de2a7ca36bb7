"""The station beam (``-B 1|2|3``) through both CLIs end to end, float64
on the CPU, on one SimMS: 8 stations, 3 tiles of 4 timeslots, 3
channels, 3 clusters (a point, a 2-chunk gaussian and point, a point),
simulated through the full beam (``-B 2``) of a stored ``beam.npz``
(the JAX ``synthetic_beam`` over the tiles' times, HBA element tables).

This file runs the default solver mode (no ``-j``: OS-LM then OS robust
LM at 8 stations) at ``-B 1``, ``-B 2`` and ``-B 3`` on single-chunk
clusters (the 2-chunk OS-LM route is held to the reference's one-ulp
spread elsewhere: ROADMAP C4), and checks that both pipelines precess
the sky and the beam pointing alike. ``-j 1`` at each beam mode is in
test_torch_pipeline_beam_j1.py; ``--tile-batch``, ``-b 1``, ``-a`` and
``-N`` under the beam in test_torch_pipeline_beam_options.py, all with
the helpers here.

Gates (those of test_torch_pipeline.py): per-tile res_0/res_1 rtol 1e-8
with equal nu, solutions atol 1e-6, the written column 1e-7 of the
data's largest magnitude. No run predicts through the coherency kernel
or its plain version: under the beam the whole sky takes the generic
route."""

import math
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import cli, pipeline, skymodel, stochastic
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu.rime import beam as jbm
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch import stochastic as tstochastic
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol
from sagecal_tpu_torch.ops import coh as tcoh

SKY = """\
P0A 0 40 0 40 0 0 3.0 0 0 0 0 0 0 0 0 150e6
G1A 1 20 0 38 0 0 2.5 0 0 0 -0.7 0 0.0004 0.0002 0.5 150e6
P1B 1 10 0 39 0 0 1.0 0 0 0 0 0 0 0 0 150e6
P2A 0 50 0 41 0 0 2.0 0 0 0 0 0 0 0 0 150e6
"""
CLUSTER = "0 1 P0A\n1 2 G1A P1B\n2 1 P2A\n"
CLUSTER_ONE_CHUNK = "0 1 P0A\n1 1 G1A P1B\n2 1 P2A\n"
FREQS = [148e6, 150e6, 152e6]
N_ST, TILESZ, N_TILES, TDELTA = 8, 4, 3, 10.0
START_MJD_S = 4.93e9
RA0, DEC0 = (41 / 60) * math.pi / 12, 40 * math.pi / 180
FLAGS = ["-e", "2", "-g", "10", "-l", "5", "-t", str(TILESZ), "-R", "0",
         "--kernel", "pallas"]
#: tag -> (flags after FLAGS, cluster file)
RUNS = {f"b{b}_default": (["-B", str(b)], "one_chunk.cluster")
        for b in (1, 2, 3)}
QUIET = dict(log=lambda *a: None)


def write_beam_obs(tmp):
    """Sky, cluster files and ``pristine.ms`` (with its ``beam.npz``) of
    the module's observation in ``tmp``; returns the host sky."""
    (tmp / "sky.txt").write_text(SKY)
    (tmp / "sky.txt.cluster").write_text(CLUSTER)
    (tmp / "one_chunk.cluster").write_text(CLUSTER_ONE_CHUNK)
    sky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / "sky.txt"), RA0, DEC0, 150e6),
        skymodel.parse_cluster_file(str(tmp / "sky.txt.cluster")))
    J = ds.random_jones(sky.n_clusters, sky.nchunk, N_ST, seed=2, scale=0.15)
    starts = [START_MJD_S + i * TILESZ * TDELTA for i in range(N_TILES)]
    jd = np.concatenate([(s + TDELTA * (np.arange(TILESZ) + 0.5)) / 86400.0
                         + 2400000.5 for s in starts])
    info = jbm.synthetic_beam(N_ST, jd, RA0, DEC0, float(np.mean(FREQS)),
                              n_elem=8, band="hba", seed=5)
    dsky = rp.sky_to_device(sky, jnp.float64)
    tiles = [ds.simulate_dataset(
        dsky, N_ST, TILESZ, FREQS, RA0, DEC0, tdelta=TDELTA, jones=J,
        nchunk=sky.nchunk, noise_sigma=0.01, seed=3 + i,
        beam=jbm.beam_to_device(info, float(np.mean(FREQS)), jnp.float64,
                                time_jd=jd[i * TILESZ:(i + 1) * TILESZ]),
        dobeam=2, start_mjd_s=s) for i, s in enumerate(starts)]
    ds.SimMS.create(str(tmp / "pristine.ms"), tiles, beam_info=info)
    return sky


def run_cli(tmp, tag, flags, side, clusters="sky.txt.cluster", sim=False):
    """One CLI's run on a fresh copy of the SimMS, its solutions beside it
    (not for a simulation, ``sim``): its history (None for the JAX
    simulation, which returns none)."""
    ms = tmp / f"{tag}_{side}.ms"
    shutil.copytree(tmp / "pristine.ms", ms)
    argv = ["-d", str(ms), "-s", str(tmp / "sky.txt"), "-c",
            str(tmp / clusters)] + flags
    if not sim:
        argv += ["-p", str(tmp / f"{tag}_{side}.sol")]
    if side == "jax":
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            argv + ["--solve-fuse", "off", "--solve-promote", "off"]))
        if cfg.n_epochs > 0:
            return stochastic.run_minibatch(cfg, **QUIET)
        return pipeline.run(cfg, **QUIET)
    args = tcli.build_parser().parse_args(argv + ["--platform", "cpu"])
    tcli.check_flags(args)
    cfg = tcli.config_from_args(args)
    if cfg.n_epochs > 0:
        return tstochastic.run_minibatch(cfg, device="cpu", **QUIET)
    return tpipeline.run(cfg, device="cpu", **QUIET)


def both_clis(tmp_path_factory, name, runs, sim=False):
    """The observation in a fresh directory, then both CLIs' run of every
    tag -> (flags, cluster file) of ``runs``, the port's with every call
    of the coherency kernel's entry point counted: (tmp, sky, tag ->
    (JAX history, port history), kernel-path calls of the port runs)."""
    tmp = tmp_path_factory.mktemp(name)
    sky = write_beam_obs(tmp)
    calls = []
    real = tcoh.coherencies

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    out = {}
    for tag, (flags, clusters) in runs.items():
        jh = run_cli(tmp, tag, flags, "jax", clusters, sim)
        tcoh.coherencies = counted
        try:
            th = run_cli(tmp, tag, flags, "torch", clusters, sim)
        finally:
            tcoh.coherencies = real
        out[tag] = (jh, th)
    return tmp, sky, out, len(calls)


def check_residual_norms(runs, tag, key, n_tiles=N_TILES):
    """Per-tile ``key`` rtol 1e-8 and equal nu."""
    j, t = runs[2][tag]
    assert len(j) == len(t) == n_tiles
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)
    if "mean_nu" in j[0]:
        assert [h["mean_nu"] for h in t] == [h["mean_nu"] for h in j]


def check_column(tmp, tag, gate=1e-7):
    """The written column (port against JAX) within ``gate`` of the
    data's largest magnitude, on every tile."""
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / "pristine.ms"))
    for i in range(N_TILES):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(tms.read_tile(i).x, jms.read_tile(i).x,
                                   atol=gate * scale)


def check_solutions(tmp, sky, tag):
    """Solutions atol 1e-6 (the JAX file by the JAX reader, the port's by
    the port's), the headers equal."""
    nchunk = sky.nchunk
    jh, jb = sol.read_solutions(str(tmp / f"{tag}_jax.sol"), nchunk)
    th, tb = tsol.read_solutions(str(tmp / f"{tag}_torch.sol"), nchunk)
    assert th == jh and len(tb) == len(jb) == N_TILES
    np.testing.assert_allclose(np.asarray(tb), np.asarray(jb), atol=1e-6)


def clusters_of(tmp, name):
    """The host sky with cluster file ``name``."""
    return skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / "sky.txt"), RA0, DEC0, 150e6),
        skymodel.parse_cluster_file(str(tmp / name)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_beam",
                    {tag: (FLAGS + f, c) for tag, (f, c) in RUNS.items()})
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(RUNS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_beam_residual_norms_match(runs, tag, key):
    check_residual_norms(runs, tag, key)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_beam_solutions_and_column_match(runs, tag):
    tmp = runs[0]
    check_solutions(tmp, clusters_of(tmp, RUNS[tag][1]), tag)
    check_column(tmp, tag)


def test_beam_runs_take_the_generic_route(runs):
    """No port run called the coherency kernel's entry point; the three
    modes predict differently; residuals fall on every tile."""
    _, _, out, kernel_calls = runs
    assert kernel_calls == 0
    r1 = {tag: [h["res_1"] for h in out[tag][1]] for tag in RUNS}
    assert len({tuple(v) for v in r1.values()}) == 3
    assert all(h["res_1"] < h["res_0"] for tag in RUNS
               for h in out[tag][1])


def test_precessed_sky_matches_reference(runs):
    """Both pipelines precess the sky and the beam pointing to the first
    tile's mid-timeslot epoch, once, before any solve (1e-12 rad)."""
    tmp = runs[0]
    sky = clusters_of(tmp, "sky.txt.cluster")
    argv = ["-d", str(tmp / "pristine.ms"), "-s", str(tmp / "sky.txt"),
            "-c", str(tmp / "sky.txt.cluster"), "-B", "2"]
    jcfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    tcfg = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    jp = pipeline.FullBatchPipeline(jcfg, ds.SimMS(str(tmp / "pristine.ms")),
                                    sky, **QUIET)
    tp = tpipeline.FullBatchPipeline(tcfg, tds.SimMS(str(tmp /
                                                         "pristine.ms")),
                                     sky, device="cpu", **QUIET)
    assert jp.precessed and tp.precessed
    for k in ("ra", "dec"):
        got = getattr(tp.dsky, k).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jp.dsky, k)),
                                   rtol=0, atol=1e-12)
        assert np.abs(got - getattr(sky, k)).max() > 1e-4
    np.testing.assert_allclose([tp.beam_info.ra0, tp.beam_info.dec0],
                               [jp.beam_info.ra0, jp.beam_info.dec0],
                               rtol=0, atol=1e-12)
