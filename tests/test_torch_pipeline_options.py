"""The full-batch solve and correction options and the ``-q`` warm start,
both CLIs end to end on one SimMS (the stochastic tests' observation:
8 stations, 5 timeslots, 4 channels, 3 clusters of which one is a
2-chunk gaussian; 3 tiles, so that ``--tile-batch 2`` solves a batch
after the solo tile 0), float64 on the CPU, at ``-j 1 -e 2 -g 10 -l 5
-R 0 --kernel pallas``:

- ``-W 1`` (uv-density whitening of the solve input), also under
  ``--tile-batch 2``;
- ``-b 1`` (per-channel LBFGS solves from the joint solution, their
  residuals, the last channel's solutions carried), also with
  ``--tile-batch 2``, which runs tile by tile;
- ``-J 1 -k 1`` (the residual corrected by the 2-chunk cluster's
  phases);
- ``--linsolv 0`` and ``2``, which select nothing: each CLI's outputs
  equal its run without the flag;
- ``-q`` from the JAX run's solution file.

Gates (those of test_torch_pipeline.py): per-tile res_0/res_1 rtol 1e-8
with equal nu, solutions atol 1e-6, the written column 1e-7 of the data's
largest magnitude. The simulation modes and the stochastic runs of the
same options are in test_torch_pipeline_sim.py and
test_torch_pipeline_stochastic_options.py, which use the helpers here."""

import shutil

import numpy as np
import pytest
import torch

from sagecal_tpu import cli, pipeline, stochastic
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch import stochastic as tstochastic
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

from test_torch_pipeline_stochastic import write_obs

N_TILES = 3
FLAGS = ["-j", "1", "-e", "2", "-g", "10", "-l", "5", "-t", "5", "-R", "0",
         "--kernel", "pallas"]
#: full-batch runs: tag -> flags after FLAGS ("@base" is the base run's
#: JAX solution file)
RUNS = {
    "base": [],
    "whiten": ["-W", "1"],
    "whiten_batch": ["-W", "1", "--tile-batch", "2"],
    "bandpass": ["-b", "1"],
    "bandpass_batch": ["-b", "1", "--tile-batch", "2"],
    "phase_only": ["-J", "1", "-k", "1"],
    "linsolv0": ["--linsolv", "0"],
    "linsolv2": ["--linsolv", "2"],
    "warm": ["-q", "@base"],
}
QUIET = dict(log=lambda *a: None)


def _resolve(tmp, flags):
    """Flags with the module's named files in place of their tags."""
    files = {"@base": tmp / "base_jax.sol", "@w2": tmp / "n_w2_jax.sol",
             "@ignore": tmp / "ignore.txt"}
    return [str(files[f]) if f in files else f for f in flags]


def run_cli(tmp, tag, flags, side, sim=False):
    """One CLI's run on a fresh copy of the SimMS, writing its solutions
    beside it (but for a simulation, ``sim``, where -p is an input): its
    history (None for the JAX simulation, which returns none)."""
    ms = tmp / f"{tag}_{side}.ms"
    shutil.copytree(tmp / "pristine.ms", ms)
    argv = ["-d", str(ms), "-s", str(tmp / "sky.txt"), "-c",
            str(tmp / "sky.txt.cluster")] + _resolve(tmp, flags)
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


def both_clis(tmp_path_factory, name, runs, sim=False, base=False):
    """The observation in a fresh directory (with the -z file naming
    cluster 1), the JAX base run when ``base`` (its solutions are the
    "@base" file), then both CLIs' run of every (tag, flags) in ``runs``
    on fresh copies of the SimMS: (tmp, sky, tag -> (JAX history, port
    history)). ``sim``: the runs simulate (-p is their input)."""
    tmp = tmp_path_factory.mktemp(name)
    sky = write_obs(tmp, n_tiles=N_TILES)
    (tmp / "ignore.txt").write_text("# clusters to leave out\n1\n")
    if base:
        run_cli(tmp, "base", FLAGS, "jax")
    out = {tag: tuple(run_cli(tmp, tag, flags, side, sim)
                      for side in ("jax", "torch"))
           for tag, flags in runs.items()}
    return tmp, sky, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_options",
                    {tag: FLAGS + f for tag, f in RUNS.items()})
    torch.set_num_threads(n)


def check_residual_norms(runs, tag, key, nu=True):
    """Per-tile ``key`` rtol 1e-8 (and equal nu with ``nu``)."""
    j, t = runs[2][tag]
    assert len(j) == len(t) == N_TILES
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)
    if nu:
        assert [h["mean_nu"] for h in t] == [h["mean_nu"] for h in j]


def columns(tmp, tag):
    """Per tile the (port, JAX) written columns of run ``tag``."""
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    return [(tms.read_tile(i).x, jms.read_tile(i).x)
            for i in range(N_TILES)]


def check_solutions_and_column(runs, tag):
    """Solutions atol 1e-6 (both readers), the written column 1e-7 of
    the data's largest magnitude."""
    tmp, sky, _ = runs
    jh, jb = sol.read_solutions(str(tmp / f"{tag}_jax.sol"), sky.nchunk)
    th, tb = tsol.read_solutions(str(tmp / f"{tag}_torch.sol"), sky.nchunk)
    assert th == jh and len(tb) == len(jb) == N_TILES
    np.testing.assert_allclose(np.asarray(tb), np.asarray(jb), atol=1e-6)
    raw = tds.SimMS(str(tmp / "pristine.ms"))
    for i, (got, want) in enumerate(columns(tmp, tag)):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(got, want, atol=1e-7 * scale)


@pytest.mark.parametrize("tag", sorted(RUNS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_options_residual_norms_match(runs, tag, key):
    check_residual_norms(runs, tag, key)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_options_solutions_and_column_match(runs, tag):
    check_solutions_and_column(runs, tag)


@pytest.mark.parametrize("tag", ["linsolv0", "linsolv2"])
def test_linsolv_selects_nothing(runs, tag):
    """--linsolv 0 and 2 give each CLI exactly its run without the flag."""
    tmp, _, out = runs
    for side, k in (("jax", 0), ("torch", 1)):
        assert [h["res_1"] for h in out[tag][k]] == \
            [h["res_1"] for h in out["base"][k]]
        assert (tmp / f"{tag}_{side}.sol").read_text() == \
            (tmp / f"base_{side}.sol").read_text()
    for (a, _), (b, _) in zip(columns(tmp, tag), columns(tmp, "base")):
        np.testing.assert_array_equal(a, b)


def test_bandpass_solves_every_channel(runs):
    """-b 1: the joint solve runs no refine; every channel's LBFGS fit
    lowers its cost; --tile-batch 2 runs tile by tile to the same
    result; the written solutions are the last channel's (not the
    joint solve's)."""
    tmp, sky, out = runs
    t = out["bandpass"][1]
    for h in t:
        assert h["lbfgs_iters"] == 0 and h["batch"] is None
        assert len(h["channels"]) == 4
        assert all(0 < c["lbfgs_iters"] <= 5 and c["res_1"] < c["res_0"]
                   for c in h["channels"])
    tb = out["bandpass_batch"][1]
    assert [h["res_1"] for h in tb] == [h["res_1"] for h in t]
    assert all(h["batch"] is None for h in tb)
    assert (tmp / "bandpass_batch_torch.sol").read_text() == \
        (tmp / "bandpass_torch.sol").read_text()
    _, bp = tsol.read_solutions(str(tmp / "bandpass_torch.sol"), sky.nchunk)
    _, base = tsol.read_solutions(str(tmp / "base_torch.sol"), sky.nchunk)
    assert not np.allclose(np.asarray(bp), np.asarray(base), atol=1e-6)


def test_whiten_batch_solves_a_batch(runs):
    """-W 1 changes the solve; under --tile-batch 2 tiles 1-2 solve as
    one batch."""
    out = runs[2]
    assert [h["res_0"] for h in out["whiten"][1]] != \
        [h["res_0"] for h in out["base"][1]]
    t = out["whiten_batch"][1]
    assert t[0]["batch"] is None and t[1]["batch"]["tiles"] == [1, 2]


def test_warm_start_moves_the_start(runs):
    """-q from the base run's file: tile 0 starts from its last interval,
    not from the identity (whose tile-0 fit is as good here: the solve
    intervals are 5 timeslots of 8 stations), in both CLIs."""
    out = runs[2]
    for k in (0, 1):
        assert out["warm"][k][0]["res_0"] != out["base"][k][0]["res_0"]
