"""``--resume`` (sagecal_tpu_torch/pipeline.py and io/solutions.py: the
tile-boundary checkpoint sidecar) on the observation of
test_torch_pipeline_options.py (8 stations, 3 tiles of 5 timeslots, 4
channels, 3 clusters), float64 on the CPU, at ``-j 1``:

- a port run killed at tile 1 (its residual write raising), then
  resumed, is bitwise the uninterrupted port run: every written column
  and the solutions file's bytes, the sidecar removed at the end; at
  ``-R 0`` and ``-R 1`` (a resumed tile's draws depend on its index
  alone);
- ``--resume`` without a checkpoint is a fresh run; a checkpoint of a
  different run, or a solutions file shorter than its watermark, is
  refused;
- sidecars interchange: a port sidecar loads in the JAX package and a
  JAX one in the port, and a JAX run killed at tile 1 resumes in the
  port within the pipeline gates of the JAX uninterrupted run (res_0 and
  res_1 rtol 1e-8, solutions atol 1e-6, the column 1e-7 of the data's
  largest magnitude);
- ``--tile-batch 2`` and ``-N`` start fresh, saying so."""

import shutil

import numpy as np
import pytest
import torch

from sagecal_tpu import cli, pipeline
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch import stochastic as tstochastic
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

from test_torch_pipeline_stochastic import write_obs

N_TILES = 3
FLAGS = ["-j", "1", "-e", "2", "-g", "10", "-l", "5", "-t", "5",
         "--kernel", "pallas"]


class Killed(RuntimeError):
    pass


def _argv(tmp, tag, extra):
    return ["-d", str(tmp / f"{tag}.ms"), "-s", str(tmp / "sky.txt"), "-c",
            str(tmp / "sky.txt.cluster"), "-p", str(tmp / f"{tag}.sol")] \
        + FLAGS + extra


def port_run(tmp, tag, extra, kill_at=None, fresh=True, logs=None):
    """The port's CLI path on ``tag``'s SimMS (a fresh copy when
    ``fresh``); ``kill_at``: the residual write of that tile raises."""
    if fresh:
        shutil.copytree(tmp / "pristine.ms", tmp / f"{tag}.ms")
    args = tcli.build_parser().parse_args(_argv(tmp, tag, extra)
                                          + ["--platform", "cpu"])
    tcli.check_flags(args)
    cfg = tcli.config_from_args(args)
    log = (lambda *a: None) if logs is None else logs.append
    real = tds.SimMS.write_tile

    def write(self, i, tile, column=None):
        if i == kill_at:
            raise Killed(f"killed at tile {i}")
        return real(self, i, tile, column)

    tds.SimMS.write_tile = write
    try:
        if cfg.n_epochs:
            return tstochastic.run_minibatch(cfg, device="cpu", log=log)
        return tpipeline.run(cfg, device="cpu", log=log)
    finally:
        tds.SimMS.write_tile = real


def jax_run(tmp, tag, extra, kill_at=None):
    shutil.copytree(tmp / "pristine.ms", tmp / f"{tag}.ms")
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        _argv(tmp, tag, extra) + ["--solve-fuse", "off", "--solve-promote",
                                  "off", "--prefetch", "0"]))
    real = ds.SimMS.write_tile

    def write(self, i, tile, column=None):
        if i == kill_at:
            raise Killed(f"killed at tile {i}")
        return real(self, i, tile, column)

    ds.SimMS.write_tile = write
    try:
        return pipeline.run(cfg, log=lambda *a: None)
    finally:
        ds.SimMS.write_tile = real


def columns(tmp, tag):
    ms = tds.SimMS(str(tmp / f"{tag}.ms"), data_column="CORRECTED_DATA")
    return [ms.read_tile(i).x for i in range(N_TILES)]


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_resume")
    sky = write_obs(tmp, n_tiles=N_TILES)
    yield tmp, sky
    torch.set_num_threads(n)


@pytest.mark.parametrize("randomize", ["0", "1"])
def test_killed_and_resumed_is_bitwise_uninterrupted(obs, randomize):
    tmp = obs[0]
    extra = ["-R", randomize]
    full = port_run(tmp, f"full_r{randomize}", extra)
    tag = f"killed_r{randomize}"
    with pytest.raises(Killed):
        port_run(tmp, tag, extra, kill_at=1)
    ck = tsol.load_checkpoint(tsol.checkpoint_path(str(tmp / f"{tag}.sol")))
    assert ck["tile"] == 0
    # the killed tile's solutions were written past the watermark
    assert (tmp / f"{tag}.sol").stat().st_size > ck["sol_bytes"]
    logs = []
    resumed = port_run(tmp, tag, extra + ["--resume"], fresh=False,
                       logs=logs)
    assert any("resume: checkpoint at tile 0" in str(m) for m in logs)
    assert [h["tile"] for h in resumed] == [1, 2]
    assert [h["res_1"] for h in resumed] == [h["res_1"] for h in full[1:]]
    assert (tmp / f"{tag}.sol").read_bytes() == \
        (tmp / f"full_r{randomize}.sol").read_bytes()
    for a, b in zip(columns(tmp, tag), columns(tmp, f"full_r{randomize}")):
        assert np.array_equal(a, b)
    assert not (tmp / f"{tag}.sol.ckpt.npz").exists()
    assert not (tmp / f"full_r{randomize}.sol.ckpt.npz").exists()


def test_resume_without_checkpoint_is_fresh(obs):
    tmp = obs[0]
    logs = []
    port_run(tmp, "fresh", ["-R", "0"])
    port_run(tmp, "fresh_resume", ["-R", "0", "--resume"], logs=logs)
    assert "resume: no checkpoint found; starting fresh" in logs
    assert (tmp / "fresh.sol").read_bytes() == \
        (tmp / "fresh_resume.sol").read_bytes()
    for a, b in zip(columns(tmp, "fresh"), columns(tmp, "fresh_resume")):
        assert np.array_equal(a, b)


def test_mismatched_or_inconsistent_checkpoint_refused(obs):
    tmp = obs[0]
    with pytest.raises(Killed):
        port_run(tmp, "refuse", ["-R", "0"], kill_at=1)
    ckpt = tsol.checkpoint_path(str(tmp / "refuse.sol"))
    # another run's shape: resuming with -T 2 asks for 2 tiles, not 3
    with pytest.raises(ValueError, match="different run"):
        port_run(tmp, "refuse", ["-R", "0", "--resume", "-T", "2"],
                 fresh=False)
    ck = tsol.load_checkpoint(ckpt)
    with open(tmp / "refuse.sol", "r+") as f:
        f.truncate(ck["sol_bytes"] - 10)
    with pytest.raises(ValueError, match="shorter"):
        port_run(tmp, "refuse", ["-R", "0", "--resume"], fresh=False)


def test_sidecars_interchange(tmp_path):
    meta = dict(n_tiles=3, n_stations=8, n_clusters=3, kmax=2, tilesz=5)
    J = np.random.default_rng(1).normal(size=(3, 2, 8, 2, 2)) * (1 + 1j)
    kw = dict(tile=1, J=J, first=False, res_prev=0.25, inflight=2,
              sol_bytes=1234, meta=meta)
    tsol.save_checkpoint(str(tmp_path / "t.npz"), **kw)
    sol.save_checkpoint(str(tmp_path / "j.npz"), **kw)
    for path in ("t.npz", "j.npz"):
        for load in (tsol.load_checkpoint, sol.load_checkpoint):
            ck = load(str(tmp_path / path), expect_meta=meta)
            assert np.array_equal(ck["J"], J)
            assert {k: ck[k] for k in ("tile", "first", "res_prev",
                                       "inflight", "sol_bytes")} == \
                {k: kw[k] for k in ("tile", "first", "res_prev",
                                    "inflight", "sol_bytes")}
    tsol.save_checkpoint(str(tmp_path / "n.npz"), **dict(kw, res_prev=None))
    assert sol.load_checkpoint(str(tmp_path / "n.npz"))["res_prev"] is None
    assert tsol.load_checkpoint(str(tmp_path / "none.npz")) is None


def test_jax_sidecar_resumes_in_the_port(obs):
    tmp, sky = obs
    ref = jax_run(tmp, "jax_full", ["-R", "0"])
    with pytest.raises(Killed):
        jax_run(tmp, "handover", ["-R", "0"], kill_at=1)
    assert sol.load_checkpoint(str(tmp / "handover.sol.ckpt.npz"))[
        "tile"] == 0
    resumed = port_run(tmp, "handover", ["-R", "0", "--resume"],
                       fresh=False)
    assert [h["tile"] for h in resumed] == [1, 2]
    for key in ("res_0", "res_1"):
        np.testing.assert_allclose([h[key] for h in resumed],
                                   [h[key] for h in ref[1:]], rtol=1e-8)
    assert [h["mean_nu"] for h in resumed] == \
        [h["mean_nu"] for h in ref[1:]]
    _, jb = sol.read_solutions(str(tmp / "jax_full.sol"), sky.nchunk)
    _, tb = tsol.read_solutions(str(tmp / "handover.sol"), sky.nchunk)
    np.testing.assert_allclose(np.asarray(tb), np.asarray(jb), atol=1e-6)
    raw = tds.SimMS(str(tmp / "pristine.ms"))
    jcol = ds.SimMS(str(tmp / "jax_full.ms"), data_column="CORRECTED_DATA")
    for i, got in enumerate(columns(tmp, "handover")):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(got, jcol.read_tile(i).x,
                                   atol=1e-7 * scale)
    assert not (tmp / "handover.sol.ckpt.npz").exists()


@pytest.mark.parametrize("extra,msg", [
    (["--tile-batch", "2"], "resume: unsupported on the --tile-batch "
     "driver; starting fresh"),
    (["-N", "1", "-M", "2", "-m", "5"],
     "resume: unsupported in stochastic mode; starting fresh")],
    ids=["tile_batch", "stochastic"])
def test_batched_and_stochastic_start_fresh(obs, extra, msg):
    tmp = obs[0]
    tag = "fresh_" + extra[0].strip("-").replace("-", "_")
    port_run(tmp, tag, ["-R", "0"] + extra)
    logs = []
    port_run(tmp, tag + "_resume", ["-R", "0", "--resume"] + extra,
             logs=logs)
    assert msg in logs
    assert (tmp / f"{tag}.sol").read_bytes() == \
        (tmp / f"{tag}_resume.sol").read_bytes()
    assert not (tmp / f"{tag}_resume.sol.ckpt.npz").exists()
