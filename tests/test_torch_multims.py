"""``-f`` dataset lists (sagecal_tpu_torch/io/dataset.py: MultiSimMS,
open_dataset) against the JAX package's, float64 on the CPU.

Two SimMS subbands of one observation (8 stations, 2 tiles of 4
timeslots, 2 channels each; the upper part given per-channel flags and
extra row flags, so the parts disagree) are merged by both packages:
the combined tile (data, flags, per-channel flags, frequencies, freq0,
bandwidth) is equal; a list file (with a comment and a blank line) and a
glob open the same dataset, ``-f`` wins over ``-d``, and one listed path
opens alone. Both CLIs then calibrate ``-f`` lists of fresh copies
(``-j 1``, and ``-N 1 -M 2``): the synthesized per-channel flags send the
solve input through the native tile packer, and the residual is split
back per part. Gates (those of test_torch_pipeline.py): per-tile
res_0/res_1 rtol 1e-8 with equal nu, solutions atol 1e-6, each part's
written column 1e-7 of the data's largest magnitude."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagecal_tpu import cli, pipeline, skymodel, stochastic
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch import stochastic as tstochastic
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import native as tnat
from sagecal_tpu_torch.io import solutions as tsol

SKY = """\
P0A 0 40 0 40 0 0 3.0 0 0 0 0 0 0 0 0 150e6
G1A 1 20 0 38 0 0 2.5 0 0 0 -0.7 0 0.0004 0.0002 0.5 150e6
P2A 0 50 0 41 0 0 2.0 0 0 0 0 0 0 0 0 150e6
"""
CLUSTER = "0 1 P0A\n1 2 G1A\n2 1 P2A\n"
PARTS = {"sb_lo.ms": [148e6, 150e6], "sb_hi.ms": [152e6, 154e6]}
N_ST, TILESZ, N_TILES = 8, 4, 2
FLAGS = ["-e", "2", "-g", "10", "-l", "5", "-t", str(TILESZ), "-R", "0",
         "--kernel", "pallas"]
RUNS = {"j1": ["-j", "1"], "stochastic": ["-N", "1", "-M", "2", "-m", "5"]}
QUIET = dict(log=lambda *a: None)


def write_parts(tmp):
    """The two subband SimMS of the observation (``pristine/``), the
    upper one with per-channel flags and extra flagged rows."""
    (tmp / "sky.txt").write_text(SKY)
    (tmp / "sky.txt.cluster").write_text(CLUSTER)
    ra0, dec0 = (41 / 60) * math.pi / 12, 40 * math.pi / 180
    sky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / "sky.txt"), ra0, dec0, 150e6),
        skymodel.parse_cluster_file(str(tmp / "sky.txt.cluster")))
    J = ds.random_jones(sky.n_clusters, sky.nchunk, N_ST, seed=2, scale=0.15)
    dsky = rp.sky_to_device(sky, jnp.float64)
    for k, (name, freqs) in enumerate(PARTS.items()):
        tiles = []
        for i in range(N_TILES):
            t = ds.simulate_dataset(dsky, N_ST, TILESZ, freqs, ra0, dec0,
                                    jones=J, nchunk=sky.nchunk,
                                    noise_sigma=0.01, seed=3 + i,
                                    flag_fraction=0.05,
                                    chan_flag_fraction=0.3 * k)
            if k:
                t.flags[5:9] = 1
            tiles.append(t)
        ds.SimMS.create(str(tmp / "pristine" / name), tiles)
    return sky


def _write_list(tmp, side):
    """Fresh copies of the parts for ``side`` and their list file."""
    paths = []
    for name in PARTS:
        dst = tmp / side / name
        shutil.copytree(tmp / "pristine" / name, dst)
        paths.append(str(dst))
    lst = tmp / f"{side}.list"
    lst.write_text("# subbands\n\n" + "\n".join(reversed(paths)) + "\n")
    return str(lst)


def _run(tmp, tag, flags, side):
    lst = _write_list(tmp, f"{tag}_{side}")
    argv = ["-f", lst, "-s", str(tmp / "sky.txt"), "-c",
            str(tmp / "sky.txt.cluster"), "-p",
            str(tmp / f"{tag}_{side}.sol")] + FLAGS + flags
    if side == "jax":
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            argv + ["--solve-fuse", "off", "--solve-promote", "off"]))
        run = stochastic.run_minibatch if cfg.n_epochs else pipeline.run
        return run(cfg, **QUIET)
    args = tcli.build_parser().parse_args(argv + ["--platform", "cpu"])
    tcli.check_flags(args)
    cfg = tcli.config_from_args(args)
    run = tstochastic.run_minibatch if cfg.n_epochs else tpipeline.run
    return run(cfg, device="cpu", **QUIET)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_multims")
    sky = write_parts(tmp)
    packs = tnat.PACKS
    out = {tag: (_run(tmp, tag, flags, "jax"), _run(tmp, tag, flags,
                                                    "torch"))
           for tag, flags in RUNS.items()}
    yield tmp, sky, out, tnat.PACKS - packs
    torch.set_num_threads(n)


def test_merge_equals_reference(runs):
    tmp = runs[0]
    paths = [str(tmp / "pristine" / p) for p in reversed(PARTS)]
    jm, tm = ds.MultiSimMS(paths), tds.MultiSimMS(paths)
    assert [p.path for p in tm.parts] == [p.path for p in jm.parts]
    assert tm.meta == jm.meta
    assert tm.meta["freq0"] == float(np.mean(sum(PARTS.values(), [])))
    for i in range(N_TILES):
        a, b = tm.read_tile(i), jm.read_tile(i)
        for k in ("x", "flags", "cflags", "u", "sta1", "freqs",
                  "time_mjd"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
        assert (a.freq0, a.fdelta) == (b.freq0, b.fdelta)
        assert a.cflags is not None and a.cflags.shape == (a.nrows, 4)


def test_list_file_glob_and_precedence(runs):
    tmp = runs[0]
    lst = tmp / "all.list"
    lst.write_text("# two subbands\n" + "\n".join(
        str(tmp / "pristine" / p) for p in PARTS) + "\n\n")
    by_list = tds.open_dataset(None, str(lst))
    by_glob = tds.open_dataset(None, str(tmp / "pristine" / "sb_*.ms"))
    # -f wins over -d
    both = tds.open_dataset(str(tmp / "pristine" / "sb_lo.ms"), str(lst))
    for m in (by_list, by_glob, both):
        assert isinstance(m, tds.MultiSimMS)
        assert m.meta == ds.open_dataset(None, str(lst)).meta
    one = tmp / "one.list"
    one.write_text(str(tmp / "pristine" / "sb_hi.ms") + "\n")
    assert isinstance(tds.open_dataset(None, str(one)), tds.SimMS)
    with pytest.raises(ValueError, match="no datasets"):
        tds.open_dataset(None, str(tmp / "nothing_*.ms"))
    with pytest.raises(ValueError, match="need -d"):
        tds.open_dataset(None, None)


def test_casa_table_raises_without_casacore(tmp_path):
    (tmp_path / "x.ms").mkdir()
    (tmp_path / "x.ms" / "table.dat").write_text("")
    with pytest.raises(RuntimeError, match="python-casacore"):
        tds.open_dataset(str(tmp_path / "x.ms"))


@pytest.mark.parametrize("tag", sorted(RUNS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_multims_residual_norms_match(runs, tag, key):
    j, t = runs[2][tag]
    assert len(j) == len(t) == N_TILES
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)
    if "mean_nu" in j[0]:
        assert [h["mean_nu"] for h in t] == [h["mean_nu"] for h in j]


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_multims_solutions_and_parts_match(runs, tag):
    tmp, sky = runs[0], runs[1]
    jh, jb = sol.read_solutions(str(tmp / f"{tag}_jax.sol"), sky.nchunk)
    th, tb = tsol.read_solutions(str(tmp / f"{tag}_torch.sol"), sky.nchunk)
    assert th == jh and len(tb) == N_TILES
    np.testing.assert_allclose(np.asarray(tb), np.asarray(jb), atol=1e-6)
    for name in PARTS:
        raw = tds.SimMS(str(tmp / "pristine" / name))
        jms = ds.SimMS(str(tmp / f"{tag}_jax" / name),
                       data_column="CORRECTED_DATA")
        tms = tds.SimMS(str(tmp / f"{tag}_torch" / name),
                        data_column="CORRECTED_DATA")
        for i in range(N_TILES):
            scale = np.abs(raw.read_tile(i).x).max()
            got = tms.read_tile(i)
            assert got.x.shape == raw.read_tile(i).x.shape
            np.testing.assert_allclose(got.x, jms.read_tile(i).x,
                                       atol=1e-7 * scale)
            # each part keeps its own flags
            assert np.array_equal(got.flags, raw.read_tile(i).flags)


def test_multims_full_batch_packs_natively(runs):
    """The merged per-channel flags send every full-batch tile through
    the native packer (the stochastic run weights channels instead)."""
    assert runs[3] == N_TILES
