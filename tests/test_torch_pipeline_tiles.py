"""``--tile-batch`` end to end: both CLIs at ``--tile-batch 2`` on a
5-tile SimMS (the tests/test_torch_pipeline.py sky: 10 stations, clusters
of 1 and 2 hybrid chunks, tiles of 4 timeslots, 2 channels, a tenth of
each tile's rows flagged with the tile's own seed, so that the lanes of
a batch carry weights of their own; and its 8-cluster sky for the
groups), float64, ``-R 0``:

- ``-j 1 --kernel pallas``;
- ``-j 5 --inner cg --kernel pallas`` (10 stations run it as OS robust LM
  with PCG, the LMCUT downgrade);
- ``-j 1 --inflight 2 --kernel pallas`` on 8 clusters (groups of 2 in
  every tile of a batch: 2 x 2 lanes a group step);
- ``-j 1 --kernel xla`` (the XLA assembly in every lane);
- ``-j 1 --jones diag --kernel pallas``.

Tile 0 solves alone with the first-tile boost, tiles 1-2 and 3-4 as two
batches, each tile of a batch warm-started from the solution carried into
it. Gates as in tests/test_torch_pipeline.py: per-tile res_0/res_1 rtol
1e-8 with nu equal, solutions atol 1e-6, the written residual column 1e-7
of the data's largest magnitude.

The port alone: a batched run is the sequential one with the warm start
per batch (every tile replayed by a solo solve from the batch's J0, and
a short tail solo from its predecessor); ``--tile-batch 0`` and ``-1``
run tile by tile, as in the JAX CLI; a divergence reset inside a batch
is applied in order and re-arms the boost for the next tile; the
batch's launches count once.

The CLI runs are split by family so that their solves spread over
workers: this file runs ``-j 1`` and ``-j 5 --inner cg`` (and the port
alone); test_torch_pipeline_tiles_routes.py the groups, the XLA assembly
and ``--jones diag``, with the helpers here."""

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

from test_torch_pipeline import CLUSTER, CLUSTER8, NO_LAUNCHES, SKY, SKY8

N_TILES = 5
COMMON = ["-e", "2", "-g", "6", "-l", "4", "-t", "4", "-R", "0",
          "--tile-batch", "2"]
#: tag -> (CLI flags, sky, cluster file, pristine SimMS)
RUNS = {
    "j1": (["-j", "1", "--kernel", "pallas"], "sky.txt", "sky.txt.cluster",
           "pristine.ms"),
    "cg": (["-j", "5", "--inner", "cg", "--kernel", "pallas"], "sky.txt",
           "sky.txt.cluster", "pristine.ms"),
    "inflight": (["-j", "1", "--inflight", "2", "--kernel", "pallas"],
                 "sky8.txt", "sky8.txt.cluster", "pristine8.ms"),
    "xla": (["-j", "1", "--kernel", "xla"], "sky.txt", "sky.txt.cluster",
            "pristine.ms"),
    "diag": (["-j", "1", "--jones", "diag", "--kernel", "pallas"],
             "sky.txt", "sky.txt.cluster", "pristine.ms"),
}
RA0 = (0 + 41 / 60) * math.pi / 12
DEC0 = 40 * math.pi / 180


def _simulate(tmp, sky_name, cluster_name, out, seed):
    sky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / sky_name), RA0, DEC0, 150e6),
        skymodel.parse_cluster_file(str(tmp / cluster_name)))
    J = ds.random_jones(sky.n_clusters, sky.nchunk, 10, seed=seed,
                        scale=0.2)
    ds.SimMS.create(str(tmp / out), [
        ds.simulate_dataset(rp.sky_to_device(sky, jnp.float64),
                            n_stations=10, tilesz=4, freqs=[149e6, 151e6],
                            ra0=RA0, dec0=DEC0, jones=J, nchunk=sky.nchunk,
                            noise_sigma=0.02, flag_fraction=0.1,
                            seed=seed + 1 + i)
        for i in range(N_TILES)])


def _port_run(tmp, name, flags, sky="sky.txt", clus="sky.txt.cluster",
              pristine="pristine.ms", log=None):
    """The port's pipeline on a fresh copy of ``pristine``: (history,
    pipeline) on the CPU."""
    shutil.copytree(tmp / pristine, tmp / f"{name}.ms")
    args = tcli.build_parser().parse_args(
        ["-d", str(tmp / f"{name}.ms"), "-p", str(tmp / f"{name}.sol"),
         "-s", str(tmp / sky), "-c", str(tmp / clus)] + flags
        + ["--platform", "cpu"])
    cfg = tcli.config_from_args(args)
    ms = tds.open_dataset(cfg.ms, None)
    meta = ms.meta
    tsky = tpipeline.skymodel.read_sky_cluster(
        cfg.sky_model, cfg.cluster_file, meta["ra0"], meta["dec0"],
        meta["freq0"], cfg.format_3)
    pipe = tpipeline.FullBatchPipeline(cfg, ms, tsky, device="cpu",
                                       log=log or (lambda *a: None))
    hist = pipe.run(solution_path=cfg.solutions_file,
                    max_tiles=cfg.max_timeslots or None)
    return hist, pipe


#: this file's CLI runs
TAGS = ("cg", "j1")


def make_tiles_runs(tmp_path_factory, name, tags):
    """Both CLIs per RUNS entry of ``tags`` on fresh copies of its SimMS:
    (tmp, tag -> (JAX history, port history))."""
    tmp = tmp_path_factory.mktemp(name)
    for name, text in (("sky.txt", SKY), ("sky.txt.cluster", CLUSTER),
                       ("sky8.txt", SKY8), ("sky8.txt.cluster", CLUSTER8)):
        (tmp / name).write_text(text)
    _simulate(tmp, "sky.txt", "sky.txt.cluster", "pristine.ms", 2)
    _simulate(tmp, "sky8.txt", "sky8.txt.cluster", "pristine8.ms", 4)
    out = {}
    for tag in tags:
        flags, sky, clus, pristine = RUNS[tag]
        common = ["-s", str(tmp / sky), "-c", str(tmp / clus)] + COMMON
        shutil.copytree(tmp / pristine, tmp / f"{tag}_jax.ms")
        jargs = cli.build_parser().parse_args(
            ["-d", str(tmp / f"{tag}_jax.ms"), "-p",
             str(tmp / f"{tag}_jax.sol")] + common + flags
            + ["--solve-fuse", "off", "--solve-promote", "off"])
        jhist = pipeline.run(cli.config_from_args(jargs), log=lambda *a: None)
        thist, _ = _port_run(tmp, f"{tag}_torch", COMMON + flags, sky, clus,
                             pristine)
        out[tag] = (jhist, thist)
    return tmp, out


@pytest.fixture(scope="module")
def tiles_runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield make_tiles_runs(tmp_path_factory, "torch_pipeline_tiles", TAGS)
    torch.set_num_threads(n)


def _solutions(tmp, name, clus, reader):
    nchunk = [c[1] for c in skymodel.parse_cluster_file(str(tmp / clus))]
    return reader(str(tmp / f"{name}.sol"), nchunk)[1]


def check_residual_norms(tiles_runs, tag, key):
    """Per-tile res_0/res_1 rtol 1e-8 with nu equal."""
    j, t = tiles_runs[1][tag]
    assert len(j) == len(t) == N_TILES
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)
    assert [h["mean_nu"] for h in t] == [h["mean_nu"] for h in j]


def check_solutions_and_column(tiles_runs, tag):
    """Solutions atol 1e-6, the written column 1e-7 of the data's largest
    magnitude."""
    tmp = tiles_runs[0]
    clus, pristine = RUNS[tag][2], RUNS[tag][3]
    jb = _solutions(tmp, f"{tag}_jax", clus, sol.read_solutions)
    tb = _solutions(tmp, f"{tag}_torch", clus, tsol.read_solutions)
    assert len(tb) == len(jb) == N_TILES
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / pristine))
    for i in range(N_TILES):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(tms.read_tile(i).x, jms.read_tile(i).x,
                                   atol=1e-7 * scale)


def check_batches(tiles_runs, tag):
    """Tile 0 solo, then two batches of 2; residuals fall on every tile;
    the CPU run launches no kernel; the XLA run counts its XLA solves
    once a batch (on the batch's first tile), the others none; the diag
    run's off-diagonals are 0; the groups run solves in groups of 2."""
    tmp, out = tiles_runs
    t = out[tag][1]
    assert [h["batch"] and h["batch"]["tiles"] for h in t] == \
        [None, [1, 2], [1, 2], [3, 4], [3, 4]]
    for i, h in enumerate(t):
        assert np.isfinite(h["res_1"]) and h["res_1"] < h["res_0"]
        assert h["launches"] == NO_LAUNCHES
        assert h["solver_iters"] > 0 and h["lbfgs_iters"] > 0
        assert bool(h["groups"]) == (tag == "inflight")
        assert (h["xla_solves"] > 0) == (tag == "xla" and i in (0, 1, 3))
        assert all(len(g[1]) == 2 for g in h["groups"])
    if tag == "diag":
        for J in _solutions(tmp, "diag_torch", RUNS[tag][2],
                            tsol.read_solutions):
            assert not J[..., 0, 1].any() and not J[..., 1, 0].any()


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_tiles_residual_norms_match(tiles_runs, tag, key):
    check_residual_norms(tiles_runs, tag, key)


@pytest.mark.parametrize("tag", TAGS)
def test_tiles_solutions_and_column_match(tiles_runs, tag):
    check_solutions_and_column(tiles_runs, tag)


@pytest.mark.parametrize("tag", TAGS)
def test_tiles_runs_batch_after_the_solo_tile(tiles_runs, tag):
    check_batches(tiles_runs, tag)


@pytest.fixture(scope="module")
def warm_runs(tiles_runs):
    """The port at -j 1 on 4 tiles (-T 4): --tile-batch 2 (tile 0 solo,
    tiles 1-2 a batch, tile 3 the short tail) and --tile-batch 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tiles_runs[0]
    flags = ["-j", "1", "-e", "2", "-g", "6", "-l", "4", "-t", "4", "-R",
             "0", "-T", "4"]
    batched, pipe = _port_run(tmp, "warm_b2", flags + ["--tile-batch", "2"])
    serial, _ = _port_run(tmp, "warm_b1", flags)
    yield tmp, pipe, batched, serial
    torch.set_num_threads(n)


def test_batch_differs_only_by_its_warm_start(warm_runs):
    """Each tile of the batched run is the solo solve of the sequential
    path from the warm start the batch gives it: tile 0 from the identity
    with the boost (the sequential run's tile 0, bit for bit), tiles 1
    and 2 both from tile 0's solution, the tail tile 3 from tile 2's.
    Tile 2 of the sequential run starts from tile 1's instead, so it
    differs."""
    tmp, pipe, batched, serial = warm_runs
    assert [h["batch"] and h["batch"]["tiles"] for h in batched] == \
        [None, [1, 2], [1, 2], None]
    assert batched[0] == {**serial[0], **{k: batched[0][k] for k in (
        "minutes", "read_s", "solve_s", "em_s", "refine_s", "residual_s",
        "write_s")}}
    J = {}
    starts = {0: None, 1: 0, 2: 0, 3: 2}
    for ti, src in starts.items():
        stg = pipe.stage(tds.SimMS(str(tmp / "pristine.ms")).read_tile(ti))
        J0 = pipe.initial_jones() if src is None else J[src]
        J[ti], info = pipe.solve(stg, J0, ti, pipe.boost if ti == 0 else 1,
                                 warm=ti > 0)
        for key in ("res_0", "res_1"):
            np.testing.assert_allclose(batched[ti][key], float(info[key]),
                                       rtol=1e-10, err_msg=f"tile {ti}")
        assert batched[ti]["mean_nu"] == float(info["mean_nu"])
        assert batched[ti]["solver_iters"] == info["solver_iters"]
    # the solutions file holds 7 digits of each chunk's Jones
    tb = _solutions(tmp, "warm_b2", "sky.txt.cluster", tsol.read_solutions)
    for ti in starts:
        for m, nck in enumerate(pipe.sky.nchunk):
            np.testing.assert_allclose(tb[ti][m, :nck], J[ti][m, :nck],
                                       atol=1e-6)
    assert serial[2]["res_0"] != batched[2]["res_0"]
    assert serial[1]["res_0"] == batched[1]["res_0"]


@pytest.mark.parametrize("width", ["0", "-1"])
def test_tile_batch_below_one_runs_tile_by_tile(warm_runs, width):
    tmp, _, _, serial = warm_runs
    hist, _ = _port_run(tmp, f"warm_w{width}", [
        "-j", "1", "-e", "2", "-g", "6", "-l", "4", "-t", "4", "-R", "0",
        "-T", "4", "--tile-batch", width])
    assert [(h["res_0"], h["res_1"], h["batch"]) for h in hist] == \
        [(h["res_0"], h["res_1"], h["batch"]) for h in serial]


def test_reset_inside_a_batch_rearms_the_boost(warm_runs, monkeypatch):
    """A divergence of tile 1 inside the batch (1, 2): tile 1 is reset
    (its solutions the identity) and the in-order checks go on, so tile 2
    is still posted from the batch (its residual checked against tile
    1's); the reset re-armed the boost, so tile 3 solves alone with it,
    and tile 4, the stream's short tail, alone without."""
    tmp = warm_runs[0]
    calls = []
    solve, solve_tiles = (tpipeline.FullBatchPipeline.solve,
                          tpipeline.FullBatchPipeline.solve_tiles)

    def spy_solve(self, stg, J0, ti, boost, warm=False):
        calls.append(("solo", ti, boost, warm))
        return solve(self, stg, J0, ti, boost, warm)

    def bad_tiles(self, stgs, J0, tile_ids):
        calls.append(("batch", list(tile_ids)))
        J, info = solve_tiles(self, stgs, J0, tile_ids)
        if tile_ids[0] == 1:
            info["res_1"] = info["res_1"].copy()
            info["res_1"][0] = 1e3
        return J, info

    monkeypatch.setattr(tpipeline.FullBatchPipeline, "solve", spy_solve)
    monkeypatch.setattr(tpipeline.FullBatchPipeline, "solve_tiles",
                        bad_tiles)
    logs = []
    hist, pipe = _port_run(tmp, "reset_b2", [
        "-j", "1", "-e", "1", "-g", "4", "-l", "2", "-t", "4", "-R", "0",
        "--tile-batch", "2"], log=logs.append)
    assert calls == [("solo", 0, pipe.boost, False), ("batch", [1, 2]),
                     ("solo", 3, pipe.boost, False), ("solo", 4, 1, True)]
    assert "tile 1: Resetting Solution" in logs
    tb = _solutions(tmp, "reset_b2", "sky.txt.cluster", tsol.read_solutions)
    np.testing.assert_array_equal(tb[1], pipe.initial_jones())
    assert not np.array_equal(tb[2], pipe.initial_jones())
    assert [h["batch"] and h["batch"]["tiles"] for h in hist] == \
        [None, [1, 2], [1, 2], None, None]
