"""The port's full-batch calibration end to end against the JAX reference.

One SimMS (the tests/test_pipeline.py fixture: 10 stations, 2 clusters
with 1 and 2 hybrid chunks, 2 tiles of 4 timeslots, 2 channels) is
written once by the JAX package and copied; both CLIs calibrate a copy
with ``-j 1 -e 2 -g 10 -l 5 -t 4 -R 0 --kernel pallas`` (the JAX one
with fuse/promote pinned off, the port with ``--platform cpu``), both in
float64. A second fixture runs both CLIs on fresh copies at the default
solver mode (no ``-j``: 5, which 10 stations downgrade to 3, OS-LM then
OS robust LM), at ``-j 5 --inner cg``, and at ``-j 1 --inflight 2`` on a
second SimMS of 8 clusters (in-flight groups need M >= 8: the width is
clamped to M//4). The same fixture runs ``-j 1``, the default mode and
``-j 5 --inner cg`` once more with no ``--kernel`` flag on either CLI,
so each takes its own default assembly (the reference's XLA normal
equations, the port's fused sweep): the port's default command line is
held against the reference's at the same gates. Gates: per-tile res_0/res_1 rtol 1e-8 (and equal nu),
solutions atol 1e-6, written residual column 1e-7 of the data's largest
magnitude.

The default-mode run solves both clusters as one chunk. With a 2-chunk
cluster the first OS subset (timeslot 0) holds no row of chunk 1, so the
reference seeds that chunk's damping from an all-zero block (mu0 =
1e-33) and its Cholesky steps are regularized by the 1e-9 jitter alone:
float64 roundoff then grows ~1e9-fold along the near-null directions, in
the JAX package as in the port (~2e-6 in J). That route is held to the
reference's own one-ulp spread in test_torch_lm.py and
test_torch_sage_lm.py (``*_two_chunks_within_reference_spread``). The PCG
route does not amplify it, so the ``--inner cg`` run keeps the 2-chunk
cluster."""

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
from sagecal_tpu_torch import convert
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

SKY = """\
P0A 0 40 0 40 0 0 3.0 0 0 0 0 0 0 0 0 150e6
P0B 0 42 0 40 30 0 2.0 0 0 0 0 0 0 0 0 150e6
P1A 1 20 0 38 0 0 2.5 0 0 0 0 0 0 0 0 150e6
"""
CLUSTER = """\
0 1 P0A P0B
1 2 P1A
"""
CLUSTER_ONE_CHUNK = """\
0 1 P0A P0B
1 1 P1A
"""
#: 8 clusters of one source each around the same field (the second
#: cluster in 2 hybrid chunks), for the in-flight group runs
SKY8 = "".join(f"Q{m} 0 {38 + m} 0 {38 + 0.5 * m:.1f} {10 * m} 0 "
               f"{1.5 + 0.25 * m:.2f} 0 0 0 0 0 0 0 0 150e6\n"
               for m in range(8))
CLUSTER8 = "".join(f"{m} {2 if m == 1 else 1} Q{m}\n" for m in range(8))
FLAGS = ["-j", "1", "-e", "2", "-g", "10", "-l", "5", "-t", "4", "-R", "0",
         "--kernel", "pallas"]
#: the default-mode runs: no -j (5, run as 3 at 10 stations) on
#: single-chunk clusters, and -j 5 with the matrix-free inner solver;
#: each with its cluster file
MODE_FLAGS = {"default": ["-e", "2", "-g", "6", "-l", "4", "-t", "4", "-R",
                          "0", "--kernel", "pallas"],
              "cg": ["-j", "5", "--inner", "cg", "-e", "2", "-g", "6", "-l",
                     "4", "-t", "4", "-R", "0", "--kernel", "pallas"],
              "inflight": ["-j", "1", "--inflight", "2", "-e", "2", "-g",
                           "6", "-l", "4", "-t", "4", "-R", "0", "--kernel",
                           "pallas"]}
#: -j 1, the default mode and -j 5 --inner cg with each CLI's default
#: assembly: the runs above (and the module fixture's -j 1) without
#: --kernel
NO_KERNEL_FLAG = {"j1": FLAGS, "default": MODE_FLAGS["default"],
                  "cg": MODE_FLAGS["cg"]}
MODE_FLAGS.update({f"nokernel_{tag}": [f for f in flags
                                        if f not in ("--kernel", "pallas")]
                   for tag, flags in NO_KERNEL_FLAG.items()})
#: (sky, cluster file, pristine SimMS) of each mode run
MODE_FILES = {"default": ("sky.txt", "one_chunk.cluster", "pristine.ms"),
              "cg": ("sky.txt", "sky.txt.cluster", "pristine.ms"),
              "inflight": ("sky8.txt", "sky8.txt.cluster", "pristine8.ms"),
              "nokernel_j1": ("sky.txt", "sky.txt.cluster", "pristine.ms"),
              "nokernel_default": ("sky.txt", "one_chunk.cluster",
                                   "pristine.ms"),
              "nokernel_cg": ("sky.txt", "sky.txt.cluster", "pristine.ms")}
#: what the CPU runs launch: no kernel
NO_LAUNCHES = {"coh": 0, "sweep": 0, "matvec": 0, "visits": 0}


def _both_clis(tmp, tag, flags):
    """Run both CLIs on fresh copies of the fixture's SimMS; returns the
    (JAX, port) histories."""
    sky, clusters, pristine = MODE_FILES[tag]
    for side in ("jax", "torch"):
        shutil.copytree(tmp / pristine, tmp / f"{tag}_{side}.ms")
    common = ["-s", str(tmp / sky), "-c", str(tmp / clusters)]
    jargs = cli.build_parser().parse_args(
        ["-d", str(tmp / f"{tag}_jax.ms"), "-p", str(tmp / f"{tag}_jax.sol")]
        + common + flags + ["--solve-fuse", "off", "--solve-promote", "off"])
    jhist = pipeline.run(cli.config_from_args(jargs), log=lambda *a: None)
    targs = tcli.build_parser().parse_args(
        ["-d", str(tmp / f"{tag}_torch.ms"), "-p",
         str(tmp / f"{tag}_torch.sol")] + common + flags
        + ["--platform", "cpu"])
    thist = tpipeline.run(tcli.config_from_args(targs), device="cpu",
                          log=lambda *a: None)
    return jhist, thist


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    (tmp / "sky.txt").write_text(SKY)
    (tmp / "sky.txt.cluster").write_text(CLUSTER)
    (tmp / "one_chunk.cluster").write_text(CLUSTER_ONE_CHUNK)
    ra0 = (0 + 41 / 60) * math.pi / 12
    dec0 = 40 * math.pi / 180
    srcs = skymodel.parse_sky_model(str(tmp / "sky.txt"), ra0, dec0, 150e6)
    sky = skymodel.build_cluster_sky(
        srcs, skymodel.parse_cluster_file(str(tmp / "sky.txt.cluster")))
    dsky = rp.sky_to_device(sky, jnp.float64)
    Jtrue = ds.random_jones(sky.n_clusters, sky.nchunk, 10, seed=2,
                            scale=0.2)
    tiles = [ds.simulate_dataset(dsky, n_stations=10, tilesz=4,
                                 freqs=[149e6, 151e6], ra0=ra0, dec0=dec0,
                                 jones=Jtrue, nchunk=sky.nchunk,
                                 noise_sigma=0.02, seed=3 + i)
             for i in range(2)]
    ds.SimMS.create(str(tmp / "jax.ms"), tiles)
    shutil.copytree(tmp / "jax.ms", tmp / "torch.ms")
    shutil.copytree(tmp / "jax.ms", tmp / "pristine.ms")
    # the 8-cluster observation of the in-flight group runs
    (tmp / "sky8.txt").write_text(SKY8)
    (tmp / "sky8.txt.cluster").write_text(CLUSTER8)
    sky8 = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / "sky8.txt"), ra0, dec0, 150e6),
        skymodel.parse_cluster_file(str(tmp / "sky8.txt.cluster")))
    J8 = ds.random_jones(sky8.n_clusters, sky8.nchunk, 10, seed=4,
                         scale=0.2)
    ds.SimMS.create(str(tmp / "pristine8.ms"), [
        ds.simulate_dataset(rp.sky_to_device(sky8, jnp.float64),
                            n_stations=10, tilesz=4, freqs=[149e6, 151e6],
                            ra0=ra0, dec0=dec0, jones=J8,
                            nchunk=sky8.nchunk, noise_sigma=0.02, seed=5 + i)
        for i in range(2)])
    common = ["-s", str(tmp / "sky.txt"), "-c", str(tmp / "sky.txt.cluster")]

    jargs = cli.build_parser().parse_args(
        ["-d", str(tmp / "jax.ms"), "-p", str(tmp / "jax.sol")] + common
        + FLAGS + ["--solve-fuse", "off", "--solve-promote", "off"])
    jhist = pipeline.run(cli.config_from_args(jargs), log=lambda *a: None)
    targs = tcli.build_parser().parse_args(
        ["-d", str(tmp / "torch.ms"), "-p", str(tmp / "torch.sol")] + common
        + FLAGS + ["--platform", "cpu"])
    thist = tpipeline.run(tcli.config_from_args(targs), device="cpu",
                          log=lambda *a: None)
    yield dict(tmp=tmp, sky=sky, dsky=dsky, jhist=jhist, thist=thist)
    torch.set_num_threads(n)


@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_tile_residual_norms_match(runs, key):
    j, t = runs["jhist"], runs["thist"]
    assert len(j) == len(t) == 2
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)


def test_residuals_fall_every_tile(runs):
    for h in runs["thist"]:
        assert np.isfinite(h["res_1"]) and h["res_1"] < h["res_0"]
        # the CPU run takes the plain versions: no kernel launches
        assert h["launches"] == NO_LAUNCHES
        assert h["solver_iters"] > 0 and h["lbfgs_iters"] > 0


def test_solutions_match(runs):
    tmp, sky = runs["tmp"], runs["sky"]
    jh, jb = sol.read_solutions(str(tmp / "jax.sol"), sky.nchunk)
    th, tb = tsol.read_solutions(str(tmp / "torch.sol"), sky.nchunk)
    assert th == jh and len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_written_residual_column_matches(runs):
    tmp = runs["tmp"]
    jms = ds.SimMS(str(tmp / "jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / "torch.ms"), data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / "torch.ms"))
    for i in range(2):
        scale = np.abs(raw.read_tile(i).x).max()
        got, want = tms.read_tile(i).x, jms.read_tile(i).x
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-7 * scale)
        assert np.abs(got).mean() < np.abs(raw.read_tile(i).x).mean()


def test_convert_roundtrips_sky(runs):
    dsky = runs["dsky"]
    fields = {k: np.asarray(getattr(dsky, k)) for k in dsky._fields}
    back = convert.sky_to_numpy(convert.sky_from_numpy(fields))
    assert set(back) == set(fields)
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k], err_msg=k)


def test_convert_jones_and_tile():
    rng = np.random.default_rng(0)
    J = rng.normal(size=(2, 3, 4, 2, 2)) + 1j * rng.normal(size=(2, 3, 4, 2, 2))
    r8 = np.stack([J.reshape(2, 3, 4, 4).real, J.reshape(2, 3, 4, 4).imag],
                  -1).reshape(2, 3, 4, 8)
    np.testing.assert_array_equal(convert.jones_from_numpy(J).numpy(), J)
    np.testing.assert_array_equal(convert.jones_from_numpy(r8).numpy(), J)
    t = ds.VisTile(u=np.zeros(3), v=np.zeros(3), w=np.zeros(3),
                   x=np.zeros((3, 1, 2, 2), complex),
                   flags=np.zeros(3, np.int8), sta1=np.zeros(3, np.int32),
                   sta2=np.ones(3, np.int32), freqs=np.array([1.5e8]),
                   freq0=1.5e8, fdelta=1e5, tdelta=1.0, dec0=0.1, ra0=0.2,
                   n_stations=2, nbase=1, tilesz=3)
    tt = convert.tile_from_numpy(**vars(t))
    assert tt.nbase == 1 and tt.x.shape == (3, 1, 2, 2)


def test_port_reads_jax_written_simms(runs):
    """A SimMS written by the JAX package reads back identically."""
    tmp = runs["tmp"]
    a = ds.SimMS(str(tmp / "jax.ms")).read_tile(1)
    b = tds.SimMS(str(tmp / "jax.ms")).read_tile(1)
    for k in ("u", "v", "w", "x", "flags", "sta1", "sta2", "freqs"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


@pytest.fixture(scope="module")
def mode_runs(runs):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {tag: _both_clis(runs["tmp"], tag, flags)
           for tag, flags in MODE_FLAGS.items()}
    yield out
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(MODE_FLAGS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_mode_residual_norms_match(mode_runs, tag, key):
    j, t = mode_runs[tag]
    assert len(j) == len(t) == 2
    np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                               rtol=1e-8)
    assert [h["mean_nu"] for h in t] == [h["mean_nu"] for h in j]


@pytest.mark.parametrize("tag", sorted(MODE_FLAGS))
def test_mode_solutions_and_column_match(runs, mode_runs, tag):
    tmp = runs["tmp"]
    nchunk = [c[1] for c in skymodel.parse_cluster_file(
        str(tmp / MODE_FILES[tag][1]))]
    _, jb = sol.read_solutions(str(tmp / f"{tag}_jax.sol"), nchunk)
    _, tb = tsol.read_solutions(str(tmp / f"{tag}_torch.sol"), nchunk)
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / MODE_FILES[tag][2]))
    for i in range(2):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(tms.read_tile(i).x, jms.read_tile(i).x,
                                   atol=1e-7 * scale)


def test_mode_runs_use_their_solvers(mode_runs):
    """The default mode (3 at 10 stations) is robust: nu moves off its
    start; -j 5 --inner cg takes PCG trips; --inflight 2 solves in groups
    of 2 and counts its rejected groups; residuals fall on every tile and
    the CPU runs launch no kernel."""
    for tag, (_, t) in mode_runs.items():
        for h in t:
            assert np.isfinite(h["res_1"]) and h["res_1"] < h["res_0"]
            assert h["launches"] == NO_LAUNCHES
            assert h["solver_iters"] > 0 and h["lbfgs_iters"] > 0
            assert bool(h["groups"]) == (tag == "inflight")
    assert any(h["mean_nu"] != 2.0 for h in mode_runs["default"][1])
    assert all(h["cg_iters"] > 0 for h in mode_runs["cg"][1])
    t = mode_runs["inflight"][1]
    assert all(h["rejected_groups"] == sum(not g[2] for g in h["groups"])
               and all(len(g[1]) == 2 for g in h["groups"]) for h in t)


@pytest.mark.parametrize("extra", [["--metrics", "m.json"],
                                   ["--prior-cache", "read"],
                                   ["--tile-bucket", "8"],
                                   ["--faults", "x"], ["--profile", "p"],
                                   ["--diag", "x.jsonl"],
                                   ["--prefetch", "0"]])
def test_unported_flags_raise(runs, extra):
    tmp = runs["tmp"]
    argv = ["-d", str(tmp / "torch.ms"), "-s", str(tmp / "sky.txt"),
            "-c", str(tmp / "sky.txt.cluster"), "--platform", "cpu"] + extra
    if "-j" not in extra:
        argv += ["-j", "1"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(argv)


def _cli_run(runs, tmp_path, extra, files):
    """The port's CLI on a fresh copy of a fixture SimMS; checks that it
    writes both tiles' solutions and residuals, the residuals below the
    data on every tile."""
    sky, clusters, pristine = files
    tmp = runs["tmp"]
    shutil.copytree(tmp / pristine, tmp_path / "obs.ms")
    argv = ["-d", str(tmp_path / "obs.ms"), "-s", str(tmp / sky), "-c",
            str(tmp / clusters), "-p", str(tmp_path / "sol.txt"), "-e", "1",
            "-g", "3", "-l", "2", "-t", "4", "--platform", "cpu"] + extra
    assert tcli.main(argv) == 0
    nchunk = [c[1] for c in skymodel.parse_cluster_file(str(tmp / clusters))]
    _, blocks = tsol.read_solutions(str(tmp_path / "sol.txt"), nchunk)
    assert len(blocks) == 2
    out = tds.SimMS(str(tmp_path / "obs.ms"), data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp_path / "obs.ms"))
    for i in range(2):
        assert np.abs(out.read_tile(i).x).mean() < \
            np.abs(raw.read_tile(i).x).mean()


@pytest.mark.parametrize("extra", [[], ["-j", "0"], ["-j", "2"],
                                   ["-j", "3", "--inner", "cg"], ["-j", "4"],
                                   ["-j", "6", "-L", "3", "-H", "20"],
                                   ["--inflight", "2"],
                                   ["-j", "1", "--inflight", "2"]])
def test_cli_runs_solver_modes(runs, tmp_path, extra):
    """The port's CLI runs to the end with no -j (the default 5) and at
    every other mode, with -L/-H accepted, and with in-flight groups on
    the 8-cluster sky, writing residuals and solutions; residuals fall on
    every tile."""
    _cli_run(runs, tmp_path, extra,
             MODE_FILES["inflight" if "--inflight" in extra else "cg"])


@pytest.mark.parametrize("mode", ["0", "2", "3", "4", "5", "6"])
def test_cli_inflight_every_mode(runs, tmp_path, mode):
    """--inflight 2 on the 8-cluster sky at every other solver mode (at 10
    stations 4 runs as 0, and 5 and 6 as 3: the LMCUT downgrade)."""
    _cli_run(runs, tmp_path, ["-j", mode, "--inflight", "2"],
             MODE_FILES["inflight"])


def test_cli_missing_args():
    assert tcli.main([]) == 2
