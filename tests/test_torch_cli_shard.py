"""``--shard-baselines`` on the port's full-batch CLI (one subband's rows
over ranks, ``sagecal_tpu_torch/parallel.py``) against the JAX CLI's
``--shard-baselines`` on the conftest's 8-device CPU mesh, in float64 at
``-R 0``.

The observation: 10 stations (45 baselines), one tile of 5 timeslots, 2
channels, 8 clusters (cluster 1 in 2 hybrid chunks), 5% of the rows
flagged, a synthetic station beam stored with it. Both sides pad: the
port at 2 ranks holds timeslots [0, 3) and [3, 5) plus one zero-weight
timeslot, at 3 ranks [0, 2), [2, 4), [4, 5) plus one; the JAX mesh pads
the B = 225 rows to bpad = 232.

The JAX sharded path divides res_0 and res_1 by the padded row count
(ROADMAP C15), the port by the real one, so the port's values are held
against the JAX values times bpad / B. Gates (the JAX package's own
sharding-invariance gates, ``tests/test_scale.py``): solutions rtol 1e-6
atol 1e-9, res_0 rtol 1e-9, res_1 rtol 1e-6, mean nu equal, and the
written residual column within 1e-6 of the data's largest magnitude.
Under ``--dtype-policy bf16`` the two packages' trajectories part at the
storage precision (ROADMAP C10): at 10 stations and 5 timeslots the
bf16 solve is roundoff-chaotic (the port's own sharded and unsharded
runs part by 2e-2 in res_1, the two packages' by 5.7e-2), so res_1 is
held within ``test_torch_dtype_policy_cli.py``'s ENVELOPE["bf16"], as
its chaotic runs are, and the solutions and column are not compared;
res_0, the residual before any solve, within
R0_BF16: the port's unsharded bf16 run lies as far from the JAX
package's on this tile (7.6e-6; their float32 staging rounds a few
visibilities to another bf16 value), and the port's 2-rank run 8.5e-8
from its unsharded one.

ROADMAP C15's witness: the JAX CLI's sharded res_0 / res_1 are its
unsharded ones times B / bpad, and the port's sharded ones its unsharded
ones.

Every sharded port run: the same solutions on every rank (the records'
SHA-256 of them), nothing written or logged by a rank but 0, the
records' world and timeslot blocks."""

import math
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import cli, pipeline, skymodel
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.io import solutions as sol
from sagecal_tpu.rime import beam as bm
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import parallel
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch.io import dataset as tds

from test_torch_dtype_policy_cli import ENVELOPE
from test_torch_pipeline import CLUSTER8, SKY8

N_STATIONS = 10
TILESZ = 5
B = TILESZ * N_STATIONS * (N_STATIONS - 1) // 2
#: the JAX mesh's padded rows: B up to a multiple of its 8 devices
BPAD = -(-B // 8) * 8
BASE = ["-e", "2", "-g", "6", "-l", "4", "-t", str(TILESZ), "-R", "0"]
CASES = {"j1": ["-j", "1"],
         "j5_cg": ["-j", "5", "--inner", "cg"],
         "xla_inflight": ["-j", "1", "--kernel", "xla", "--inflight", "2"],
         "beam": ["-j", "1", "-B", "1"],
         "bf16": ["-j", "1", "--dtype-policy", "bf16"]}
SOL_RTOL, SOL_ATOL = 1e-6, 1e-9
COL_TOL = 1e-6
#: bf16 res_0 against the JAX package's (module docstring)
R0_BF16 = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_shard")
    (tmp / "sky.txt").write_text(SKY8)
    (tmp / "sky.txt.cluster").write_text(CLUSTER8)
    ra0 = (41 / 60) * math.pi / 12
    dec0 = 40 * math.pi / 180
    sky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / "sky.txt"), ra0, dec0, 150e6),
        skymodel.parse_cluster_file(str(tmp / "sky.txt.cluster")))
    J = ds.random_jones(sky.n_clusters, sky.nchunk, N_STATIONS, seed=4,
                       scale=0.2)
    tile = ds.simulate_dataset(
        rp.sky_to_device(sky, jnp.float64), n_stations=N_STATIONS,
        tilesz=TILESZ, freqs=[149e6, 151e6], ra0=ra0, dec0=dec0, jones=J,
        nchunk=sky.nchunk, noise_sigma=0.02, seed=5, flag_fraction=0.05)
    info = bm.synthetic_beam(N_STATIONS, np.asarray(tile.time_jd), ra0,
                             dec0, 150e6)
    ds.SimMS.create(str(tmp / "pristine.ms"), [tile], beam_info=info)
    return dict(tmp=tmp, nchunk=list(sky.nchunk), refs={}, ports={})


def _argv(obs, tag):
    tmp = obs["tmp"]
    shutil.copytree(tmp / "pristine.ms", tmp / f"{tag}.ms")
    return ["-d", str(tmp / f"{tag}.ms"), "-s", str(tmp / "sky.txt"), "-c",
            str(tmp / "sky.txt.cluster"), "-p", str(tmp / f"{tag}.sol")]


def _outputs(obs, tag):
    """(solutions [intervals, ...] complex, written column) of run
    ``tag``."""
    tmp = obs["tmp"]
    _, blocks = sol.read_solutions(str(tmp / f"{tag}.sol"), obs["nchunk"])
    col = tds.SimMS(str(tmp / f"{tag}.ms"),
                    data_column="CORRECTED_DATA").read_tile(0).x
    return np.asarray(blocks), col


def jax_ref(obs, case):
    """The JAX CLI's --shard-baselines run of ``case`` (once a module):
    (records, solutions, column)."""
    if case not in obs["refs"]:
        tag = f"jax_{case}"
        args = cli.build_parser().parse_args(
            _argv(obs, tag) + BASE + CASES[case]
            + ["--shard-baselines", "--solve-fuse", "off",
               "--solve-promote", "off"])
        hist = pipeline.run(cli.config_from_args(args), log=lambda *a: None)
        obs["refs"][case] = (hist,) + _outputs(obs, tag)
    return obs["refs"][case]


def port_sharded(obs, case, world, extra=()):
    """The port's CLI command line of ``case`` as ``world`` CPU ranks
    (``parallel.run_sharded``): (per rank (records, log lines),
    solutions, column), with the checks every sharded run must pass
    (once a module)."""
    tag = f"port_{case}_p{world}" + "".join(extra).replace("-", "_")
    if tag in obs["ports"]:
        return obs["ports"][tag]
    argv = _argv(obs, tag) + BASE + CASES[case] + [
        "--platform", "cpu", "--shard-baselines"] + list(extra)
    ranks = parallel.run_sharded(argv, world, timeout=600)
    plan = parallel.RowPlan(TILESZ, B // TILESZ, world)
    for r, (hist, lines) in enumerate(ranks):
        for h, h0 in zip(hist, ranks[0][0]):
            assert h["world"] == world and h["rank"] == r
            assert h["blocks"] == plan.blocks() and h["backend"] == "gloo"
            assert h["solution_sha"] == h0["solution_sha"]
            assert h["row_sums"]["collectives"] > 0
            if r:
                assert h["wrote"] == []
        if r:
            assert lines == []
    assert any("Shard baselines" in s for s in ranks[0][1])
    obs["ports"][tag] = (ranks,) + _outputs(obs, tag)
    return obs["ports"][tag]


def _check_against_jax(port, ref, case):
    (ranks, J, col), (jhist, jJ, jcol) = port, ref
    hist = ranks[0][0]
    assert len(hist) == len(jhist) == 1
    for h, j in zip(hist, jhist):
        assert h["res_1"] < h["res_0"]
        if case == "bf16":
            assert abs(h["res_0"] / (j["res_0"] * BPAD / B) - 1) < R0_BF16
            assert abs(h["res_1"] / (j["res_1"] * BPAD / B) - 1) \
                < ENVELOPE["bf16"]
            continue
        np.testing.assert_allclose(h["res_0"], j["res_0"] * BPAD / B,
                                   rtol=1e-9)
        np.testing.assert_allclose(h["res_1"], j["res_1"] * BPAD / B,
                                   rtol=1e-6)
        assert h["mean_nu"] == pytest.approx(j["mean_nu"], rel=1e-12)
    if case != "bf16":
        np.testing.assert_allclose(J, jJ, rtol=SOL_RTOL, atol=SOL_ATOL)
        assert np.abs(col - jcol).max() / np.abs(jcol).max() < COL_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_jax_sharded(obs, case):
    """Each case at 2 ranks (an uneven split: 3 + 2 timeslots and one of
    padding) against the JAX CLI's sharded run."""
    _check_against_jax(port_sharded(obs, case, 2), jax_ref(obs, case), case)


def test_jax_sharded_residuals_scale_with_padding(obs):
    """ROADMAP C15: the JAX CLI's --shard-baselines run divides res_0 and
    res_1 by the padded row count (bpad = 232 for B = 225 rows on 8
    devices), so they are its unsharded run's times B / bpad; the port's
    sharded run (2 ranks, padded too) reports the unsharded values."""
    _, jJ, _ = jax_ref(obs, "j1")
    args = cli.build_parser().parse_args(
        _argv(obs, "jax_j1_one") + BASE + CASES["j1"]
        + ["--solve-fuse", "off", "--solve-promote", "off"])
    one = pipeline.run(cli.config_from_args(args), log=lambda *a: None)
    sharded = jax_ref(obs, "j1")[0]
    port = port_sharded(obs, "j1", 2)[0][0][0]
    for key, rtol in (("res_0", 1e-9), ("res_1", 1e-6)):
        np.testing.assert_allclose(sharded[0][key], one[0][key] * B / BPAD,
                                   rtol=rtol)
        assert abs(sharded[0][key] / one[0][key] - 1) > 0.5 * (1 - B / BPAD)
        np.testing.assert_allclose(port[0][key], one[0][key], rtol=rtol)


def test_three_ranks_uneven_match_jax_sharded(obs):
    """-j 1 at 3 ranks (2 + 2 + 1 timeslots and one of padding): the
    same solutions on every rank, ranks 1 and 2 silent, and the JAX
    CLI's sharded answers."""
    _check_against_jax(port_sharded(obs, "j1", 3), jax_ref(obs, "j1"), "j1")


def test_cli_main_spawns_cpu_devices_ranks(obs, capfd):
    """``sagecal_tpu_torch.cli.main`` with --platform cpu --cpu-devices 2
    --shard-baselines starts 2 ranks (rank 0 prints its log) and writes
    what the JAX CLI's sharded run writes, within the gates."""
    argv = _argv(obs, "main_j1") + BASE + CASES["j1"] + [
        "--platform", "cpu", "--cpu-devices", "2", "--shard-baselines"]
    assert tcli.main(argv) == 0
    out = capfd.readouterr().out
    assert "Shard baselines: 2 ranks" in out
    J, col = _outputs(obs, "main_j1")
    _, jJ, jcol = jax_ref(obs, "j1")
    np.testing.assert_allclose(J, jJ, rtol=SOL_RTOL, atol=SOL_ATOL)
    assert np.abs(col - jcol).max() / np.abs(jcol).max() < COL_TOL


def test_per_channel_sharded_matches_one_process(obs):
    """-b 1 over 2 ranks: the joint solve and every channel's LBFGS fit
    summed over the ranks give the one-process run's channels, solutions
    and column (float64 roundoff apart)."""
    extra = ["-b", "1", "-e", "1"]
    ranks, J, col = port_sharded(obs, "j1", 2, extra)
    argv = _argv(obs, "b1_one") + BASE + CASES["j1"] + extra + [
        "--platform", "cpu"]
    hist = tpipeline.run(tcli.prepare(argv)[0], device="cpu",
                         log=lambda *a: None)
    J1, col1 = _outputs(obs, "b1_one")
    for a, b in zip(ranks[0][0][0]["channels"], hist[0]["channels"]):
        for k in ("res_0", "res_1"):
            assert a[k] == pytest.approx(b[k], rel=1e-9)
    np.testing.assert_allclose(J, J1, rtol=1e-8, atol=1e-10)
    assert np.abs(col - col1).max() / np.abs(col1).max() < 1e-8


def test_world_one_and_inert_routes(obs):
    """One device runs in-process with no group; --tile-batch is off with
    the JAX CLI's log line; under -a the flag is inert (the same column
    bit for bit)."""
    lines = []
    argv = _argv(obs, "w1") + BASE + CASES["j1"] + [
        "--platform", "cpu", "--shard-baselines", "--tile-batch", "2"]
    hist = tpipeline.run(tcli.prepare(argv)[0], device="cpu",
                         log=lines.append)
    assert "world" not in hist[0]
    assert any("tile-batch disabled" in s for s in lines)
    cols = []
    for tag, extra in (("sim", []), ("sim_shard", [
            "--shard-baselines", "--cpu-devices", "2"])):
        argv = _argv(obs, tag) + ["-a", "1", "--platform", "cpu"] + extra
        argv.remove("-p")
        argv.remove(str(obs["tmp"] / f"{tag}.sol"))
        assert tcli.main(argv) == 0
        cols.append(tds.SimMS(str(obs["tmp"] / f"{tag}.ms"),
                              data_column="CORRECTED_DATA").read_tile(0).x)
    assert np.array_equal(cols[0], cols[1])
