"""Both CLIs under ``--dtype-policy bf16|f16`` on the CPU: the JAX
package's and the port's full-batch (and stochastic) runs on copies of
one SimMS (test_torch_pipeline.py's: 10 stations, 2 tiles of 4
timeslots, 2 channels; clusters of 1 and 2 chunks, or of 1; 8 clusters
for the in-flight groups), ``-R 0``. Here ``-j 1`` and the default mode
(no ``-j``: 5, which 10 stations run as 3, OS-LM then OS robust LM; on
single-chunk clusters, so its OS iterations take the reduced OS fast
path) and ``-j 1 --kernel xla`` (the reduced XLA assembly and LU);
test_torch_dtype_policy_cli_more.py holds ``-b 1``, ``-N`` and
``--tile-batch 2``, and test_torch_dtype_policy_cli_groups.py ``-j 5
--inner cg --inflight 2``.

Under a reduced policy both pipelines compute in float32, stage the
solve's data, weights and the residual's input in the storage dtype and
write the storage-rounded residual. The two packages' trajectories part
at the storage dtype's precision (a float32 roundoff flips a rounding to
it now and then, and the solves carry that on), so the gates are
max(GATE, 10 x the JAX package's own spread), the spread measured by its
run with every source flux one float32 ulp up (made only when the plain
gate does not hold): per-tile res_0 and res_1 relative to the JAX run's,
and the written column's largest difference in units of the data's
largest magnitude. GATE is 2e-2 at bf16 and 4e-3 at f16
(tests/test_dtype_policy.py's assembly tolerances), and no gate may
exceed SPREAD_CAP (5e-2). The CHAOTIC runs (``--tile-batch 2`` and the
in-flight groups) move further under one ulp in the JAX package itself:
their residuals are held to the reference's within ENVELOPE, and their
columns are not compared. Every run's tile-0 res_0, the residual before
any solve, lies within R0_GATE (5e-6) of the reference's and nearer it
than the float32 port's (by 4.7e-7 to 6.2e-4 on these runs: the staging
in the storage dtype). Each port run's residuals fall on every tile,
and its res_1 lies within ENVELOPE (0.25 bf16, 0.10 f16) of its own
float32 run's."""

import math
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import cli, pipeline, skymodel, stochastic
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch import stochastic as tstochastic

from test_torch_pipeline import CLUSTER, CLUSTER8, CLUSTER_ONE_CHUNK, SKY, \
    SKY8

GATE = {"bf16": 2e-2, "f16": 4e-3}
ENVELOPE = {"bf16": 0.25, "f16": 0.10}
BASE = ["-e", "2", "-g", "10", "-l", "5", "-t", "4", "-R", "0"]
#: tag -> (sky, cluster file, tiles, CLI flags)
RUNS = {
    "j1": ("sky", CLUSTER, 2, ["-j", "1", "--kernel", "pallas"]),
    "default": ("sky", CLUSTER_ONE_CHUNK, 2, ["--kernel", "pallas"]),
    "xla": ("sky", CLUSTER, 2, ["-j", "1", "--kernel", "xla"]),
    "bandpass": ("sky", CLUSTER, 2, ["-j", "1", "-b", "1", "--kernel",
                                     "pallas"]),
    "stochastic": ("sky", CLUSTER, 2, ["-N", "1", "-M", "2", "-l", "6",
                                       "-m", "5", "-t", "4"]),
    "inflight": ("sky8", CLUSTER8, 2, ["-j", "5", "--inner", "cg",
                                       "--inflight", "2", "--kernel",
                                       "pallas"]),
    "tile_batch": ("sky", CLUSTER_ONE_CHUNK, 3, ["--tile-batch", "2",
                                                 "--kernel", "pallas"]),
}

#: the largest gate a trajectory comparison may take: max(GATE, 10 x the
#: JAX package's one-ulp spread) above it would check nothing
SPREAD_CAP = 5e-2
#: runs that are roundoff-chaotic on this observation in the JAX package
#: itself: its one-ulp run moves the residuals by 3.6e-3 to 4.5e-2 and the
#: written column by 7.9e-3 to 0.47 of the data's largest magnitude; and
#: its runs one ulp up and one ulp down part as far as the port lies from
#: it (-j 5 --inner cg --inflight 2 at f16 and -e 1 -g 2 -l 0: tile 0's
#: res_1 moves 1.2e-4 up and 5.6e-3 down, the port lies 5.6e-3 off; read
#: on a CPU). Their trajectories cannot be compared: the port's per-tile
#: residuals are held to the reference's within ENVELOPE, the band the
#: JAX package accepts between policies, and the column is not compared
#: (ROADMAP C10)
CHAOTIC = ("tile_batch", "inflight")
#: tile 0's res_0, port against the JAX package at the same policy: the
#: residual at the initial J, before any solve, from the same rounded data
#: (float32 sums in another order; <= 2.8e-6 read)
R0_GATE = 5e-6


def _write(tmp, name, sky_text, cluster_text, n_tiles):
    """Sky, cluster file and pristine SimMS ``name`` in ``tmp``; also the
    sky with every flux one float32 ulp up (``<sky>.ulp``)."""
    sky = tmp / f"{name}.txt"
    sky.write_text(sky_text)
    (tmp / f"{name}.cluster").write_text(cluster_text)
    lines = []
    for ln in sky_text.splitlines():
        f = ln.split()
        f[7] = repr(float(np.nextafter(np.float32(float(f[7])),
                                       np.float32(np.inf))))
        lines.append(" ".join(f))
    (tmp / f"{name}.txt.ulp").write_text("\n".join(lines) + "\n")
    ra0 = (0 + 41 / 60) * math.pi / 12
    dec0 = 40 * math.pi / 180
    csky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(sky), ra0, dec0, 150e6),
        skymodel.parse_cluster_file(str(tmp / f"{name}.cluster")))
    J = ds.random_jones(csky.n_clusters, csky.nchunk, 10, seed=2, scale=0.2)
    dsky = rp.sky_to_device(csky, jnp.float64)
    ds.SimMS.create(str(tmp / f"{name}.ms"), [
        ds.simulate_dataset(dsky, n_stations=10, tilesz=4,
                            freqs=[149e6, 151e6], ra0=ra0, dec0=dec0,
                            jones=J, nchunk=csky.nchunk, noise_sigma=0.02,
                            seed=3 + i) for i in range(n_tiles)])


def _jax_run(tmp, tag, ms, sky, clus, flags):
    args = cli.build_parser().parse_args(
        ["-d", str(ms), "-p", str(tmp / f"{tag}.sol"), "-s", str(sky), "-c",
         str(clus)] + flags
        + ([] if "-N" in flags else ["--solve-fuse", "off",
                                     "--solve-promote", "off"]))
    cfg = cli.config_from_args(args)
    run = stochastic.run_minibatch if "-N" in flags else pipeline.run
    return run(cfg, log=lambda *a: None)


def _port_run(tmp, tag, ms, sky, clus, flags):
    args = tcli.build_parser().parse_args(
        ["-d", str(ms), "-p", str(tmp / f"{tag}.sol"), "-s", str(sky), "-c",
         str(clus), "--platform", "cpu"] + flags)
    tcli.check_flags(args)
    cfg = tcli.config_from_args(args)
    run = tstochastic.run_minibatch if "-N" in flags else tpipeline.run
    return run(cfg, device="cpu", log=lambda *a: None)


def _column(ms):
    out = ds.SimMS(str(ms), data_column="CORRECTED_DATA")
    return [out.read_tile(i).x for i in range(out.n_tiles)]


def _deviation(h_a, h_b, col_a, col_b, data):
    """(largest per-tile relative res_0/res_1 difference, largest written
    column difference in units of the data's largest magnitude)."""
    res = max(abs(a[k] / b[k] - 1.0) for a, b in zip(h_a, h_b)
              for k in ("res_0", "res_1"))
    col = max(float(np.abs(a - b).max() / np.abs(d).max())
              for a, b, d in zip(col_a, col_b, data))
    return res, col


def check_run(tmp, tag, policy):
    """Both CLIs' run ``tag`` at ``policy`` against each other: tile 0's
    res_0 within R0_GATE and nearer the reference's than the float32
    port's; the residuals and the column at max(GATE, 10 x the JAX
    package's spread), at most SPREAD_CAP (the residuals within ENVELOPE
    for a CHAOTIC run); the port's residuals falling and within ENVELOPE
    of its float32 run."""
    name, clusters, n_tiles, flags = RUNS[tag]
    sky_text = SKY8 if name == "sky8" else SKY
    obs = f"{tag}_obs"
    _write(tmp, obs, sky_text, clusters, n_tiles)
    sky, clus = tmp / f"{obs}.txt", tmp / f"{obs}.cluster"
    flags = BASE + flags + ["--dtype-policy", policy]

    def copy(side):
        shutil.copytree(tmp / f"{obs}.ms", tmp / f"{tag}_{side}.ms")
        return tmp / f"{tag}_{side}.ms"

    data = [ds.SimMS(str(tmp / f"{obs}.ms")).read_tile(i).x
            for i in range(n_tiles)]
    hj = _jax_run(tmp, f"{tag}_jax", copy("jax"), sky, clus, flags)
    ht = _port_run(tmp, f"{tag}_port", copy("port"), sky, clus, flags)
    f32 = [f for f in flags if f not in ("--dtype-policy", policy)]
    hf = _port_run(tmp, f"{tag}_f32", copy("f32"), sky, clus, f32)
    assert len(hj) == len(ht) == len(hf) == n_tiles
    # before any solve: the same rounded data in both packages, and not
    # the float32 port's
    r0 = abs(ht[0]["res_0"] / hj[0]["res_0"] - 1.0)
    assert r0 <= R0_GATE, (tag, policy, r0)
    assert r0 < abs(hf[0]["res_0"] / hj[0]["res_0"] - 1.0), (tag, policy)
    res, col = _deviation(ht, hj, _column(tmp / f"{tag}_port.ms"),
                          _column(tmp / f"{tag}_jax.ms"), data)
    if tag in CHAOTIC:
        assert res <= ENVELOPE[policy], (tag, policy, res)
    else:
        gate_res = gate_col = GATE[policy]
        if res > gate_res or col > gate_col:
            hp = _jax_run(tmp, f"{tag}_ulp", copy("ulp"),
                          tmp / f"{obs}.txt.ulp", clus, flags)
            s_res, s_col = _deviation(hp, hj,
                                      _column(tmp / f"{tag}_ulp.ms"),
                                      _column(tmp / f"{tag}_jax.ms"), data)
            gate_res = max(gate_res, 10.0 * s_res)
            gate_col = max(gate_col, 10.0 * s_col)
        assert max(gate_res, gate_col) <= SPREAD_CAP, (tag, policy, gate_res,
                                                       gate_col)
        assert res <= gate_res, (tag, policy, res, gate_res)
        assert col <= gate_col, (tag, policy, col, gate_col)
    for a, b in zip(ht, hf):
        assert a["res_1"] < a["res_0"]
        assert abs(a["res_1"] / b["res_1"] - 1.0) < ENVELOPE[policy]
    return hj, ht


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
@pytest.mark.parametrize("tag", ["j1", "default", "xla"])
def test_cli_reduced_matches_reference(tmp_path, tag, policy):
    check_run(tmp_path, tag, policy)
