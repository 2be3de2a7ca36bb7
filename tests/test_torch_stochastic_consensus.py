"""Stochastic consensus (``-N`` with ``-A > 1`` and ``-w > 1``): the
port's ``stochastic.run_minibatch_consensus`` against the JAX package's
in float64 on the CPU, on ``test_torch_pipeline_stochastic.py``'s
observation (2 tiles of 8 stations, 5 timeslots, 4 channels; 3 clusters,
one of 2 chunks):

- both full-batch CLIs at ``-N 1 -M 2 -w 2 -A 3`` (which they route to
  stochastic consensus);
- ``-N 1 -M 2 -w 4 -A 2 -P 3 -Q 1 -G`` with the consensus value as the
  solution (``RunConfig.use_global_solution``, which the JAX CLI has no
  flag for: ``-U``), through ``run_minibatch_consensus`` directly.

Gates as the plain stochastic runs': per-tile res_0/res_1 rtol 1e-8, the
solutions atol 1e-6 (every band), the written column 1e-7 of the data's
largest magnitude; the port's flagged bands as the JAX run's (each band
calibrates, so none is flagged here). The consensus band cost of both
packages within 1e-10 on random lanes with a rho that differs per
cluster (the JAX package's sum-of-rho weighting, ROADMAP C12). And
``-A``, ``-P``, ``-Q``, ``-r``, ``-G`` and ``-w`` without ``-N`` are
inert in the port's full-batch CLI, as in the JAX one: the same
solutions and column with them as without."""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import cli, stochastic
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import stochastic as tstochastic
from sagecal_tpu_torch.io import dataset as tds

from test_torch_pipeline_stochastic import COMMON, write_obs

RUNS = {
    "cli": ["-N", "1", "-M", "2", "-w", "2", "-A", "3"],
    "global": ["-N", "1", "-M", "2", "-w", "4", "-A", "2", "-P", "3",
               "-Q", "1", "-G", "@rho"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tag -> (JAX history, port history); both packages on copies."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_stochastic_consensus")
    sky = write_obs(tmp)
    (tmp / "rho.txt").write_text("0 1 2.0\n1 2 4.0\n")
    out = {}
    for tag, flags in RUNS.items():
        flags = [str(tmp / "rho.txt") if f == "@rho" else f for f in flags]
        common = ["-s", str(tmp / "sky.txt"), "-c",
                  str(tmp / "sky.txt.cluster")] + COMMON + flags
        for side in ("jax", "torch"):
            shutil.copytree(tmp / "pristine.ms", tmp / f"{tag}_{side}.ms")
        jargv = ["-d", str(tmp / f"{tag}_jax.ms"), "-p",
                 str(tmp / f"{tag}_jax.sol")] + common
        targv = ["-d", str(tmp / f"{tag}_torch.ms"), "-p",
                 str(tmp / f"{tag}_torch.sol"), "--platform", "cpu"] + common
        hist = {}
        if tag == "cli":
            assert cli.main(jargv) == 0
            assert tcli.main(targv) == 0
            # the histories of the same runs, for the residual gates
            jcfg = cli.config_from_args(cli.build_parser().parse_args(jargv))
            tcfg = tcli.config_from_args(tcli.build_parser().parse_args(
                targv))
            for side, c in (("jax", jcfg), ("torch", tcfg)):
                shutil.rmtree(tmp / f"{tag}_{side}_h.ms", ignore_errors=True)
                shutil.copytree(tmp / "pristine.ms",
                                tmp / f"{tag}_{side}_h.ms")
            hist["jax"] = stochastic.run_minibatch_consensus(
                jcfg.replace(ms=str(tmp / f"{tag}_jax_h.ms"),
                             solutions_file=None), log=lambda *a: None)
            hist["torch"] = tstochastic.run_minibatch_consensus(
                tcfg.replace(ms=str(tmp / f"{tag}_torch_h.ms"),
                             solutions_file=None), device="cpu",
                log=lambda *a: None)
        else:
            jcfg = cli.config_from_args(cli.build_parser().parse_args(
                jargv)).replace(use_global_solution=True)
            tcfg = tcli.config_from_args(tcli.build_parser().parse_args(
                targv)).replace(use_global_solution=True)
            hist["jax"] = stochastic.run_minibatch_consensus(
                jcfg, log=lambda *a: None)
            hist["torch"] = tstochastic.run_minibatch_consensus(
                tcfg, device="cpu", log=lambda *a: None)
        out[tag] = (hist["jax"], hist["torch"])
    yield tmp, sky, out
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_stochastic_consensus_matches_reference(runs, tag):
    tmp, sky, out = runs
    j, t = out[tag]
    assert len(j) == len(t) == 2
    for key in ("res_0", "res_1"):
        np.testing.assert_allclose([h[key] for h in t], [h[key] for h in j],
                                   rtol=1e-8)
    assert all(h["res_1"] < h["res_0"] for h in t)
    assert all(not any(f) for h in t for f in h["flagged_bands"])
    assert len(t[0]["duals"]) == int(RUNS[tag][RUNS[tag].index("-A") + 1]) \
        * 2
    want = sol.read_solutions(str(tmp / f"{tag}_jax.sol"), sky.nchunk)
    got = sol.read_solutions(str(tmp / f"{tag}_torch.sol"), sky.nchunk)
    assert got[0] == want[0] and len(got[1]) == len(want[1]) == 2
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    jms = ds.SimMS(str(tmp / f"{tag}_jax.ms"), data_column="CORRECTED_DATA")
    tms = tds.SimMS(str(tmp / f"{tag}_torch.ms"),
                    data_column="CORRECTED_DATA")
    raw = tds.SimMS(str(tmp / "pristine.ms"))
    for i in range(2):
        scale = np.abs(raw.read_tile(i).x).max()
        np.testing.assert_allclose(tms.read_tile(i).x, jms.read_tile(i).x,
                                   atol=1e-7 * scale)


def test_consensus_band_cost_matches_reference():
    """The consensus branch of make_band_cost on random lanes (3 bands),
    rho differing per cluster: the JAX package weighs ||p - BZ||^2 by the
    sum of the clusters' rho (C12), and so does the port."""
    rng = np.random.default_rng(3)
    M, K, N, B, F, W = 2, 2, 4, 12, 3, 3
    cmask = np.array([[True, True], [True, False]])
    cidx = np.stack([(np.arange(B) * K // B), np.zeros(B, int)])
    sta1, sta2 = rng.integers(0, N, B), rng.integers(0, N, B)
    x8F = rng.normal(size=(W, B, F, 8))
    wtF = (rng.uniform(size=(W, B, F, 8)) > 0.2).astype(float)
    coh = rng.normal(size=(W, M, B, F, 2, 2)) \
        + 1j * rng.normal(size=(W, M, B, F, 2, 2))
    p = rng.normal(size=(W, M, K, N, 8))
    Y, BZ = rng.normal(size=p.shape), rng.normal(size=p.shape)
    rho = rng.uniform(1.0, 5.0, size=(W, M))
    jc = stochastic.make_band_cost(cidx, cmask, N, 2.0, True)
    want = [float(jc(jnp.asarray(x8F[w]), jnp.asarray(coh[w]),
                     jnp.asarray(wtF[w]), jnp.asarray(sta1),
                     jnp.asarray(sta2), Y=jnp.asarray(Y[w]),
                     BZ=jnp.asarray(BZ[w]), rho=jnp.asarray(rho[w]))(
                         jnp.asarray(p[w].reshape(-1)))) for w in range(W)]
    tc = tstochastic.make_band_cost(torch.as_tensor(cidx), cmask, N, 2.0,
                                    True)
    t = torch.as_tensor
    got = tc(t(x8F), t(coh), t(wtF), t(sta1), t(sta2), Y=t(Y), BZ=t(BZ),
             rho=t(rho))(t(p.reshape(W, -1))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    one = tc(t(x8F[0]), t(coh[0]), t(wtF[0]), t(sta1), t(sta2), Y=t(Y[0]),
             BZ=t(BZ[0]), rho=t(rho[0]))(t(p[0].reshape(-1)))
    np.testing.assert_allclose(float(one), want[0], rtol=1e-10)


def test_consensus_flags_inert_without_epochs(tmp_path):
    """-A, -P, -Q, -r, -G and -w without -N: the port's full-batch run
    writes the same solutions and column as without them."""
    write_obs(tmp_path, n_tiles=1)
    (tmp_path / "rho.txt").write_text("0 1 2.0\n")
    cols, sols = [], []
    for tag, extra in (("plain", []),
                       ("flags", ["-A", "3", "-P", "3", "-Q", "1", "-r",
                                  "3", "-G", str(tmp_path / "rho.txt"),
                                  "-w", "2"])):
        shutil.copytree(tmp_path / "pristine.ms", tmp_path / f"{tag}.ms")
        argv = ["-d", str(tmp_path / f"{tag}.ms"), "-s",
                str(tmp_path / "sky.txt"), "-c",
                str(tmp_path / "sky.txt.cluster"), "-p",
                str(tmp_path / f"{tag}.sol"), "-t", "5", "-j", "1", "-e",
                "1", "-g", "3", "-l", "2", "--platform", "cpu"] + extra
        assert tcli.main(argv) == 0
        cols.append(tds.SimMS(str(tmp_path / f"{tag}.ms"),
                              data_column="CORRECTED_DATA").read_tile(0).x)
        sols.append((tmp_path / f"{tag}.sol").read_text())
    assert sols[0] == sols[1]
    np.testing.assert_array_equal(cols[0], cols[1])
