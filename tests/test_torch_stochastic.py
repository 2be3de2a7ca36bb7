"""The stochastic plans and the end-of-tile policy (``stochastic.py``)
against the JAX package: ``band_plan`` and ``minibatch_rows`` over a grid
that includes the clamp and drop cases (exactly equal), and both
packages' ``end_of_tile`` driven on crafted band residuals that trigger a
per-band reset, a global reset, both, a NaN and a zero residual, and
none: the per-band solutions, every memory field and ``res_prev`` equal
after it, and the written residual column within 1e-7 of the data's
largest magnitude (float64, on the tests/test_torch_pipeline_stochastic.py
observation)."""

import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagecal_tpu import cli, skymodel, stochastic as jst
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.solvers import lbfgs as jl
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import skymodel as tskymodel
from sagecal_tpu_torch import stochastic as tst
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.solvers import lbfgs as tl

from test_torch_pipeline_stochastic import TILESZ, write_obs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nchan,nsolbw", [(10, 4), (4, 8), (4, 3), (8, 3),
                                          (1, 1), (8, 1), (8, 8), (9, 4),
                                          (5, 4), (7, 6)])
def test_band_plan_matches_reference(nchan, nsolbw):
    got, want = tst.band_plan(nchan, nsolbw), jst.band_plan(nchan, nsolbw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sum(got[1]) == nchan and all(n > 0 for n in got[1])


@pytest.mark.parametrize("tilesz,nbase,mb", [(10, 5, 3), (4, 5, 9),
                                             (120, 1891, 4), (5, 28, 2),
                                             (5, 28, 3), (5, 28, 4),
                                             (1, 3, 1), (7, 3, 7), (9, 2, 0)])
def test_minibatch_rows_matches_reference(tilesz, nbase, mb):
    got, want = tst.minibatch_rows(tilesz, nbase, mb), \
        jst.minibatch_rows(tilesz, nbase, mb)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sum(got[1]) == tilesz


#: end_of_tile cases: (band residuals, res_1, res_prev before)
CASES = {
    "band_reset": ([1.0, 10.0], 1.5, None),
    "global_reset": ([1.0, 1.2], 6.0, 1.0),
    "band_and_global": ([40.0, 1.0], 7.0, 1.0),
    "nan": ([np.nan, 1.0], np.nan, 2.0),
    "zero": ([0.0, 0.0], 0.0, 2.0),
    "keep": ([1.0, 1.1], 1.0, 2.0),
}


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stochastic")
    write_obs(tmp, n_tiles=1)
    return tmp


def _memory(rng, n, m):
    s, y = rng.normal(size=(m, n)), rng.normal(size=(m, n))
    rho, ra, rsq = rng.normal(size=m), rng.normal(size=n), rng.random(n)
    return dict(s=s, y=y, rho=rho, head=2, nfilled=3, niter=7,
                running_avg=ra, running_avg_sq=rsq)


@pytest.mark.parametrize("case", sorted(CASES))
def test_end_of_tile_matches_reference(obs, tmp_path, case):
    resband, res_1, res_prev = CASES[case]
    flags = ["-s", str(obs / "sky.txt"), "-c", str(obs / "sky.txt.cluster"),
             "-t", str(TILESZ), "-N", "1", "-M", "2", "-w", "2", "-m", "4"]
    out = {}
    for side in ("jax", "torch"):
        ms_path = tmp_path / f"{side}.ms"
        shutil.copytree(obs / "pristine.ms", ms_path)
        rng = np.random.default_rng(7)
        if side == "jax":
            cfg = cli.config_from_args(cli.build_parser().parse_args(
                ["-d", str(ms_path)] + flags))
            ms = ds.SimMS(str(ms_path))
            sky = skymodel.read_sky_cluster(cfg.sky_model, cfg.cluster_file,
                                            ms.meta["ra0"], ms.meta["dec0"],
                                            ms.meta["freq0"])
            rn = jst._StochasticRunner(cfg, ms, sky, log=lambda *a: None)
        else:
            cfg = tcli.config_from_args(tcli.build_parser().parse_args(
                ["-d", str(ms_path)] + flags))
            ms = tds.SimMS(str(ms_path))
            sky = tskymodel.read_sky_cluster(
                cfg.sky_model, cfg.cluster_file, ms.meta["ra0"],
                ms.meta["dec0"], ms.meta["freq0"])
            rn = tst.StochasticRunner(cfg, ms, sky, device="cpu",
                                      log=lambda *a: None)
        pinit, _ = rn.initial_p()
        pfreq = [pinit + 0.05 * rng.normal(size=pinit.shape)
                 for _ in range(rn.nsolbw)]
        mems = [_memory(rng, rn.nparam, 4) for _ in range(rn.nsolbw)]
        if side == "jax":
            mems = [jl.LBFGSMemory(**{k: jnp.asarray(v) for k, v in m.items()})
                    for m in mems]
        else:
            mems = [tl.LBFGSMemory(**{k: torch.as_tensor(v)
                                      if isinstance(v, np.ndarray) else v
                                      for k, v in m.items()}) for m in mems]
        state = {"pfreq": pfreq, "mems": mems, "pinit": pinit,
                 "res_prev": res_prev}
        tile = ms.read_tile(0)
        hist = []
        args = (np.asarray(resband), 3.0, res_1, time.time(), None, hist)
        if side == "jax":
            rn.prepare_tile(tile)
            rn.end_of_tile(tile, 0, state, *args)
        else:
            rn.end_of_tile(tile, 0, rn.build_tile_inputs(tile), state, *args)
        out[side] = (state, hist, ms_path)
    (js, jh, jpath), (ts, th, tpath) = out["jax"], out["torch"]
    assert (ts["res_prev"] is None) == (js["res_prev"] is None)
    if js["res_prev"] is not None:
        assert ts["res_prev"] == js["res_prev"]
    for b in range(2):
        np.testing.assert_array_equal(ts["pfreq"][b], js["pfreq"][b])
        for f in jl.LBFGSMemory._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(ts["mems"][b], f)),
                np.asarray(getattr(js["mems"][b], f)), err_msg=f)
    np.testing.assert_equal([th[0]["res_0"], th[0]["res_1"]],
                            [jh[0]["res_0"], jh[0]["res_1"]])
    scale = np.abs(tds.SimMS(str(obs / "pristine.ms")).read_tile(0).x).max()
    np.testing.assert_allclose(
        tds.SimMS(str(tpath), data_column="CORRECTED_DATA").read_tile(0).x,
        ds.SimMS(str(jpath), data_column="CORRECTED_DATA").read_tile(0).x,
        atol=1e-7 * scale)
    # what the case claims happened
    reset_all = case in ("global_reset", "band_and_global", "nan", "zero")
    reset_band = {"band_reset": 1, "band_and_global": 0}.get(case)
    for b in range(2):
        fresh = ts["mems"][b].nfilled == 0
        assert fresh == (b == reset_band)
        assert np.array_equal(ts["pfreq"][b], ts["pinit"]) == (
            reset_all or b == reset_band)
