"""Federated stochastic calibration (``-N`` of the MPI CLI): the port's
``federated.run_federated`` (the slaves in turn, each slave's mini-bands
lanes of one band solve) against the JAX package's
``run_federated_sequential`` (bands one at a time) in float64 on the CPU:
2 slave datasets of ``tests/test_aux.py``'s federated fixture (6
stations, 4 timeslots, 4 channels, one tile) at ``-N 1 -M 2 -w 2 -A 2 -u
0.5``, and once more with the consensus value as the solution (``-U 1``)
and a per-cluster rho file; and the setup both runs consume
(``_fed_setup``: the bases, the ``+ alpha I`` inverses, the rho table,
the initial solutions) against the JAX package's.

Gates as the stochastic-consensus runs' (``test_torch_stochastic_
consensus.py``): per-tile res_0/res_1 rtol 1e-8, the solutions file atol
1e-6 (every band), every slave's written column within 1e-7 of its
data's largest magnitude; and the FEDA dual residuals within the 6
decimals the JAX run prints under ``-V``."""

import os
import shutil

import numpy as np
import pytest
import torch

from sagecal_tpu import federated
from sagecal_tpu.config import RunConfig
from sagecal_tpu.io import dataset as ds, solutions as sol
from sagecal_tpu_torch import federated as tfederated
from sagecal_tpu_torch.config import RunConfig as TRunConfig
from sagecal_tpu_torch.io import dataset as tds

from test_aux import _make_subband_datasets

RUNS = {"plain": {}, "global": {"use_global_solution": True,
                                "rho_file": "@rho"}}
FIELDS = dict(n_epochs=1, n_minibatches=2, channel_avg_per_band=2,
              n_admm=2, n_poly=2, admm_rho=2.0, federated_alpha=0.5,
              max_lbfgs=6, lbfgs_m=5, tile_size=4, verbose=True)


def _copy(tmp, paths, tag):
    work = tmp / tag
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    out = []
    for p in paths:
        dst = work / os.path.basename(p)
        shutil.copytree(p, dst)
        out.append(str(dst))
    return out, str(work / "sol.txt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tag -> {side: (history, dataset paths, solutions path)} for the
    JAX sequential run and the port's run_federated."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_federated")
    paths, sky = _make_subband_datasets(tmp, nf=2, tilesz=4, nchan=4)
    (tmp / "rho.txt").write_text("0 1 3.0\n")
    out = {}
    for tag, extra in RUNS.items():
        kw = dict(FIELDS, sky_model=str(tmp / "sky.txt"),
                  cluster_file=str(tmp / "sky.txt.cluster"),
                  **{k: (str(tmp / "rho.txt") if v == "@rho" else v)
                     for k, v in extra.items()})
        res = {}
        for side in ("jax", "torch"):
            ps, solp = _copy(tmp, paths, f"{tag}_{side}")
            lines = []
            if side == "jax":
                hist = federated.run_federated_sequential(
                    RunConfig(ms=ps[0], solutions_file=solp, **kw), ps,
                    log=lines.append)
            else:
                hist = tfederated.run_federated(
                    TRunConfig(ms=ps[0], solutions_file=solp, **kw), ps,
                    device="cpu", log=lines.append)
            feda = [float(ln.split("=")[-1]) for ln in lines
                    if ln.startswith("FEDA: ")]
            res[side] = (hist, ps, solp, kw, feda)
        out[tag] = res
    yield tmp, paths, sky, out
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_federated_matches_reference(runs, tag):
    """The port's run_federated against the JAX sequential oracle."""
    tmp, paths, sky, out = runs
    (hg, pg, sg, _, fg), (hr, pr, sr, _, fr) = (out[tag]["torch"],
                                                out[tag]["jax"])
    assert len(hg) == len(hr) == 1
    for key in ("res_0", "res_1"):
        np.testing.assert_allclose([h[key] for h in hg],
                                   [h[key] for h in hr], rtol=1e-8)
    assert all(h["res_1"] < h["res_0"] for h in hg)
    # the FEDA dual residual per outer iteration: the JAX run prints it
    # (-V) to 6 decimals, as the port does
    assert len(fg) == len(fr) == len(hg[0]["feda"]) == 2
    np.testing.assert_allclose(hg[0]["feda"], fr, rtol=0, atol=1e-6)
    assert fg == fr
    ha, ba = sol.read_solutions(sg, sky.nchunk)
    hb, bb = sol.read_solutions(sr, sky.nchunk)
    assert ha == hb and len(ba) == len(bb) == 1
    for a, b in zip(ba, bb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    for a, b, raw in zip(pg, pr, paths):
        xa = tds.SimMS(a, data_column="CORRECTED_DATA").read_tile(0).x
        xb = ds.SimMS(b, data_column="CORRECTED_DATA").read_tile(0).x
        x0 = ds.SimMS(raw).read_tile(0).x
        scale = np.abs(x0).max()
        assert np.abs(xa - xb).max() <= 1e-7 * scale
        assert not np.array_equal(xa, x0)


def test_federated_record(runs):
    """run_federated's record: FEDA per outer iteration, each slave's
    residual falling, the band solves' iterations and flagged bands per
    outer iteration and slave, and no solve kernel or XLA solve."""
    _, _, _, out = runs
    rec = out["plain"]["torch"][0][0]
    assert len(rec["feda"]) == 2 and rec["feda"][-1] > 0
    assert len(rec["slave_res"]) == 2
    assert all(r1 < r0 for r0, r1 in rec["slave_res"])
    assert len(rec["lbfgs_iters"]) == 2 and len(rec["lbfgs_iters"][0]) == 2
    assert len(rec["lbfgs_iters"][0][0]) == 2          # 1 epoch x 2 mb
    assert all(len(w) == 2 for w in rec["lbfgs_iters"][0][0])
    assert rec["flagged_bands"][0][0] == [[], []]
    assert rec["launches"]["sweep"] == rec["launches"]["matvec"] == 0
    assert rec["xla_solves"] == 0


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_fed_setup_matches_reference(runs, tag):
    """_fed_setup against the JAX package's: the mini-bands' bases, the
    federated inverses (sum_b rho_b B_b B_b^T + alpha I)^-1, the alpha
    and rho tables, and every slave's initial solutions."""
    tmp, paths, _, out = runs
    kw = out[tag]["torch"][3]
    ref = federated._fed_setup(RunConfig(ms=paths[0], **kw), paths)
    got = tfederated._fed_setup(TRunConfig(ms=paths[0], **kw), paths, "cpu",
                                lambda *a: None)
    _, _, _, alpha_r, Bs_r, Biis_r, rhoks_r, states_r = ref
    _, _, runners, alpha, Bs, Biis, rhoks, states = got
    assert len(runners) == len(paths)
    np.testing.assert_array_equal(alpha, alpha_r)
    for a, b in zip(rhoks, rhoks_r):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(Bs, Bs_r):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for a, b in zip(Biis, Biis_r):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    for sa, sb in zip(states, states_r):
        for a, b in zip(sa["pfreq"], sb["pfreq"]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-14)


class _Part:
    n_tiles = 5


@pytest.mark.parametrize("skip,most,tiles", [(0, 0, [0, 1, 2, 3, 4]),
                                             (1, 2, [1, 2]),
                                             (3, 0, [3, 4]),
                                             (4, 9, [4])])
def test_federated_window(skip, most, tiles):
    """The tiles a federated run calibrates: -K skipped, at most -T, within
    the slaves' common count (the JAX run's start and stop)."""
    cfg = TRunConfig(ms="x", skip_timeslots=skip, max_timeslots=most)
    assert list(tfederated._window(cfg, [_Part(), _Part()])) == tiles
