"""In-flight cluster groups of the port (``--inflight``;
sagecal_tpu_torch/solvers/sage.py) against the JAX reference in float64.

- The group widths: ``_eff_inflight`` (clamped to M//4) and
  ``_inflight_widths`` (a cold first sweep at most 2 wide) against the
  JAX functions.
- ``sagefit_host`` with ``inflight=2`` at M = 8 (8 stations, 4 timeslots,
  ``-R 0``, 2 EM sweeps) against the JAX ``sagefit_host`` (kernel pallas,
  fuse and promote off: the host group loop over the vmapped solves) for
  ``-j 1``, ``-j 3`` (single-chunk clusters), ``-j 5 --inner chol`` and
  ``-j 5 --inner cg``. Gates: res_0/res_1 rtol 1e-8, J atol 1e-6, mean nu,
  rejected groups and executed LM/RTR iterations and PCG trips equal.
- Each lane of one group solve against the port's own serial
  ``_cluster_solve`` of that cluster (1e-12), in every solver mode, with
  per-lane iteration caps and OS draws.
- The ragged last group (M = 9, G = 2) against the JAX group update
  driven group by group with the last group's members trimmed to its one
  real cluster: the documented contract (padded slots contribute nothing),
  which the reference's own padding breaks (its out-of-range lane fills
  with NaN and rejects the group; ROADMAP queue C) — witnessed here too.
- The divergence downgrade to sequential updates (sticky).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.rime import predict as rp
from sagecal_tpu.solvers import lm as lm_mod
from sagecal_tpu.solvers import sage
from sagecal_tpu_torch import pipeline as tpipeline
from sagecal_tpu_torch.rime import predict as trp
from sagecal_tpu_torch.solvers import lm as tlm
from sagecal_tpu_torch.solvers import sage as tsage

from test_sage import _calib_problem

N, T = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _inputs(M, nchunk, seed=4):
    """A calibration problem of M clusters (tests/test_sage.py), its solve
    coherencies and the sagefit_host arguments, as numpy arrays."""
    sky, dsky, _, tile = _calib_problem(n_stations=N, tilesz=T, n_clusters=M,
                                        nchunk=nchunk, noise=0.05, seed=seed)
    coh = np.asarray(rp.coherencies(
        dsky, jnp.asarray(tile.u), jnp.asarray(tile.v), jnp.asarray(tile.w),
        jnp.asarray([tile.freq0]), tile.fdelta)[:, :, 0])
    xa = tile.averaged()
    x8 = np.stack([xa.reshape(-1, 4).real, xa.reshape(-1, 4).imag],
                  -1).reshape(-1, 8)
    x8[::13] += 1.0                                     # outlier rows
    cidx = rp.chunk_indices(tile.tilesz, tile.nbase, sky.nchunk)
    kmax = int(sky.nchunk.max())
    cmask = np.arange(kmax)[None, :] < sky.nchunk[:, None]
    J0 = np.tile(np.eye(2, dtype=complex), (M, kmax, N, 1, 1))
    return dict(x8=x8, coh=coh, sta1=tile.sta1, sta2=tile.sta2, cidx=cidx,
                cmask=cmask, J0=J0, wt=np.ones((x8.shape[0], 8)),
                nbase=tile.nbase, os_id=lm_mod.os_subset_ids(T, tile.nbase))


def _args(d, conv):
    return [conv(d[k]) for k in ("x8", "coh", "sta1", "sta2", "cidx",
                                 "cmask", "J0")]


@pytest.mark.parametrize("G,M,warm", [(1, 100, False), (2, 8, False),
                                      (2, 9, True), (4, 16, False),
                                      (4, 16, True), (4, 7, False),
                                      (8, 32, False), (50, 100, True)])
def test_widths_match_reference(G, M, warm):
    ref = sage.SageConfig(inflight=G, inflight_warm=warm)
    got = tsage.SageConfig(inflight=G, inflight_warm=warm)
    assert tsage._eff_inflight(got, M) == sage._eff_inflight(ref, M)
    assert tsage._inflight_widths(got, M) == sage._inflight_widths(ref, M)


#: (mode, inner, chunks of the 8 clusters): OS robust LM under Cholesky on
#: single-chunk clusters (test_torch_sage_lm.py: a 2-chunk OS cluster
#: amplifies roundoff in both packages)
CASES = [(1, "chol", (1, 2) * 4), (3, "chol", (1,) * 8),
         (5, "chol", (1, 2) * 4), (5, "cg", (1, 2) * 4)]


def _pair(mode, inner, nchunk):
    d = _inputs(8, nchunk)
    common = dict(max_emiter=2, max_iter=4, max_lbfgs=3, lbfgs_m=3,
                  solver_mode=mode, randomize=False, nbase=d["nbase"],
                  inner=inner, inflight=2)
    ref = sage.sagefit_host(
        *_args(d, jnp.asarray), N, jnp.asarray(d["wt"]),
        config=sage.SageConfig(kernel="pallas", fuse="off", promote="off",
                               **common), os_id=d["os_id"])
    got = tsage.sagefit_host(*_args(d, _t), N, _t(d["wt"]),
                             config=tsage.SageConfig(**common),
                             os_id=d["os_id"])
    return ref, got


@pytest.fixture(scope="module")
def runs():
    return {case[:2]: _pair(*case) for case in CASES}


@pytest.mark.parametrize("mode,inner", [c[:2] for c in CASES])
def test_sagefit_host_groups_match_reference(runs, mode, inner):
    (J, info), (tJ, tinfo) = runs[(mode, inner)]
    for key in ("res_0", "res_1"):
        np.testing.assert_allclose(float(tinfo[key]), float(info[key]),
                                   rtol=1e-8)
    assert float(tinfo["mean_nu"]) == float(info["mean_nu"])
    for key in ("solver_iters", "cg_iters", "rejected_groups",
                "lbfgs_iters"):
        assert tinfo[key] == int(info[key]), key
    np.testing.assert_allclose(tJ.numpy(), np.asarray(J), atol=1e-6)
    # 2 sweeps of 4 groups of 2, each accepted at some relaxation
    assert [len(g[1]) for g in tinfo["groups"]] == [2] * 8
    assert all(g[2] in tsage.OMEGAS for g in tinfo["groups"])
    assert tinfo["res_1"] < float(tinfo["res_0"])
    assert (tinfo["cg_iters"] > 0) == (mode == 1 and inner == "cg")


def test_relaxed_groups_match_reference():
    """Groups of 4 at M = 16 from an identity start without the cold
    first-sweep restriction: the joint update overcorrects and half the
    groups step at omega = 1/2 in the port; the reference lands on the
    same solutions, so it took the same relaxations."""
    M = 16
    d = _inputs(M, (1,) * M)
    common = dict(max_emiter=2, max_iter=4, max_lbfgs=0, solver_mode=1,
                  randomize=False, nbase=d["nbase"], inflight=4,
                  inflight_warm=True)
    J, info = sage.sagefit_host(
        *_args(d, jnp.asarray), N, jnp.asarray(d["wt"]),
        config=sage.SageConfig(kernel="pallas", fuse="off", promote="off",
                               **common))
    tJ, tinfo = tsage.sagefit_host(*_args(d, _t), N, _t(d["wt"]),
                                   config=tsage.SageConfig(**common))
    omegas = [g[2] for g in tinfo["groups"]]
    assert 0.5 in omegas and 1.0 in omegas and len(omegas) == 8
    np.testing.assert_allclose(float(tinfo["res_1"]), float(info["res_1"]),
                               rtol=1e-8)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(J), atol=1e-6)
    assert tinfo["solver_iters"] == int(info["solver_iters"])
    assert tinfo["rejected_groups"] == int(info["rejected_groups"]) == 0


def _lane_problem(seed=6):
    d = _inputs(8, (1, 2) * 4, seed=seed)
    x8, coh = _t(d["x8"]), _t(d["coh"])
    s1, s2 = _t(d["sta1"]).long(), _t(d["sta2"]).long()
    cidx, cmask = _t(d["cidx"]).long(), _t(d["cmask"])
    rng = np.random.default_rng(seed)
    J = _t(d["J0"]) + 0.05 * _t(rng.normal(size=d["J0"].shape))
    xres = x8 - tsage.full_model8(J, coh, s1, s2, cidx)
    return d, x8, coh, s1, s2, cidx, cmask, J, xres


@pytest.mark.parametrize("mode,inner", [(0, "chol"), (1, "cg"), (2, "chol"),
                                        (3, "cg"), (4, "chol"), (5, "cg"),
                                        (6, "chol")])
def test_group_lanes_match_serial_solves(mode, inner):
    """A group of clusters 2 (two chunks) and 5 (one chunk) with per-lane
    iteration caps 3 and 5 and seeded OS draws: each lane's result is the
    serial solve's."""
    d, x8, coh, s1, s2, cidx, cmask, J, xres = _lane_problem()
    cfg = tsage.SageConfig(max_iter=4, solver_mode=mode, randomize=True,
                           inner=inner, nbase=d["nbase"])
    cjs, caps = [2, 5], [3, 5]
    os_ids = (_t(d["os_id"][0]).long(), d["os_id"][1])
    os_cfgs = [tlm.OSConfig(os_id=os_ids[0], n_subsets=os_ids[1],
                            seed=tlm.fold_in(11, cj)) for cj in cjs]
    nu = torch.tensor([3.0, 4.0], dtype=torch.float64)
    xd = torch.stack([xres + trp.model8(coh[cj], J[cj], s1, s2, cidx[cj])
                      for cj in cjs])
    idx = torch.tensor(cjs)
    got = tsage._group_solve(mode, xd, coh[idx], cidx[idx], cmask[idx],
                             J[idx], nu, s1, s2, _t(d["wt"]), N, cfg, caps,
                             12, os_cfgs, False, None, cid_shared=False)
    for v, cj in enumerate(cjs):
        ref = tsage._cluster_solve(mode, xd[v], coh[cj], s1, s2, cidx[cj],
                                   cmask[cj], _t(d["wt"]), J[cj], N,
                                   nu[v].clone(), cfg, caps[v], 12,
                                   os_cfgs[v], False, None)
        np.testing.assert_allclose(got[0][v].numpy(), ref[0].numpy(),
                                   atol=1e-12, err_msg=f"lane {v} J")
        assert float(got[1][v]) == float(ref[1]), f"lane {v} nu"
        for i in (2, 3):
            np.testing.assert_allclose(got[i][v].numpy(), ref[i].numpy(),
                                       rtol=1e-12, err_msg=f"lane {v} {i}")
        assert int(got[4][v]) == int(ref[4]), f"lane {v} iterations"
        assert int(got[5][v]) == int(ref[5]), f"lane {v} PCG trips"


def _jax_groups(d, cfg, M, G, trim: bool):
    """The JAX package's host group loop (``sage.sagefit_host``'s unfused
    branch) driven group by group; the last group's members trimmed to
    its real clusters when ``trim``, else padded with the index M as the
    reference pads it. Returns (J, res_1, rejected groups)."""
    x8, coh, s1, s2, cidx, cmask, J = _args(d, jnp.asarray)
    wt = jnp.asarray(d["wt"])
    xres, _ = sage._jit_prelude(x8, coh, s1, s2, cidx, J, wt)
    total_iter = M * cfg.max_iter
    iter_bar = int(-(-0.8 * total_iter // M))
    dev_cfg = cfg._replace(max_emiter=0, fuse="auto", promote="auto",
                           inflight_warm=False, inflight=G)
    nerr = jnp.zeros((M,))
    nuM = jnp.full((M,), cfg.nulow)
    key = jax.random.PRNGKey(42)
    rejected = 0
    for ci in range(cfg.max_emiter):
        anchor = sage._jit_wres2(xres, wt)
        nerr_acc = jnp.zeros((M,))
        order = list(range(M)) + ([] if trim else [M] * (-M % G))
        for g in range(0, len(order), G):
            J, xres, nerr_acc, nuM, tk = sage._jit_group_update(
                jnp.asarray(order[g:g + G], jnp.int32), J, xres, nerr_acc,
                nuM, x8, coh, s1, s2, cidx, cmask, wt, nerr,
                jnp.asarray(False), jnp.asarray(ci == cfg.max_emiter - 1),
                jax.random.fold_in(key, ci), None, N, dev_cfg, total_iter,
                iter_bar, 0, anchor)
            rejected += int(tk[1])
        total = jnp.sum(nerr_acc)
        nerr = jnp.where(total > 0, nerr_acc / jnp.maximum(total, 1e-30),
                         nerr_acc)
    return np.asarray(J), float(sage._jit_res(x8, coh, s1, s2, cidx, J,
                                              wt)), rejected


def test_ragged_group_solved_by_contract():
    M, G = 9, 2
    d = _inputs(M, (1,) * M, seed=5)
    common = dict(max_emiter=2, max_iter=4, max_lbfgs=0, solver_mode=1,
                  randomize=False, nbase=d["nbase"], inflight=G,
                  inflight_warm=True)
    Jr, res_r, rej_r = _jax_groups(
        d, sage.SageConfig(kernel="pallas", **common), M, G, trim=True)
    tJ, tinfo = tsage.sagefit_host(*_args(d, _t), N, _t(d["wt"]),
                                   config=tsage.SageConfig(**common))
    assert rej_r == tinfo["rejected_groups"] == 0
    assert [len(g[1]) for g in tinfo["groups"]] == [2, 2, 2, 2, 1] * 2
    np.testing.assert_allclose(tJ.numpy(), Jr, atol=1e-6)
    np.testing.assert_allclose(tinfo["res_1"], res_r, rtol=1e-8)
    # the last cluster moved
    assert np.abs(tJ.numpy()[M - 1] - d["J0"][M - 1]).max() > 1e-3
    # the reference's own padding: the ragged group is rejected every
    # sweep and the last cluster never moves
    Jp, _, rej_p = _jax_groups(
        d, sage.SageConfig(kernel="pallas", **common), M, G, trim=False)
    assert rej_p == common["max_emiter"]
    np.testing.assert_array_equal(Jp[M - 1], d["J0"][M - 1])


def test_inflight_downgrade_is_sticky():
    pl = object.__new__(tpipeline.FullBatchPipeline)
    pl.base_cfg = tsage.SageConfig(inflight=2)
    logs = []
    pl._inflight_downgrade(log=logs.append)
    assert pl.base_cfg.inflight == 1 and len(logs) == 1
    pl._inflight_downgrade(log=logs.append)
    assert len(logs) == 1


def test_sequential_width_keeps_serial_path():
    """M < 8 clamps any width to 1: no group record, the serial loop."""
    d = _inputs(4, (1, 2, 1, 1))
    cfg = tsage.SageConfig(max_emiter=1, max_iter=3, max_lbfgs=0,
                           solver_mode=1, randomize=False, nbase=d["nbase"])
    a = tsage.sagefit_host(*_args(d, _t), N, _t(d["wt"]), config=cfg)
    b = tsage.sagefit_host(*_args(d, _t), N, _t(d["wt"]),
                           config=cfg._replace(inflight=4))
    assert b[1]["groups"] == [] and b[1]["rejected_groups"] == 0
    assert torch.equal(a[0], b[0]) and a[1]["res_1"] == b[1]["res_1"]
