"""``sagefit_host_tiles`` of the port (T solve intervals as one
lane-batched SAGE solve; sagecal_tpu_torch/solvers/sage.py) against the
JAX package's ``sagefit_host_tiles`` in float64.

The problem is tests/test_tiles.py's ``_tiles_problem`` (8 stations, 6
timeslots, 2 clusters of 1 and 2 hybrid chunks, tile t simulated with
its own seed and a tenth of its rows flagged with its own seed, so that
the lanes' weights differ) at T = 2 and 3 tiles, or the same with 8
clusters for the in-flight groups (G = 2 survives the M // 4 clamp).
The reference runs on its CPU route with fuse and promote off (the host
loop over its vmapped cluster and group updates; ``--kernel pallas`` in
interpret mode). Cases: LM, robust LM, OS robust LM, RTR, robust RTR
and NSD, ``--inner chol`` and ``cg``, both assemblies, Jones diag and
phase, and ``inflight = 2``, all at ``-R 0``; and LM, robust RTR and
NSD with ``randomize`` on (LM on 8 clusters), where the port is fed the
reference's per-tile permutations (JAX keys cannot be reproduced) and
each tile's weighted sweep sorts and caps its visits by its own cost
reductions. Gates: J atol 1e-6, res_0/res_1 rtol 1e-8, per-tile mean nu
and trip counts equal.

The port against itself: every tile of a batch is the solo
``sagefit_host`` of that tile with the same seed (OS draws and orders
from the seed, per-tile caps) to 1e-10; ``sagefit_host`` is T = 1 bit
for bit; ``tile_seeds`` keeps tile 0 on the single-tile default.

The reference cases are split by family, one file each, so that the
files' solves spread over workers: this file holds the LM family (LM,
robust LM, OS robust LM) and the port-only checks;
test_torch_tiles_rtr.py the RTR family, test_torch_tiles_routes.py the
XLA assembly and the constrained Jones modes,
test_torch_tiles_inflight.py the in-flight groups and
test_torch_tiles_random.py the ``randomize`` cases, each with the
helpers here."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.io import dataset as ds
from sagecal_tpu.rime import predict as rp
from sagecal_tpu.solvers import lm as lm_mod
from sagecal_tpu.solvers import sage
from sagecal_tpu_torch.solvers import sage as tsage

from test_sage import _calib_problem
from test_tiles import _tiles_problem

N = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


#: share of a tile's rows flagged (weight 0), drawn with the tile's own
#: seed, so that every lane of a batch carries weights of its own
FLAG_FRACTION = 0.1


def _problem(T, M=2):
    """``_tiles_problem`` at T tiles (M = 2) or its 8-cluster twin (one
    chunk a cluster but the second and sixth, two), each tile's rows
    flagged at FLAG_FRACTION with its own seed: (x8, coh, sta1, sta2,
    cidx, cmask, J0, wt, nbase, os_id) as numpy arrays."""
    if M == 2:
        _, tiles, coh, x8, wt, J0, cidx, cmask = _tiles_problem(n_tiles=T)
    else:
        nchunk = tuple(2 if m in (1, 5) else 1 for m in range(M))
        sky, dsky, Jtrue, tile0 = _calib_problem(
            n_stations=N, tilesz=6, n_clusters=M, nchunk=nchunk, noise=0.01,
            seed=0)
        tiles = [tile0] + [
            ds.simulate_dataset(dsky, n_stations=N, tilesz=6, freqs=[150e6],
                                ra0=0.1, dec0=0.8, jones=Jtrue,
                                nchunk=sky.nchunk, noise_sigma=0.01,
                                seed=100 + t) for t in range(1, T)]
        cidx = rp.chunk_indices(6, tile0.nbase, sky.nchunk)
        kmax = int(sky.nchunk.max())
        cmask = np.arange(kmax)[None, :] < sky.nchunk[:, None]
        coh = np.stack([np.asarray(rp.coherencies(
            dsky, jnp.asarray(t.u), jnp.asarray(t.v), jnp.asarray(t.w),
            jnp.asarray([t.freq0]), t.fdelta)[:, :, 0]) for t in tiles])
        x8 = np.stack([np.stack([t.averaged().reshape(-1, 4).real,
                                 t.averaged().reshape(-1, 4).imag],
                                -1).reshape(-1, 8) for t in tiles])
        wt = np.ones(x8.shape)
        J0 = np.tile(np.eye(2, dtype=complex), (T, M, kmax, N, 1, 1))
    wt = wt.copy()
    for t in range(T):
        rng = np.random.default_rng(300 + t)
        wt[t, rng.random(wt.shape[1]) < FLAG_FRACTION] = 0.0
    t0 = tiles[0]
    return dict(x8=x8, coh=coh, sta1=t0.sta1, sta2=t0.sta2, cidx=cidx,
                cmask=cmask, J0=J0, wt=wt, nbase=t0.nbase,
                os_id=lm_mod.os_subset_ids(t0.tilesz, t0.nbase))


def _args(d, conv):
    return [conv(d[k]) for k in ("x8", "coh", "sta1", "sta2", "cidx",
                                 "cmask", "J0")]


class RefOrder:
    """The reference's visiting order of one tile: its key's permutation
    on unweighted sweeps (``_cluster_perm``), descending cost reduction
    on weighted ones (:class:`tsage.ClusterOrder`'s rule)."""

    def __init__(self, key):
        self.key = key

    def order(self, ci, M, nerr, weighted, randomize):
        if weighted:
            return tsage.ClusterOrder(0).order(ci, M, nerr, True, randomize)
        return np.asarray(jax.random.permutation(
            jax.random.fold_in(self.key, 104729 + ci), M))


#: (tag, tiles, clusters, solver mode, inner, kernel, jones, inflight,
#: randomize). OS robust LM (3) under PCG: under Cholesky its 2-chunk
#: cluster amplifies float64 roundoff in both packages (ROADMAP queue C
#: item 4).
CASES = [
    ("lm", 2, 2, 1, "chol", "pallas", "full", 1, False),
    ("lm_cg_t3", 3, 2, 1, "cg", "pallas", "full", 1, False),
    ("rlm", 2, 2, 2, "chol", "pallas", "full", 1, False),
    ("oslm_cg", 2, 2, 3, "cg", "pallas", "full", 1, False),
    ("rtr", 2, 2, 4, "chol", "pallas", "full", 1, False),
    ("rrtr_t3", 3, 2, 5, "chol", "pallas", "full", 1, False),
    ("rrtr_cg", 2, 2, 5, "cg", "pallas", "full", 1, False),
    ("nsd", 2, 2, 6, "chol", "pallas", "full", 1, False),
    ("lm_xla", 2, 2, 1, "chol", "xla", "full", 1, False),
    ("rrtr_cg_xla", 2, 2, 5, "cg", "xla", "full", 1, False),
    ("lm_diag", 2, 2, 1, "chol", "pallas", "diag", 1, False),
    ("rrtr_cg_phase", 2, 2, 5, "cg", "pallas", "phase", 1, False),
    ("lm_inflight", 2, 8, 1, "chol", "pallas", "full", 2, False),
    ("rrtr_cg_inflight", 2, 8, 5, "cg", "pallas", "full", 2, False),
    ("lm_random", 3, 8, 1, "chol", "pallas", "full", 1, True),
    ("rrtr_random", 2, 2, 5, "cg", "pallas", "full", 1, True),
    ("nsd_random", 2, 2, 6, "chol", "pallas", "full", 1, True),
]


def _pair(tag, T, M, mode, inner, kernel, jones, inflight, randomize):
    d = _problem(T, M)
    common = dict(max_emiter=3 if randomize else 2,
                  max_iter=6 if randomize else 4, max_lbfgs=3,
                  lbfgs_m=3, solver_mode=mode, randomize=randomize,
                  nbase=d["nbase"], inner=inner, kernel=kernel,
                  jones_mode=jones, inflight=inflight,
                  inflight_warm=inflight > 1)
    os_id = d["os_id"] if mode in (0, 2, 3) else None
    keys = sage.tile_keys(T)
    ref = sage.sagefit_host_tiles(
        *_args(d, jnp.asarray), N, jnp.asarray(d["wt"]),
        config=sage.SageConfig(fuse="off", promote="off", **common),
        os_id=os_id, keys=keys)
    got = tsage.sagefit_host_tiles(
        *_args(d, _t), N, _t(d["wt"]), config=tsage.SageConfig(**common),
        os_id=os_id,
        orders=[RefOrder(k) for k in keys] if randomize else None)
    return ref, got


class _Runs(dict):
    """tag -> (reference, port) results, each pair computed on first use,
    so a worker computes only the cases of the tests it runs."""

    def __missing__(self, tag):
        case = next(c for c in CASES if c[0] == tag)
        self[tag] = _pair(*case)
        return self[tag]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


#: the LM family: this file's reference cases
TAGS = ("lm", "lm_cg_t3", "rlm", "oslm_cg")


def check_pair(runs, tag):
    """The gates of one reference case (J atol 1e-6, res_0/res_1 rtol
    1e-8, per-tile mean nu and trip counts equal)."""
    (J, info), (tJ, tinfo) = runs[tag]
    T = J.shape[0]
    assert tJ.shape == J.shape
    for key in ("res_0", "res_1"):
        np.testing.assert_allclose(np.asarray(tinfo[key]),
                                   np.asarray(info[key]), rtol=1e-8,
                                   err_msg=key)
    assert tinfo["mean_nu"].tolist() == np.asarray(info["mean_nu"]).tolist()
    for key in ("solver_iters", "cg_iters", "rejected_groups",
                "lbfgs_iters"):
        assert tinfo[key].tolist() == np.asarray(info[key]).tolist(), key
    np.testing.assert_allclose(tJ.numpy(), np.asarray(J), atol=1e-6)
    np.testing.assert_allclose(tinfo["nerr"].numpy(), np.asarray(info["nerr"]),
                               atol=1e-8)
    assert len(tinfo["groups"]) == T
    assert all(tinfo["res_1"] < tinfo["res_0"].numpy())


def check_tcg_and_nu(runs, tag):
    """A robust RTR case under PCG: tCG products on every tile, robust
    nu off its start."""
    assert (runs[tag][1][1]["tcg_iters"] > 0).all()
    assert (runs[tag][1][1]["mean_nu"] != 2.0).all()


def check_groups_of_two(runs, tag):
    """An in-flight case: groups of 2 in every sweep of every tile."""
    groups = runs[tag][1][1]["groups"]
    assert all(len(g) == 8 and all(len(r[1]) == 2 for r in g)
               for g in groups)


@pytest.mark.parametrize("tag", TAGS)
def test_sagefit_host_tiles_matches_reference(runs, tag):
    check_pair(runs, tag)


def test_cases_reach_their_routes(runs):
    """The cases exercise what they name: PCG trips on every tile of the
    3-tile LM batch (the other families check theirs in their files:
    tCG products per tile, groups of 2 in every tile, robust nu off its
    start, constrained solutions, per-tile caps on weighted sweeps)."""
    lm = runs["lm_cg_t3"][1][1]
    assert (lm["cg_iters"] > 0).all() and len(lm["res_1"]) == 3


def _port_pair(mode, inner, T=3, randomize=True, inflight=1, M=2):
    d = _problem(T, M)
    cfg = tsage.SageConfig(max_emiter=3, max_iter=4, max_lbfgs=2, lbfgs_m=3,
                           solver_mode=mode, randomize=randomize,
                           nbase=d["nbase"], inner=inner, inflight=inflight,
                           inflight_warm=inflight > 1)
    args = _args(d, _t)
    seeds = [199000 + t for t in range(T)]
    got = tsage.sagefit_host_tiles(*args, N, _t(d["wt"]), config=cfg,
                                   seeds=seeds, os_id=d["os_id"])
    solo = [tsage.sagefit_host(
        args[0][t], args[1][t], *args[2:6], args[6][t], N, _t(d["wt"][t]),
        config=cfg, seed=seeds[t], os_id=d["os_id"]) for t in range(T)]
    return got, solo


@pytest.mark.parametrize("mode,inner,inflight,M",
                         [(0, "cg", 1, 2), (3, "chol", 1, 2),
                          (4, "cg", 1, 2), (6, "chol", 1, 2),
                          (2, "cg", 2, 8)])
def test_each_tile_is_its_solo_solve(mode, inner, inflight, M):
    """-R 1 with seeded OS draws and orders per tile and per-tile caps on
    the weighted sweep: every lane of the batch is the tile's own
    sagefit_host, its iterations and trips included."""
    (J, info), solo = _port_pair(mode, inner, inflight=inflight, M=M)
    for t, (Js, s) in enumerate(solo):
        np.testing.assert_allclose(J[t].numpy(), Js.numpy(), atol=1e-10,
                                   err_msg=f"tile {t}")
        np.testing.assert_allclose(info["res_1"][t], s["res_1"], rtol=1e-10)
        assert float(info["mean_nu"][t]) == float(s["mean_nu"])
        for key in ("solver_iters", "cg_iters", "tcg_iters", "lbfgs_iters",
                    "rejected_groups"):
            assert int(info[key][t]) == int(s[key]), (t, key)
        assert [g[:3] for g in info["groups"][t]] == \
            [g[:3] for g in s["groups"]]


def test_single_tile_is_sagefit_host(monkeypatch):
    """sagefit_host is the tiles loop at T = 1: the same numbers in the
    batched layout (every entry with a leading [1]), and its sequential
    visits solve unfolded, with no lanes (on the card the single-visit
    sweep, as the reference's T = 1 fast path takes sagefit_host)."""
    lanes_seen = []
    solve = tsage._cluster_solve

    def spy(*args, lanes=None, **kw):
        lanes_seen.append(lanes)
        return solve(*args, lanes=lanes, **kw)

    monkeypatch.setattr(tsage, "_cluster_solve", spy)
    d = _problem(1)
    cfg = tsage.SageConfig(max_emiter=2, max_iter=4, max_lbfgs=2,
                           solver_mode=5, inner="cg", nbase=d["nbase"])
    args = _args(d, _t)
    J, info = tsage.sagefit_host_tiles(*args, N, _t(d["wt"]), config=cfg)
    Js, s = tsage.sagefit_host(args[0][0], args[1][0], *args[2:6],
                               args[6][0], N, _t(d["wt"][0]), config=cfg)
    assert torch.equal(J[0], Js)
    assert info["res_1"].tolist() == [s["res_1"]]
    for key in ("res_0", "mean_nu", "nerr"):
        assert torch.equal(info[key][0], s[key])
    for key in tsage._TILE_TRIPS:
        assert info[key].tolist() == [s[key]]
    assert info["groups"] == [s["groups"]]
    assert lanes_seen and all(la is None for la in lanes_seen)


def test_tile_seeds_keep_tile0_default():
    seeds = tsage.tile_seeds(4)
    assert seeds[0] == 42 and len(set(seeds)) == 4
    assert tsage.tile_seeds(1) == [42]
    assert tsage.tile_seeds(3, base=7)[0] == 7
