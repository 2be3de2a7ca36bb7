"""The port's consensus-ADMM runner (``consensus/admm.py``) against the
JAX package's ``make_admm_runner(..., host_loop=True)`` on a one-device
mesh, in float64: 4 subbands of an 8-station problem with gains smooth in
frequency (the shape of ``tests/test_consensus.py``'s runner tests), at
-R 0 on the XLA assembly. All eight outputs (JF, Z, rhoF, res0, res1,
r1s, duals, Y0F), with a scalar rho and fixed, and with a per-cluster
rho array (``-G``) and the Barzilai-Borwein update (``-C 1``); and the
port's iterations k > 0 from the JAX runner's own iteration-0 carry
(``convert.admm_state_from_numpy``) against the JAX iterations from it.
Each output is held within max(1e-8, 10 x the JAX runner's own spread
under a one-ulp move of the data, up or down) of its largest magnitude
(that spread is ~1e-9 for J, Z, r1s and the duals); the residual norms
(res0, res1, r1s) of the largest of that and the data's own norm ||x w|| /
(8 B): a residual ~1e-2 of the data is their difference, so its
roundoff is the data's. The divergence reset follows the JAX rule."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from sagecal_tpu import skymodel, utils
from sagecal_tpu.config import SolverMode
from sagecal_tpu.consensus import admm as cadmm
from sagecal_tpu.consensus import poly as cpoly
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.rime import predict as rp
from sagecal_tpu.solvers import lm as lm_mod, sage
from sagecal_tpu_torch import convert
from sagecal_tpu_torch import skymodel as tsky
from sagecal_tpu_torch.consensus import admm as tadmm
from sagecal_tpu_torch.rime import predict as trp
from sagecal_tpu_torch.solvers import sage as tsage

RTOL = 1e-8
NAMES = ("JF", "Z", "rhoF", "res0", "res1", "r1s", "duals", "Y0F")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def subband_problem(nf=4, n_stations=8, tilesz=2, seed=0):
    """Two clusters of two points, gains J_f = J0 + slope (f - f0)/f0 over
    ``nf`` subbands 2% apart; the JAX and the port's skies built from the
    same sources."""
    rng = np.random.default_rng(seed)
    srcs, tsrcs, clusters = {}, {}, []
    for m in range(2):
        names = []
        for s in range(2):
            nm = f"P{m}_{s}"
            ll, mm = rng.normal(0, 0.02, 2)
            nn = np.sqrt(1 - ll * ll - mm * mm)
            kw = dict(name=nm, ra=0, dec=0, ll=ll, mm=mm, nn=nn - 1, sI=2.0,
                      sQ=0, sU=0, sV=0, sI0=2.0, sQ0=0, sU0=0, sV0=0,
                      spec_idx=0, spec_idx1=0, spec_idx2=0, f0=150e6)
            srcs[nm] = skymodel.Source(**kw)
            tsrcs[nm] = tsky.Source(**kw)
            names.append(nm)
        clusters.append((m, 1, names))
    sky = skymodel.build_cluster_sky(srcs, clusters)
    tsky_ = tsky.build_cluster_sky(tsrcs, clusters)
    dsky = rp.sky_to_device(sky, jnp.float64)
    freqs = 150e6 * (1 + 0.02 * np.arange(nf))
    Jbase = ds.random_jones(2, sky.nchunk, n_stations, seed=seed + 1,
                            scale=0.15)
    slope = ds.random_jones(2, sky.nchunk, n_stations, seed=seed + 2,
                            scale=0.05) - np.eye(2)
    tiles = [ds.simulate_dataset(
        dsky, n_stations=n_stations, tilesz=tilesz, freqs=[fr], ra0=0.1,
        dec0=0.9, jones=Jbase + slope * (fr - 150e6) / 150e6,
        nchunk=sky.nchunk, noise_sigma=0.01, seed=seed + 3)
        for fr in freqs]
    return sky, tsky_, dsky, freqs, tiles


def stacked_inputs(tiles, sky):
    """The runner's [F, ...] inputs as numpy (identity J0)."""
    def stack(fn):
        return np.stack([fn(t) for t in tiles])
    n = tiles[0].n_stations
    kmax = int(sky.nchunk.max())
    x8F = stack(lambda t: utils.vis_to_x8(t.averaged()))
    wtF = stack(lambda t: np.asarray(lm_mod.make_weights(
        jnp.asarray(t.flags, jnp.int32), jnp.float64)))
    J0F = utils.jones_c2r_np(np.tile(np.eye(2, dtype=complex),
                                     (len(tiles), sky.n_clusters, kmax, n,
                                      1, 1)))
    return [x8F, stack(lambda t: t.u), stack(lambda t: t.v),
            stack(lambda t: t.w), None, wtF, np.ones(len(tiles)), J0F]


def _cfgs(rho, adaptive):
    kw = dict(max_emiter=2, max_iter=5, max_lbfgs=2,
              solver_mode=int(SolverMode.LM_LBFGS), randomize=False,
              kernel="xla")
    jc = cadmm.ADMMConfig(n_admm=4, npoly=2, rho=rho, manifold_iters=3,
                          adaptive_rho=adaptive, sage=sage.SageConfig(**kw))
    tc = tadmm.ADMMConfig(n_admm=4, npoly=2, rho=rho, manifold_iters=3,
                          adaptive_rho=adaptive,
                          sage=tsage.SageConfig(**kw))
    return jc, tc


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _close(name, got, want, spread):
    gate = max(RTOL, 10.0 * spread.get(name, 0.0))
    rel = _rel(got, want)
    if name in ("res0", "res1", "r1s"):
        # the residual's roundoff is the data's: scale by the data norm
        want = np.asarray(want)
        rel = rel * np.abs(want).max() / max(np.abs(want).max(),
                                             spread["data"])
    assert rel <= gate, (name, rel, gate)


@pytest.fixture(scope="module")
def problem():
    sky, tsky_, dsky, freqs, tiles = subband_problem()
    kmax = int(sky.nchunk.max())
    cmask = np.arange(kmax)[None, :] < sky.nchunk[:, None]
    cidx = rp.chunk_indices(tiles[0].tilesz, tiles[0].nbase, sky.nchunk)
    B = cpoly.setup_polynomials(freqs, float(np.mean(freqs)), 2, 2)
    arrs = stacked_inputs(tiles, sky)
    arrs[4] = freqs
    return sky, tsky_, dsky, freqs, tiles, cmask, cidx, B, arrs


def _runners(problem, rho, adaptive):
    sky, tsky_, dsky, freqs, tiles, cmask, cidx, B, arrs = problem
    t0 = tiles[0]
    jc, tc = _cfgs(rho, adaptive)
    mesh = Mesh(np.array(jax.devices()[:1]), ("freq",))
    jrun = cadmm.make_admm_runner(dsky, t0.sta1, t0.sta2, cidx, cmask,
                                  t0.n_stations, t0.fdelta, B, jc, mesh,
                                  len(freqs), host_loop=True)
    tt = lambda a, dt=None: torch.as_tensor(np.asarray(a)).to(
        dt or torch.float64)
    trun = tadmm.make_admm_runner(
        trp.split_sky(tsky_, torch.float64), tt(t0.sta1, torch.long),
        tt(t0.sta2, torch.long), tt(cidx, torch.long), cmask,
        t0.n_stations, t0.fdelta, B, tc, nf_total=len(freqs))
    targs = [tt(a) if i != 4 else np.asarray(a) for i, a in enumerate(arrs)]
    return jc, jrun, trun, targs


@pytest.fixture(scope="module")
def spread(problem):
    """The JAX runner's own spread per output (scalar rho): the largest
    relative move of each output when the data move one ulp up or
    down."""
    _, jrun, _, _ = _runners(problem, 2.0, False)
    a = [jnp.asarray(x) for x in problem[-1]]
    base = [np.asarray(o) for o in jrun(*a)]
    out = dict.fromkeys(NAMES, 0.0)
    x8F, wtF = problem[-1][0], problem[-1][5]
    out["data"] = float(max(np.linalg.norm(x * w) / x.size
                            for x, w in zip(x8F, wtF)))
    for sgn in (1.0, -1.0):
        moved = [np.asarray(o) for o in jrun(
            a[0] * (1.0 + sgn * 2.0 ** -52), *a[1:])]
        for name, x, y in zip(NAMES, base, moved):
            out[name] = max(out[name], _rel(y, x))
    return out


@pytest.mark.parametrize("case", ["scalar_rho", "rho_file_adaptive"])
def test_runner_matches_reference(problem, spread, case):
    """All eight outputs against the JAX host-loop runner."""
    rho = 2.0 if case == "scalar_rho" else np.array([1.5, 3.0])
    jc, jrun, trun, targs = _runners(problem, rho, case != "scalar_rho")
    want = [np.asarray(o) for o in jrun(*[jnp.asarray(a)
                                          for a in problem[-1]])]
    got = [o.cpu().numpy() for o in trun(*targs)]
    for name, g, w in zip(NAMES, got, want):
        _close(name, g, w, spread)
    assert np.all(got[4] < got[3])          # iteration 0 lowers res
    if case == "rho_file_adaptive":
        assert not np.allclose(got[2], np.broadcast_to(rho, got[2].shape))


def test_runner_from_reference_state(problem, spread):
    """The port's iterations k > 0 from the JAX runner's iteration-0
    carry (its ``iter0_post`` on the JAX solves) against the JAX
    iterations from the same carry (``local_solve_admm`` and
    ``body_post``): JF, Z, rhoF, r1s and duals."""
    sky, tsky_, dsky, freqs, tiles, cmask, cidx, B, arrs = problem
    jc, _, trun, targs = _runners(problem, 2.0, False)
    t0 = tiles[0]
    mesh = Mesh(np.array(jax.devices()[:1]), ("freq",))
    parts = cadmm.make_admm_runner(dsky, t0.sta1, t0.sta2, cidx, cmask,
                                   t0.n_stations, t0.fdelta, B, jc, mesh,
                                   len(freqs), _return_parts=True)
    x8F, uF, vF, wF, fr, wtF, fratioF, J0F = [jnp.asarray(a) for a in arrs]
    JF, res0, res1 = jax.jit(jax.vmap(parts["local_solve_plain"]))(
        x8F, uF, vF, wF, wtF, J0F, fr)
    carry, _, _, _ = parts["iter0_post"](JF, res0, res1, fratioF, ax=None)
    state = convert.admm_state_from_numpy([np.asarray(c) for c in carry])
    solve = jax.jit(jax.vmap(parts["local_solve_admm"]))
    Bj = jnp.asarray(B)
    r1s, duals = [], []
    for it in range(1, jc.n_admm):
        BZ = jnp.einsum("fp,mpknr->fmknr", Bj, carry[2])
        Jr, r0, r1 = solve(x8F, uF, vF, wF, wtF, carry[0], fr, carry[1],
                           BZ, carry[3])
        carry, (_, r1, dual) = parts["body_post"](Jr, r0, r1, carry, it,
                                                  ax=None)
        r1s.append(r1)
        duals.append(dual)
    want = [carry[0], carry[2], carry[3], jnp.stack(r1s), jnp.stack(duals)]
    got = [o.cpu().numpy() for o in trun.from_state(*targs[:6], state)]
    for name, g, w in zip(("JF", "Z", "rhoF", "r1s", "duals"), got, want):
        _close(name, g, w, spread)


def test_divergence_reset_matches_reference():
    rng = np.random.default_rng(4)
    JF = rng.normal(size=(5, 2, 1, 3, 8))
    J0F = rng.normal(size=(5, 2, 1, 3, 8))
    res0 = np.array([1.0, 1.0, 1.0, 1.0, 1.0])
    res1 = np.array([0.5, 6.0, np.nan, 0.0, 4.9])
    want = np.asarray(cadmm.divergence_reset(
        jnp.asarray(JF), jnp.asarray(J0F), jnp.asarray(res0),
        jnp.asarray(res1)))
    got, bad = tadmm.divergence_reset(JF, J0F, res0, res1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bad, [False, True, True, True, False])
