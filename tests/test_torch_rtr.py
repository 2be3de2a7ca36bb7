"""Port RTR/NSD solvers (sagecal_tpu_torch/solvers/rtr.py) against the JAX
reference in float64: the horizontal projection and the station
preconditioner (rtol 1e-10), the robust cost, and rtr_solve (tCG
operator dense and matrix-free), rtr_solve_robust and nsd_solve_robust
at N = 6, T = 4, K in {1, 2}: equal executed iterations and nu, final
cost rtol 1e-8, J atol 1e-6. Each JAX solve runs once per module (the
reference runs the Pallas sweep in interpret mode)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import rtr as rtr_mod
from sagecal_tpu_torch.solvers import rtr as trtr

from test_torch_lm import _problem, _t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("K", [1, 2])
def test_project_tangent_matches_reference(K):
    N = 6
    rng = np.random.default_rng(K)
    p = rng.normal(size=(K, 8 * N))
    v = rng.normal(size=(K, 8 * N))
    want = rtr_mod.project_tangent(jnp.asarray(p), jnp.asarray(v), K, N)
    got = trtr.project_tangent(torch.as_tensor(p), torch.as_tensor(v), K, N)
    _close(got.numpy(), want)
    # horizontal: projecting twice changes nothing
    _close(trtr.project_tangent(torch.as_tensor(p), got, K, N).numpy(),
           got.numpy())


@pytest.mark.parametrize("K", [1, 2])
def test_station_precond_matches_reference(K):
    x8, coh, s1, s2, cid, nbase = _problem(N=6, K=K, seed=3)
    wt = np.ones((x8.shape[0], 8))
    wt[:nbase // 2] = 0.0                 # a few dead rows
    want = rtr_mod.station_precond(jnp.asarray(wt), jnp.asarray(s1),
                                   jnp.asarray(s2), jnp.asarray(cid), K, 6)
    got = trtr.station_precond(_t(wt), _t(s1), _t(s2), _t(cid), K, 6)
    _close(got.numpy(), want)


@pytest.mark.parametrize("nu", [None, 3.5])
def test_make_cost_matches_reference(nu):
    K, N = 2, 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=4, noise=0.3)
    wt = np.random.default_rng(1).random((x8.shape[0], 8))
    p = np.random.default_rng(2).normal(size=(K, 8 * N))
    want = rtr_mod.make_cost(
        *(jnp.asarray(a) for a in (x8, coh[0], s1, s2, cid, wt)), K, N,
        robust_nu=nu)(jnp.asarray(p))
    got = trtr.make_cost(_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
                         _t(cid).long(), _t(wt), K, N,
                         robust_nu=nu)(torch.as_tensor(p))
    _close(got.numpy(), want)


#: (solver, K, inner): rtr = rtr_solve, robust = rtr_solve_robust
CASES = [("rtr", 1, "chol"), ("rtr", 2, "cg"), ("robust", 2, "chol"),
         ("robust", 1, "cg"), ("nsd", 1, None), ("nsd", 2, None)]


def _run(solver, K, inner):
    N = 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=70 + K, noise=0.2)
    if solver != "rtr":
        x8[::5] += 2.0                                   # outlier rows
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    jargs = [jnp.asarray(a) for a in (x8, coh[0], s1, s2, cid, wt, J0)]
    targs = [_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
             _t(cid).long(), _t(wt), _t(J0)]
    if solver == "nsd":
        ref = rtr_mod.nsd_solve_robust(*jargs, N,
                                       config=rtr_mod.NSDConfig(itmax=6),
                                       itmax_dynamic=4 + K)
        got = trtr.nsd_solve_robust(*targs, N, config=trtr.NSDConfig(itmax=6),
                                    itmax_dynamic=4 + K)
        return ref, got
    cfg = rtr_mod.RTRConfig(itmax=6, kernel="pallas", inner=inner)
    tcfg = trtr.RTRConfig(itmax=6, inner=inner)
    if solver == "rtr":
        J, info = rtr_mod.rtr_solve(*jargs, N, row_period=nbase, config=cfg)
        tJ, tinfo = trtr.rtr_solve(*targs, N, row_period=nbase, config=tcfg)
        return (J, None, info), (tJ, None, tinfo)
    return (rtr_mod.rtr_solve_robust(*jargs, N, row_period=nbase,
                                     config=cfg),
            trtr.rtr_solve_robust(*targs, N, row_period=nbase, config=tcfg))


@pytest.fixture(scope="module")
def rtr_runs():
    return {case: _run(*case) for case in CASES}


@pytest.mark.parametrize("solver,K,inner", CASES)
def test_solver_matches_reference(rtr_runs, solver, K, inner):
    (J, nu, info), (tJ, tnu, tinfo) = rtr_runs[(solver, K, inner)]
    if nu is not None:
        assert float(tnu) == float(nu) and float(nu) != 2.0
    assert tinfo["iters"] == int(info["iters"])
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(J), atol=1e-6)
    if solver != "nsd":
        assert tinfo["tcg_iters"] > 0


def test_unported_routes_raise():
    x8, coh, s1, s2, cid, nbase = _problem()
    args = [_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
            _t(cid).long(), _t(np.ones((x8.shape[0], 8))),
            _t(np.tile(np.eye(2, dtype=complex), (1, 6, 1, 1))), 6]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trtr.rtr_solve(*args, row_period=nbase,
                       config=trtr.RTRConfig(jones_mode="phase"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trtr.rtr_solve(*args, row_period=nbase,
                       config=trtr.RTRConfig(kernel="xla"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trtr.nsd_solve_robust(*args, config=trtr.NSDConfig(jones_mode="diag"))
