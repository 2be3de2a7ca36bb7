"""Port solvers with the consensus-ADMM augmentation against the JAX
package in float64, continued from ``test_torch_admm_solvers.py``: LM,
robust LM, RTR and robust RTR on the XLA assembly under ``--inner chol``
and ``cg``, NSD, two hybrid chunks on the XLA route, and the SAGE loop
(``sage.sagefit_host(..., admm=)`` against the JAX package's traced
``sage.sagefit``, the call of its ADMM runner) sequentially and in
in-flight groups. Final costs within rtol 1e-8, J within rtol 1e-8 of
max|J|, the executed iterations equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.config import SolverMode
from sagecal_tpu.solvers import sage
from sagecal_tpu_torch.solvers import sage as tsage

from test_torch_admm_solvers import (RTOL, SOLVERS, _close, _problem,
                                     _solve_both, _t)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUTES = [(s, "xla", i) for s in SOLVERS for i in ("chol", "cg")] \
    + [("nsd", "xla", "chol")]


@pytest.mark.parametrize("solver,kernel,inner", ROUTES)
def test_admm_solver_xla_matches_reference(solver, kernel, inner):
    """Every solver with the ADMM term on the XLA assembly (NSD has one
    route): the augmented final cost within rtol 1e-8, J within 1e-8 of
    max|J|, the executed iterations equal."""
    Jr, info, Jp, tinfo = _solve_both(solver, kernel, inner)
    assert int(np.sum(tinfo["iters"])) == int(np.sum(info["iters"]))
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=RTOL)
    _close(Jp.numpy(), Jr)


def test_admm_two_chunks_xla_match_reference():
    """Two hybrid chunks of robust RTR under --inner cg on the XLA route,
    each chunk with its own slice of y and bz."""
    Jr, info, Jp, tinfo = _solve_both("robust_rtr", "xla", "cg", K=2, seed=5)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=RTOL)
    _close(Jp.numpy(), Jr)


SAGE_CASES = [(int(SolverMode.LM_LBFGS), "pallas", "chol", 1, 2),
              (int(SolverMode.RLM_RLBFGS), "xla", "cg", 1, 2),
              (int(SolverMode.RTR_OSRLM_RLBFGS), "pallas", "cg", 1, 2),
              (int(SolverMode.LM_LBFGS), "xla", "chol", 2, 8)]


@pytest.mark.parametrize("mode,kernel,inner,inflight,M", SAGE_CASES)
def test_sagefit_admm_matches_traced_reference(mode, kernel, inner,
                                               inflight, M):
    """``sagefit_host(..., admm=)`` against the JAX traced ``sagefit``
    with the same (Y, BZ, rho) at -R 0: no refine under ADMM (lbfgs_iters
    0), res_0/res_1 within 1e-8 and J within 1e-8 of max|J|; the last
    case in-flight groups of 2 over 8 clusters."""
    N, K = 6, 1
    x8, coh, s1, s2, cid, nbase, Y, BZ, rho = _problem(N=N, K=K, M=M,
                                                       seed=41 + M)
    cidx = np.stack([cid] * M)
    cmask = np.ones((M, K), bool)
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (M, K, N, 1, 1))
    cfg = sage.SageConfig(max_emiter=2, max_iter=5, max_lbfgs=4,
                          solver_mode=mode, randomize=False, kernel=kernel,
                          inner=inner, nbase=nbase, inflight=inflight,
                          inflight_warm=True)
    Jr, info = sage.sagefit(
        jnp.asarray(x8), jnp.asarray(coh), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(cidx), jnp.asarray(cmask), jnp.asarray(J0), N,
        jnp.asarray(wt), config=cfg,
        admm=(jnp.asarray(Y), jnp.asarray(BZ), jnp.asarray(rho)))
    tcfg = tsage.SageConfig(max_emiter=2, max_iter=5, max_lbfgs=4,
                            solver_mode=mode, randomize=False, kernel=kernel,
                            inner=inner, nbase=nbase, inflight=inflight,
                            inflight_warm=True)
    Jp, tinfo = tsage.sagefit_host(
        _t(x8), _t(coh), _t(s1), _t(s2), _t(cidx), _t(cmask), _t(J0), N,
        _t(wt), config=tcfg, admm=(_t(Y), _t(BZ), _t(rho)))
    assert tinfo["lbfgs_iters"] == int(info["lbfgs_iters"]) == 0
    np.testing.assert_allclose(float(tinfo["res_0"]), float(info["res_0"]),
                               rtol=1e-10)
    np.testing.assert_allclose(tinfo["res_1"], float(info["res_1"]),
                               rtol=RTOL)
    _close(Jp.numpy(), Jr)
    if inflight > 1:
        assert tinfo["groups"], "no group was visited"
