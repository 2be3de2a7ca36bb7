"""Port robust machinery (sagecal_tpu_torch/solvers/robust.py) against the
JAX reference in float64: the IRLS weights and the AECM statistic (rtol
1e-12), the nu grid and both nu updates (equal: an argmin over the grid),
and robust_lm_solve with and without ordered subsets (equal executed
iterations and PCG trips, equal nu, final cost rtol 1e-8, J atol 1e-6).
Each JAX solve runs once per module (the reference runs the Pallas sweep
in interpret mode).

The reference's nu functions are compared as its solvers run them: inside
a compiled program with constant bounds, where XLA evaluates the grid
nulow + k (nuhigh - nulow) / nd with the division folded into a
multiply, one ulp away from the eager value at some k."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import lm as lm_mod
from sagecal_tpu.solvers import robust as rb
from sagecal_tpu_torch.solvers import lm as tlm
from sagecal_tpu_torch.solvers import robust as trb

from test_torch_lm import _problem, _t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, shape=(40, 8)):
    rng = np.random.default_rng(seed)
    e = rng.standard_t(3, size=shape)
    mask = rng.random(shape) > 0.1
    return e, mask


@pytest.mark.parametrize("nu", [2.0, 7.5])
def test_weights_and_logsumw_match(nu):
    e, mask = _weights(1)
    w = np.asarray(rb.update_weights(jnp.asarray(e), nu))
    tw = trb.update_weights(torch.as_tensor(e), nu).numpy()
    np.testing.assert_allclose(tw, w, rtol=1e-12)
    np.testing.assert_allclose(
        float(trb.mean_logsumw(torch.as_tensor(np.array(w)),
                               torch.as_tensor(mask))),
        float(rb.mean_logsumw(jnp.asarray(w), jnp.asarray(mask))),
        rtol=1e-12)


@pytest.mark.parametrize("lo,hi", [(2.0, 30.0), (3.0, 20.0), (2.5, 27.0)])
def test_nu_grid_equal(lo, hi):
    want = np.asarray(jax.jit(lambda: rb.nu_grid(lo, hi))())
    np.testing.assert_array_equal(trb.nu_grid(lo, hi).numpy(), want)


NU_CASES = [(seed, nu0, lo, hi) for seed in (0, 1, 2, 3)
            for nu0, lo, hi in ((2.0, 2.0, 30.0), (9.0, 3.0, 20.0))]


@pytest.mark.parametrize("seed,nu0,lo,hi", NU_CASES)
def test_nu_updates_equal(seed, nu0, lo, hi):
    e, mask = _weights(seed)
    e = e * (0.5 + seed)
    w = rb.update_weights(jnp.asarray(e), nu0)
    tw = trb.update_weights(torch.as_tensor(e), nu0)
    ml = float(jax.jit(lambda a, m, n: rb.update_nu_ml(a, m, n, lo, hi))(
        w, jnp.asarray(mask), jnp.asarray(nu0)))
    tml = trb.update_nu_ml(tw, torch.as_tensor(mask),
                           torch.tensor(nu0, dtype=torch.float64), lo, hi)
    assert tml.dtype == torch.float64 and float(tml) == ml
    ls = rb.mean_logsumw(w, jnp.asarray(mask))
    tls = trb.mean_logsumw(tw, torch.as_tensor(mask))
    ae = float(jax.jit(lambda a, n: rb.update_nu_aecm(
        a, n, p=2, nulow=lo, nuhigh=hi))(ls, jnp.asarray(nu0)))
    tae = trb.update_nu_aecm(tls, torch.tensor(nu0, dtype=torch.float64),
                             p=2, nulow=lo, nuhigh=hi)
    assert float(tae) == ae


def _os_pair(T, nbase, randomize=False):
    ids, n = lm_mod.os_subset_ids(T, nbase)
    return (lm_mod.OSConfig(os_id=jnp.asarray(ids), n_subsets=n,
                            key=jax.random.PRNGKey(3), randomize=randomize),
            tlm.OSConfig(os_id=torch.as_tensor(ids), n_subsets=n,
                         randomize=randomize))


RLM_CASES = [(1, "chol", False), (2, "cg", False), (1, "chol", True),
             (2, "cg", True)]


@pytest.fixture(scope="module")
def rlm_runs():
    """(JAX, port) robust_lm_solve results per RLM_CASES entry."""
    out = {}
    for K, inner, use_os in RLM_CASES:
        N = 6
        x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=60 + K,
                                               noise=0.2)
        x8[::7] += 3.0                                   # outlier rows
        wt = np.ones((x8.shape[0], 8))
        J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
        jos, tos = _os_pair(4, nbase) if use_os else (None, None)
        Jr, nu, info = rb.robust_lm_solve(
            *(jnp.asarray(a) for a in (x8, coh[0], s1, s2, cid, wt, J0)), N,
            row_period=nbase, os=jos,
            config=lm_mod.LMConfig(itmax=6, kernel="pallas", inner=inner))
        Jt, tnu, tinfo = trb.robust_lm_solve(
            _t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
            _t(cid).long(), _t(wt), _t(J0), N, row_period=nbase, os=tos,
            config=tlm.LMConfig(itmax=6, inner=inner))
        out[(K, inner, use_os)] = ((Jr, nu, info), (Jt, tnu, tinfo))
    return out


#: robust LM under --jones diag|phase: (mode, K, inner, OS)
RLM_MODE_CASES = [("diag", 2, "cg", False), ("phase", 1, "chol", True)]


@pytest.mark.parametrize("jones,K,inner,use_os", RLM_MODE_CASES)
def test_robust_lm_modes_match_reference(jones, K, inner, use_os):
    """Robust LM in the diag and phase modes, from a start whose
    off-diagonals are not zero: nu equal, the same iterations and PCG
    trips, the costs and J at the plain gates, J constrained."""
    from test_torch_lm import _mode_start
    N = 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=80 + K, noise=0.2)
    x8[::7] += 3.0                                       # outlier rows
    wt = np.ones((x8.shape[0], 8))
    J0 = _mode_start(K, N, 80 + K)
    jos, tos = _os_pair(4, nbase) if use_os else (None, None)
    Jr, nu, info = rb.robust_lm_solve(
        *(jnp.asarray(a) for a in (x8, coh[0], s1, s2, cid, wt, J0)), N,
        row_period=nbase, os=jos,
        config=lm_mod.LMConfig(itmax=6, kernel="pallas", inner=inner,
                               jones_mode=jones))
    Jt, tnu, tinfo = trb.robust_lm_solve(
        _t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(), _t(cid).long(),
        _t(wt), _t(J0), N, row_period=nbase, os=tos,
        config=tlm.LMConfig(itmax=6, inner=inner, jones_mode=jones))
    assert float(tnu) == float(nu) and float(nu) != 2.0
    assert tinfo["iters"] == int(info["iters"])
    assert tinfo["cg_iters"] == int(info["cg_iters"])
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jr), atol=1e-6)
    assert not Jt[..., 0, 1].any() and not Jt[..., 1, 0].any()


@pytest.mark.parametrize("K,inner,use_os", RLM_CASES)
def test_robust_lm_solve_matches_reference(rlm_runs, K, inner, use_os):
    (Jr, nu, info), (Jt, tnu, tinfo) = rlm_runs[(K, inner, use_os)]
    assert float(tnu) == float(nu) and float(nu) != 2.0
    assert tinfo["iters"] == int(info["iters"])
    assert tinfo["cg_iters"] == int(info["cg_iters"])
    assert (tinfo["cg_iters"] > 0) == (inner == "cg")
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jr), atol=1e-6)
