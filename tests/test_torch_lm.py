"""Port LM solver and LBFGS refine (sagecal_tpu_torch/solvers) against
the JAX reference in float64: lm_solve on the fused-sweep route, with the
block-Cholesky or the PCG inner solver and with ordered subsets, must
land on the reference's final cost (rtol 1e-8, J atol 1e-6) after the
same number of executed iterations and PCG trips, and the joint refine
must reach the same residual (the same maths; only summation order
differs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import lm as lm_mod
from sagecal_tpu.solvers import sage
from sagecal_tpu_torch.solvers import lbfgs as tlbfgs
from sagecal_tpu_torch.solvers import lm as tlm
from sagecal_tpu_torch.solvers import sage as tsage


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(N=6, T=4, K=1, M=1, seed=0, noise=0.05):
    """Rows [T, nbase] of M clusters, K hybrid chunks each."""
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nbase = len(p)
    sta1 = np.tile(p, T).astype(np.int32)
    sta2 = np.tile(q, T).astype(np.int32)
    B = nbase * T
    cid = ((np.arange(B) // nbase) * K // T).astype(np.int32)
    coh = rng.normal(size=(M, B, 2, 2)) + 1j * rng.normal(size=(M, B, 2, 2))
    Jt = (rng.normal(size=(M, K, N, 2, 2))
          + 1j * rng.normal(size=(M, K, N, 2, 2))) * 0.3 + np.eye(2)
    V = sum(Jt[m][cid, sta1] @ coh[m]
            @ np.conj(Jt[m][cid, sta2].transpose(0, 2, 1)) for m in range(M))
    V = V + noise * (rng.normal(size=V.shape) + 1j * rng.normal(size=V.shape))
    x8 = np.stack([V.reshape(B, 4).real, V.reshape(B, 4).imag],
                  -1).reshape(B, 8)
    return x8, coh, sta1, sta2, cid, nbase


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("K,itmax", [(1, 12), (2, 12), (1, 3)])
def test_lm_solve_matches_reference(K, itmax):
    N = 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=11 + K)
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    Jr, info = lm_mod.lm_solve(
        jnp.asarray(x8), jnp.asarray(coh[0]), jnp.asarray(s1),
        jnp.asarray(s2), jnp.asarray(cid), jnp.asarray(wt), jnp.asarray(J0),
        N, row_period=nbase,
        config=lm_mod.LMConfig(itmax=itmax, kernel="pallas"))
    Jp, tinfo = tlm.lm_solve(
        _t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(), _t(cid).long(),
        _t(wt), _t(J0), N, row_period=nbase,
        config=tlm.LMConfig(itmax=itmax))
    assert tinfo["iters"] == int(info["iters"])
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jr), atol=1e-6)


def test_lm_solve_dynamic_cap_and_mask():
    """A dead chunk (chunk_mask False) keeps J0; itmax_dynamic caps."""
    N, K = 6, 2
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=21)
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    mask = np.array([True, False])
    Jr, info = lm_mod.lm_solve(
        jnp.asarray(x8), jnp.asarray(coh[0]), jnp.asarray(s1),
        jnp.asarray(s2), jnp.asarray(cid), jnp.asarray(wt), jnp.asarray(J0),
        N, chunk_mask=jnp.asarray(mask), row_period=nbase,
        itmax_dynamic=jnp.asarray(4),
        config=lm_mod.LMConfig(itmax=10, kernel="pallas"))
    Jp, tinfo = tlm.lm_solve(
        _t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(), _t(cid).long(),
        _t(wt), _t(J0), N, chunk_mask=_t(mask), row_period=nbase,
        itmax_dynamic=4, config=tlm.LMConfig(itmax=10))
    assert tinfo["iters"] == int(info["iters"]) == 4
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_array_equal(Jp.numpy()[1], J0[1])


@pytest.mark.parametrize("M,K", [(2, 1), (2, 2)])
def test_refine_matches_reference(M, K):
    N = 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, M=M, seed=31 + K)
    cidx = np.stack([cid] * M)
    wt = np.ones((x8.shape[0], 8))
    rng = np.random.default_rng(3)
    J = (np.tile(np.eye(2, dtype=complex), (M, K, N, 1, 1))
         + 0.05 * rng.normal(size=(M, K, N, 2, 2)))
    cfg = sage.SageConfig(max_lbfgs=5, lbfgs_m=4)
    Jr, res, k = sage._jit_refine(
        jnp.asarray(x8), jnp.asarray(coh), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(cidx), jnp.asarray(J), jnp.asarray(wt),
        jnp.asarray(2.0), N, cfg, False)
    tcfg = tsage.SageConfig(max_lbfgs=5, lbfgs_m=4)
    Jt, tres, tk = tsage.refine(
        _t(x8), _t(coh), _t(s1).long(), _t(s2).long(), _t(cidx).long(),
        _t(J), _t(wt), N, tcfg)
    assert tk == int(k)
    np.testing.assert_allclose(float(tres), float(res), rtol=1e-8)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jr), atol=1e-6)


@pytest.mark.parametrize("linesearch", ["fletcher", "backtrack"])
def test_lbfgs_quadratic_matches_reference(linesearch):
    """The LBFGS core on a convex quadratic: both packages reach the
    same point after the same iterations, under either line search."""
    from sagecal_tpu.solvers import lbfgs as lbfgs_mod
    rng = np.random.default_rng(0)
    A = rng.normal(size=(8, 8))
    H = A @ A.T + 8 * np.eye(8)
    b = rng.normal(size=8)
    Hj, bj = jnp.asarray(H), jnp.asarray(b)
    Ht, bt = torch.as_tensor(H), torch.as_tensor(b)
    xr, kr = lbfgs_mod.lbfgs_fit(lambda x: 0.5 * x @ Hj @ x - bj @ x,
                                 lambda x: Hj @ x - bj, jnp.zeros(8),
                                 itmax=6, M=3, linesearch=linesearch,
                                 return_iters=True)
    xt, kt = tlbfgs.lbfgs_fit(lambda x: 0.5 * x @ Ht @ x - bt @ x,
                              lambda x: Ht @ x - bt,
                              torch.zeros(8, dtype=torch.float64),
                              itmax=6, M=3, linesearch=linesearch,
                              return_iters=True)
    assert kt == int(kr)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=1e-9,
                               atol=1e-12)


def _mode_start(K, N, seed):
    """A start near the identity whose off-diagonals are not zero (a
    constrained solve drops them; phase keeps the diagonal amplitudes)."""
    rng = np.random.default_rng(seed)
    return np.eye(2) + 0.1 * (rng.normal(size=(K, N, 2, 2))
                              + 1j * rng.normal(size=(K, N, 2, 2)))


def _solve_pair(K, seed, itmax, inner, os_k=None, wt=None, jones="full",
                kernel="pallas"):
    """(JAX, port) lm_solve results on one problem; ``os_k`` > 0 turns on
    ordered subsets of the 4 timeslots, rotating (randomize off);
    ``jones`` a constrained Jones mode (from :func:`_mode_start`) and
    ``kernel`` the assembly route."""
    N = 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=seed, noise=0.1)
    wt = np.ones((x8.shape[0], 8)) if wt is None else wt
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1)) if jones == "full" \
        else _mode_start(K, N, seed)
    jos = tos = None
    if os_k:
        ids, n = lm_mod.os_subset_ids(4, nbase)
        jos = lm_mod.OSConfig(os_id=jnp.asarray(ids), n_subsets=n,
                              key=jax.random.PRNGKey(0), randomize=False)
        tos = tlm.OSConfig(os_id=_t(ids), n_subsets=n, randomize=False)
    ref = lm_mod.lm_solve(
        *(jnp.asarray(a) for a in (x8, coh[0], s1, s2, cid, wt, J0)), N,
        row_period=nbase, os=jos,
        config=lm_mod.LMConfig(itmax=itmax, kernel=kernel, inner=inner,
                               jones_mode=jones))
    got = tlm.lm_solve(
        _t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(), _t(cid).long(),
        _t(wt), _t(J0), N, row_period=nbase, os=tos,
        config=tlm.LMConfig(itmax=itmax, inner=inner, kernel=kernel,
                            jones_mode=jones))
    return ref, got


CG_OS_CASES = [(2, "cg", False), (1, "chol", True), (2, "cg", True)]


@pytest.mark.parametrize("K,inner,use_os", CG_OS_CASES)
def test_lm_cg_and_os_match_reference(K, inner, use_os):
    (Jr, info), (Jp, tinfo) = _solve_pair(K, 90 + K, 10, inner,
                                          os_k=use_os)
    assert tinfo["iters"] == int(info["iters"])
    assert tinfo["cg_iters"] == int(info["cg_iters"])
    assert (tinfo["cg_iters"] > 0) == (inner == "cg")
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jr), atol=1e-6)


#: (mode, solver): LM (block Cholesky) and PCG at K = 2 on the fused
#: sweep, OS-LM at K = 1 (the 2-chunk OS chaos of the test below), and LM
#: on the XLA assembly
MODE_SOLVES = [(jones, solver) for jones in ("diag", "phase")
               for solver in ("lm", "os", "pcg", "xla")]


@pytest.mark.parametrize("jones,solver", MODE_SOLVES)
def test_lm_modes_match_reference(jones, solver):
    """--jones diag|phase: LM, OS-LM and PCG on the fused sweep, and LM on
    the XLA assembly, against the reference from a start whose
    off-diagonals are not zero: the same iterations and PCG trips, the
    costs and J at the plain gates, and J constrained (off-diagonals
    exactly 0)."""
    K = 1 if solver == "os" else 2
    (Jr, info), (Jp, tinfo) = _solve_pair(
        K, 110 + K + len(solver), 10, "cg" if solver == "pcg" else "chol",
        os_k=solver == "os", jones=jones,
        kernel="xla" if solver == "xla" else "pallas")
    assert tinfo["iters"] == int(info["iters"]) > 1
    assert tinfo["cg_iters"] == int(info["cg_iters"])
    assert (tinfo["cg_iters"] > 0) == (solver == "pcg")
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jr), atol=1e-6)
    assert not Jp[..., 0, 1].any() and not Jp[..., 1, 0].any()
    assert float(tinfo["final_cost"].sum()) < float(tinfo["init_cost"].sum())


def test_lm_os_chol_two_chunks_within_reference_spread():
    """OS-LM under Cholesky with K = 2, whose first subset (timeslot 0)
    holds no row of chunk 1: the reference seeds that chunk's damping at
    mu0 = 1e-33 and float64 roundoff grows ~1e9-fold. The witness: the
    reference against itself on the data moved by one ulp (3 seeded
    draws) moves J by more than 1e-7 (measured 8.2e-7) and the cost by
    ~4e-9. The port takes the same iterations and lands within
    max(plain gate, 10 x that spread) (measured 1.2e-6 in J, 1.4e-8 in
    the cost)."""
    N, K = 6, 2
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=93, noise=0.1)
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    ids, n = lm_mod.os_subset_ids(4, nbase)
    jos = lm_mod.OSConfig(os_id=jnp.asarray(ids), n_subsets=n,
                          key=jax.random.PRNGKey(0), randomize=False)

    def jax_run(x):
        J, info = lm_mod.lm_solve(
            *(jnp.asarray(a) for a in (x, coh[0], s1, s2, cid, wt, J0)), N,
            row_period=nbase, os=jos,
            config=lm_mod.LMConfig(itmax=10, kernel="pallas", inner="chol"))
        return np.asarray(J), np.asarray(info["final_cost"]), info

    Jr, cr, info = jax_run(x8)
    rng = np.random.default_rng(0)
    pert = [jax_run(x8 * (1.0 + 2.0 ** -52 * rng.choice([-1.0, 1.0],
                                                        x8.shape)))
            for _ in range(3)]
    s_J = max(float(np.abs(Jq - Jr).max()) for Jq, _, _ in pert)
    s_c = max(float(np.abs(cq / cr - 1.0).max()) for _, cq, _ in pert)
    assert 1e-7 < s_J < 1e-4 and s_c < 1e-6
    Jp, tinfo = tlm.lm_solve(
        _t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(), _t(cid).long(),
        _t(wt), _t(J0), N, row_period=nbase,
        os=tlm.OSConfig(os_id=_t(ids), n_subsets=n, randomize=False),
        config=tlm.LMConfig(itmax=10, inner="chol"))
    assert tinfo["iters"] == int(info["iters"])
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(), cr,
                               rtol=max(1e-8, 10 * s_c))
    np.testing.assert_allclose(Jp.numpy(), Jr, atol=max(1e-6, 10 * s_J))


@pytest.mark.parametrize("K", [2])
def test_solve_damped_cg_matches_reference(K):
    """One PCG solve on the Gram blocks: same trips, same step (rtol
    1e-10 of its largest element), a masked-out chunk returns 0."""
    from sagecal_tpu.ops import sweep_pallas as swp
    from sagecal_tpu_torch.ops import sweep as tswp
    N = 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=95, noise=0.2)
    wt = np.ones((x8.shape[0], 8))
    J = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    args = (x8, J, coh[0], s1, s2, cid, wt)
    fac, JTe, _ = swp.gn_blocks(*(jnp.asarray(a) for a in args), N, K, nbase,
                                interpret=True)
    tfac, tJTe, _ = tswp.gn_blocks(*(_t(a) for a in args), N, K, nbase)
    mu = np.linspace(0.05, 0.2, K)
    active = np.array([True, False][:K]) if K > 1 else None
    dp, ok, k = lm_mod._solve_damped_cg(
        fac, JTe, jnp.asarray(mu), 1e-9, 0.0, jnp.asarray(s1),
        jnp.asarray(s2), jnp.asarray(cid), K, N, nbase, 0.05, 25,
        active=None if active is None else jnp.asarray(active))
    tdp, tok, tk = tlm._solve_damped_cg(
        tfac, tJTe, _t(mu), 1e-9, 0.0, _t(s1).long(), _t(s2).long(), N,
        0.05, 25, active=None if active is None else _t(active))
    assert tk == int(k) > 1 and tok.tolist() == np.asarray(ok).tolist()
    want = np.asarray(dp)
    np.testing.assert_allclose(tdp.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    if K > 1:
        assert not tdp[1].any()


def test_os_subset_ids_and_draws():
    """Subset ids equal the reference's; randomized draws are a fixed
    function of (seed, iteration), in range, and cover the subsets."""
    for T, nb in ((4, 15), (120, 1891), (25, 3)):
        ids, n = lm_mod.os_subset_ids(T, nb)
        tids, tn = tlm.os_subset_ids(T, nb)
        np.testing.assert_array_equal(tids, np.asarray(ids))
        assert tn == n
    os = tlm.OSConfig(os_id=torch.zeros(4), n_subsets=10, seed=123)
    draws = [os.subset(k) for k in range(200)]
    assert draws == [os.subset(k) for k in range(200)]
    assert set(draws) == set(range(10))
    assert [os._replace(randomize=False).subset(k) for k in range(12)] == [
        k % 10 for k in range(12)]
    assert tlm.fold_in(5, 1) != tlm.fold_in(5, 2) != tlm.fold_in(6, 1)


@pytest.mark.parametrize("inner,kernel,jones", [("cg", "xla", "full"),
                                                ("chol", "xla", "full"),
                                                ("chol", "pallas", "diag")])
def test_unported_routes_raise(inner, kernel, jones):
    """Every route runs: the XLA assembly (--kernel xla, both inner
    solvers, counted in XLA_SOLVES) and --jones diag on either assembly
    (J constrained, the cost falls); a Jones mode the JAX package does
    not have raises."""
    x8, coh, s1, s2, cid, nbase = _problem()

    def solve(jones_mode):
        return tlm.lm_solve(
            _t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
            _t(cid).long(), _t(np.ones((x8.shape[0], 8))),
            _t(np.tile(np.eye(2, dtype=complex), (1, 6, 1, 1))), 6,
            row_period=nbase,
            config=tlm.LMConfig(inner=inner, kernel=kernel,
                                jones_mode=jones_mode))
    for mode in dict.fromkeys((jones, "diag")):
        n0 = tlm.XLA_SOLVES
        J, info = solve(mode)
        assert tlm.XLA_SOLVES == n0 + (kernel == "xla")
        assert torch.isfinite(J).all()
        assert float(info["final_cost"].sum()) < float(
            info["init_cost"].sum())
        if mode == "diag":
            assert not J[..., 0, 1].any() and not J[..., 1, 0].any()
    with pytest.raises(ValueError, match="jones_mode"):
        solve("polar")
