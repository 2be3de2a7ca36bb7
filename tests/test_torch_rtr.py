"""Port RTR/NSD solvers (sagecal_tpu_torch/solvers/rtr.py) against the JAX
reference in float64: the horizontal projection and the station
preconditioner (rtol 1e-10), the robust cost, and rtr_solve (tCG
operator dense and matrix-free), rtr_solve_robust and nsd_solve_robust
at N = 6, T = 4, K in {1, 2}: equal executed iterations and nu, final
cost rtol 1e-8, J atol 1e-6. Each JAX solve runs once per module (the
reference runs the Pallas sweep in interpret mode). Last, a witness of
the robust RTR card test's inputs (tests/test_torch_card.py): under
one-ulp perturbations of the data, float64 roundoff splits the
trajectory on its former random-coherency input in both packages, and
not on its point-source input."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import rtr as rtr_mod
from sagecal_tpu_torch.solvers import rtr as trtr

from test_torch_card import robust_rtr_problem
from test_torch_lm import _mode_start, _problem, _t


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


#: (solver, K, inner): rtr = rtr_solve, robust = rtr_solve_robust; an
#: ``_xla`` suffix runs both packages on the XLA assembly (--kernel xla:
#: the dense normal_equations under chol, gn_factors + gn_matvec under cg)
CASES = [("rtr", 1, "chol"), ("rtr", 2, "cg"), ("robust", 2, "chol"),
         ("robust", 1, "cg"), ("nsd", 1, None), ("nsd", 2, None),
         ("rtr_xla", 1, "chol"), ("rtr_xla", 2, "cg"),
         ("robust_xla", 2, "chol"), ("robust_xla", 1, "cg")]


def _run(solver, K, inner, jones="full"):
    kernel = "xla" if solver.endswith("_xla") else "pallas"
    solver = solver.replace("_xla", "")
    N = 6
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, seed=70 + K, noise=0.2)
    if solver != "rtr":
        x8[::5] += 2.0                                   # outlier rows
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1)) if jones == "full" \
        else _mode_start(K, N, 70 + K)
    jargs = [jnp.asarray(a) for a in (x8, coh[0], s1, s2, cid, wt, J0)]
    targs = [_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
             _t(cid).long(), _t(wt), _t(J0)]
    if solver == "nsd":
        ref = rtr_mod.nsd_solve_robust(
            *jargs, N, config=rtr_mod.NSDConfig(itmax=6, jones_mode=jones),
            itmax_dynamic=4 + K)
        got = trtr.nsd_solve_robust(
            *targs, N, config=trtr.NSDConfig(itmax=6, jones_mode=jones),
            itmax_dynamic=4 + K)
        return ref, got
    cfg = rtr_mod.RTRConfig(itmax=6, kernel=kernel, inner=inner,
                            jones_mode=jones)
    tcfg = trtr.RTRConfig(itmax=6, inner=inner, kernel=kernel,
                          jones_mode=jones)
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


#: (solver, K, inner) of the constrained-mode runs, for each of diag and
#: phase: RTR and robust RTR on both routes, and NSD
MODE_CASES = [("rtr", 2, "cg"), ("rtr_xla", 1, "chol"), ("robust", 1, "chol"),
              ("robust_xla", 2, "cg"), ("nsd", 2, None)]


@pytest.fixture(scope="module")
def rtr_mode_runs():
    return {(jones,) + case: _run(*case, jones=jones)
            for jones in ("diag", "phase") for case in MODE_CASES}


@pytest.mark.parametrize("jones", ["diag", "phase"])
@pytest.mark.parametrize("solver,K,inner", MODE_CASES)
def test_solver_modes_match_reference(rtr_mode_runs, jones, solver, K,
                                      inner):
    """RTR, robust RTR (fused sweep and XLA assembly) and NSD under
    --jones diag|phase from a start whose off-diagonals are not zero:
    equal iterations and nu, costs and J at the plain gates, J
    constrained."""
    (J, nu, info), (tJ, tnu, tinfo) = rtr_mode_runs[(jones, solver, K,
                                                     inner)]
    if nu is not None:
        assert float(tnu) == float(nu) and float(nu) != 2.0
    assert tinfo["iters"] == int(info["iters"])
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=1e-8)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(J), atol=1e-6)
    assert not tJ[..., 0, 1].any() and not tJ[..., 1, 0].any()
    if solver != "nsd":
        assert tinfo["tcg_iters"] > 0


def test_unported_routes_raise():
    """--jones phase and diag run on both assemblies and in NSD (J
    constrained; the parity runs above hold them against the reference);
    a Jones mode the JAX package does not have raises."""
    x8, coh, s1, s2, cid, nbase = _problem()
    args = [_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
            _t(cid).long(), _t(np.ones((x8.shape[0], 8))),
            _t(np.tile(np.eye(2, dtype=complex), (1, 6, 1, 1))), 6]
    for kernel in ("pallas", "xla"):
        J, info = trtr.rtr_solve(*args, row_period=nbase,
                                 config=trtr.RTRConfig(kernel=kernel,
                                                       jones_mode="phase"))
        assert not J[..., 0, 1].any() and not J[..., 1, 0].any()
        assert float(info["final_cost"].sum()) < float(
            info["init_cost"].sum())
    J, _, _ = trtr.nsd_solve_robust(*args,
                                    config=trtr.NSDConfig(jones_mode="diag"))
    assert not J[..., 0, 1].any() and torch.isfinite(J).all()
    with pytest.raises(ValueError, match="jones_mode"):
        trtr.rtr_solve(*args, row_period=nbase,
                       config=trtr.RTRConfig(jones_mode="polar"))


#: seeds of the one-ulp relative perturbations of x8 in the witness
ULP_SEEDS = range(100, 108)


def _robust_cg_both(x8, coh, sa, sb, cid, J0, N, nb):
    """(JAX, port) final cost [K] and J of one float64 robust RTR solve
    with the card test's settings (itmax 6, ``--inner cg``); the JAX
    reference on its default (XLA) assembly."""
    wt = np.ones((x8.shape[0], 8))
    j = jnp.asarray
    J, _, info = rtr_mod.rtr_solve_robust(
        j(x8), j(coh), j(sa.astype(np.int32)), j(sb.astype(np.int32)),
        j(cid.astype(np.int32)), j(wt), j(J0), N, row_period=nb,
        config=rtr_mod.RTRConfig(itmax=6, inner="cg"))
    tJ, _, tinfo = trtr.rtr_solve_robust(
        _t(x8), _t(coh), _t(sa).long(), _t(sb).long(), _t(cid).long(),
        _t(wt), _t(J0), N, row_period=nb,
        config=trtr.RTRConfig(itmax=6, inner="cg"))
    return ((np.asarray(info["final_cost"]), np.asarray(J)),
            (tinfo["final_cost"].numpy(), tJ.numpy()))


def _ulp_draws(point):
    """Both packages' solves of the card test's input, unperturbed and
    under each of ULP_SEEDS' one-ulp (2^-52) relative perturbations of
    x8, with each package's relative move of the final cost from its own
    unperturbed solve."""
    x8, *rest = robust_rtr_problem(point)
    base = _robust_cg_both(x8, *rest)
    draws = []
    for seed in ULP_SEEDS:
        sign = np.random.default_rng(seed).choice([-1.0, 1.0], x8.shape)
        both = _robust_cg_both(x8 * (1.0 + sign * 2.0 ** -52), *rest)
        moved = [float(np.abs(c - b[0]).max() / np.abs(b[0]).max())
                 for (c, _), b in zip(both, base)]
        draws.append((both, moved))
    return base, draws


def _agree(ref, got):
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-8)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)


def test_card_rtr_random_input_is_roundoff_chaotic():
    """The card test's former input (random coherencies): the packages
    agree unperturbed, and in each package a one-ulp perturbation of x8
    moves the float64 final cost by more than 1e-3 in at least one of
    the draws. Which draws split depends on the summation order, so the
    packages agree draw by draw only where neither split (moved <=
    1e-6). A card (float32) run cannot meet a 1e-3 gate that float64 on
    the CPU does not meet."""
    base, draws = _ulp_draws(point=False)
    _agree(*base)
    assert max(m[0] for _, m in draws) > 1e-3        # the reference
    assert max(m[1] for _, m in draws) > 1e-3        # the port
    calm = [both for both, m in draws if max(m) <= 1e-6]
    assert calm
    for both in calm:
        _agree(*both)


def test_card_rtr_point_input_is_well_posed():
    """The card test's point-source input: one-ulp perturbations of x8
    move neither package's float64 final cost by more than 1e-6, and the
    packages agree draw by draw."""
    base, draws = _ulp_draws(point=True)
    _agree(*base)
    for both, moved in draws:
        assert max(moved) <= 1e-6
        _agree(*both)
