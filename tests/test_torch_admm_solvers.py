"""Port solvers with the consensus-ADMM augmentation (``admm=(y, bz,
rho)``) against the JAX package in float64: LM, robust LM, RTR and
robust RTR on the sweep route (``--kernel pallas``: the plain versions of
the kernels here, the JAX Pallas kernels in interpret mode), each under
``--inner chol`` and ``cg`` (the XLA assembly, NSD and the SAGE loop:
``test_torch_admm_solvers_xla.py``). Final costs within rtol 1e-8, J
within rtol 1e-8 of max|J| (the same maths; only summation order
differs), and the executed iterations equal. A constrained Jones mode is
refused."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import lm as lm_mod
from sagecal_tpu.solvers import robust as rb
from sagecal_tpu.solvers import rtr as rtr_mod
from sagecal_tpu_torch.solvers import lm as tlm
from sagecal_tpu_torch.solvers import robust as trb
from sagecal_tpu_torch.solvers import rtr as trtr

RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(N=6, T=4, K=1, M=1, seed=0, noise=0.05):
    """Rows [T, nbase] of M clusters of K hybrid chunks, and an ADMM
    state (Y, BZ [M, K, N, 8], rho [M]) near the truth."""
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
    jt8 = np.stack([Jt.reshape(M, K, N, 4).real,
                    Jt.reshape(M, K, N, 4).imag], -1).reshape(M, K, N, 8)
    BZ = jt8 + 0.05 * rng.normal(size=jt8.shape)
    Y = 0.3 * rng.normal(size=jt8.shape)
    rho = 1.5 + rng.uniform(size=M)
    return x8, coh, sta1, sta2, cid, nbase, Y, BZ, rho


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


SOLVERS = ("lm", "robust_lm", "rtr", "robust_rtr")
#: the sweep route's cases here, the XLA assembly's and NSD's in
#: test_torch_admm_solvers_xla.py
ROUTES = [(s, "pallas", i) for s in SOLVERS for i in ("chol", "cg")]


def _solve_both(solver, kernel, inner, K=1, seed=3):
    N = 6
    x8, coh, s1, s2, cid, nbase, Y, BZ, rho = _problem(N=N, K=K,
                                                       seed=seed + K)
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    jargs = (jnp.asarray(x8), jnp.asarray(coh[0]), jnp.asarray(s1),
             jnp.asarray(s2), jnp.asarray(cid), jnp.asarray(wt),
             jnp.asarray(J0), N)
    targs = (_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
             _t(cid).long(), _t(wt), _t(J0), N)
    jadmm = (jnp.asarray(Y[0]), jnp.asarray(BZ[0]), jnp.asarray(rho[0]))
    tadmm = (_t(Y[0]), _t(BZ[0]), float(rho[0]))
    if solver in ("lm", "robust_lm"):
        jcfg = lm_mod.LMConfig(itmax=8, kernel=kernel, inner=inner)
        tcfg = tlm.LMConfig(itmax=8, kernel=kernel, inner=inner)
        if solver == "lm":
            Jr, info = lm_mod.lm_solve(*jargs, row_period=nbase,
                                       config=jcfg, admm=jadmm)
            Jp, tinfo = tlm.lm_solve(*targs, row_period=nbase, config=tcfg,
                                     admm=tadmm)
        else:
            Jr, _, info = rb.robust_lm_solve(*jargs, row_period=nbase,
                                             config=jcfg, admm=jadmm)
            Jp, _, tinfo = trb.robust_lm_solve(*targs, row_period=nbase,
                                               config=tcfg, admm=tadmm)
    elif solver in ("rtr", "robust_rtr"):
        jcfg = rtr_mod.RTRConfig(itmax=6, kernel=kernel, inner=inner)
        tcfg = trtr.RTRConfig(itmax=6, kernel=kernel, inner=inner)
        if solver == "rtr":
            Jr, info = rtr_mod.rtr_solve(*jargs, row_period=nbase,
                                         config=jcfg, admm=jadmm)
            Jp, tinfo = trtr.rtr_solve(*targs, row_period=nbase,
                                       config=tcfg, admm=tadmm)
        else:
            Jr, _, info = rtr_mod.rtr_solve_robust(
                *jargs, row_period=nbase, config=jcfg, admm=jadmm)
            Jp, _, tinfo = trtr.rtr_solve_robust(
                *targs, row_period=nbase, config=tcfg, admm=tadmm)
    else:
        Jr, _, info = rtr_mod.nsd_solve_robust(
            *jargs, config=rtr_mod.NSDConfig(itmax=8), admm=jadmm)
        Jp, _, tinfo = trtr.nsd_solve_robust(
            *targs, config=trtr.NSDConfig(itmax=8), admm=tadmm)
    return Jr, info, Jp, tinfo


@pytest.mark.parametrize("solver,kernel,inner", ROUTES)
def test_admm_solver_matches_reference(solver, kernel, inner):
    """Every solver with the ADMM term, both routes and inner solvers:
    the augmented final cost within rtol 1e-8, J within 1e-8 of max|J|,
    the executed iterations equal."""
    Jr, info, Jp, tinfo = _solve_both(solver, kernel, inner)
    assert int(np.sum(tinfo["iters"])) == int(np.sum(info["iters"]))
    np.testing.assert_allclose(tinfo["init_cost"].numpy(),
                               np.asarray(info["init_cost"]), rtol=1e-10)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=RTOL)
    _close(Jp.numpy(), Jr)


@pytest.mark.parametrize("solver,kernel", [("lm", "pallas")])
def test_admm_two_chunks_match_reference(solver, kernel):
    """Two hybrid chunks, each with its own slice of y and bz."""
    Jr, info, Jp, tinfo = _solve_both(solver, kernel, "cg", K=2, seed=5)
    np.testing.assert_allclose(tinfo["final_cost"].numpy(),
                               np.asarray(info["final_cost"]), rtol=RTOL)
    _close(Jp.numpy(), Jr)


@pytest.mark.parametrize("fn", ["lm", "rtr"])
def test_admm_refuses_constrained_modes(fn):
    x8, coh, s1, s2, cid, nbase, Y, BZ, rho = _problem()
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (1, 6, 1, 1))
    args = (_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
            _t(cid).long(), _t(wt), _t(J0), 6)
    with pytest.raises(ValueError, match="jones_mode='full'"):
        if fn == "lm":
            tlm.lm_solve(*args, config=tlm.LMConfig(jones_mode="diag"),
                         admm=(_t(Y[0]), _t(BZ[0]), 2.0))
        else:
            trtr.rtr_solve(*args, config=trtr.RTRConfig(jones_mode="phase"),
                           admm=(_t(Y[0]), _t(BZ[0]), 2.0))


def test_rtr_admm_term_cannot_move_along_the_gauge():
    """ROADMAP C13's mechanism, in both packages: RTR projects the
    gradient on the horizontal space of the gauge (J -> J U), so a
    consensus term whose gradient points along the gauge is invisible to
    its steps to first order. With zero data weights, bz = p0 and y =
    X0 Omega (Omega skew-Hermitian: a vertical direction at X0), two RTR
    iterations keep J0 (the JAX package's and the port's, within 1e-12;
    later ones move it at second order, through the orbit's curvature),
    while LM on the same cost (rho ||d||^2 + 2 y^T d, least at d = -y /
    rho) moves J0 by the full step: the augmented term pins an LM
    solve's gauge, and an RTR solve's only weakly."""
    N, K = 6, 1
    x8, coh, s1, s2, cid, nbase, _, _, _ = _problem(N=N, K=K, seed=17)
    wt = np.zeros((x8.shape[0], 8))
    rng = np.random.default_rng(18)
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1)) \
        + 0.2 * (rng.normal(size=(K, N, 2, 2))
                 + 1j * rng.normal(size=(K, N, 2, 2)))
    H = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    Om = 0.5 * (H - H.conj().T)                      # skew-Hermitian
    Y = J0 @ Om                                      # [K, N, 2, 2]
    c2r = lambda J: np.stack([J.reshape(K, N, 4).real,
                              J.reshape(K, N, 4).imag], -1).reshape(K, N, 8)
    y, bz, rho = 0.1 * c2r(Y), c2r(J0), 2.0
    Jr, _ = rtr_mod.rtr_solve(
        jnp.asarray(x8), jnp.asarray(coh[0]), jnp.asarray(s1),
        jnp.asarray(s2), jnp.asarray(cid), jnp.asarray(wt), jnp.asarray(J0),
        N, row_period=nbase, config=rtr_mod.RTRConfig(itmax=2, kernel="xla"),
        admm=(jnp.asarray(y), jnp.asarray(bz), jnp.asarray(rho)))
    args = (_t(x8), _t(coh[0]), _t(s1).long(), _t(s2).long(),
            _t(cid).long(), _t(wt), _t(J0), N)
    Jp, _ = trtr.rtr_solve(*args, row_period=nbase,
                           config=trtr.RTRConfig(itmax=2, kernel="xla"),
                           admm=(_t(y), _t(bz), rho))
    np.testing.assert_allclose(np.asarray(Jr), J0, atol=1e-12)
    np.testing.assert_allclose(Jp.numpy(), J0, atol=1e-12)
    Jl, _ = tlm.lm_solve(*args, row_period=nbase,
                         config=tlm.LMConfig(itmax=4, kernel="xla"),
                         admm=(_t(y), _t(bz), rho))
    step = np.abs(Jl.numpy() - J0).max()
    assert step > 0.5 * np.abs(0.1 * Y / rho).max(), step
