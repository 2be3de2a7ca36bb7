"""The port's XLA-route assembly (``sagecal_tpu_torch/solvers/normal_eq.py``)
against the JAX package in float64, at rtol 1e-10 (atol 1e-10 of the
largest magnitude): ``normal_equations`` against the JAX
``normal_equations`` and ``_normal_equations_dense`` at kmax = 1 with a
row period (the baseline-major contraction) and at kmax = 3 and 5 (the
generic scatter), over {uniform, OS-masked, IRLS} weights x ``cost_wt``
{None, given}; ``gn_factors`` field by field and ``gn_matvec`` with and
without a shift, on the toy problems of tests/test_krylov.py; the real
Jacobians; and a folded in-flight group (``visits``) against each
visit's own call."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import normal_eq as ne
from sagecal_tpu_torch.solvers import normal_eq as tne

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(N=6, T=5, K=1, seed=0):
    """tests/test_krylov.py's problem: [T, nbase] rows, K time chunks,
    random coherencies, data from random Jones plus noise."""
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nbase = len(p)
    sta1 = np.tile(p, T).astype(np.int64)
    sta2 = np.tile(q, T).astype(np.int64)
    B = nbase * T
    cid = ((np.arange(B) // nbase) * K // T).astype(np.int64)
    coh = rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2))
    Jt = (rng.normal(size=(K, N, 2, 2)) * 0.3
          + 1j * rng.normal(size=(K, N, 2, 2)) * 0.3 + np.eye(2))
    V = Jt[cid, sta1] @ coh @ np.conj(Jt[cid, sta2].transpose(0, 2, 1))
    V = V + 0.05 * (rng.normal(size=V.shape) + 1j * rng.normal(size=V.shape))
    x8 = np.stack([V.reshape(B, 4).real, V.reshape(B, 4).imag],
                  -1).reshape(B, 8)
    J = (rng.normal(size=(K, N, 2, 2)) * 0.3
         + 1j * rng.normal(size=(K, N, 2, 2)) * 0.3 + np.eye(2))
    return dict(x8=x8, coh=coh, sta1=sta1, sta2=sta2, cid=cid, J=J,
                nbase=nbase, N=N, K=K, B=B, rng=rng)


def _weights(name, B, nbase, rng):
    if name == "uniform":
        return np.ones((B, 8))
    if name == "os":
        w = np.ones((B, 8))
        w[: 2 * nbase] = 0.0
        return w
    return rng.random((B, 8)) * (rng.random((B, 1)) > 0.1)


def _args(t, wt, torch_side):
    conv = torch.as_tensor if torch_side else jnp.asarray
    return [conv(t[k]) for k in ("x8", "J", "coh", "sta1", "sta2", "cid")] \
        + [conv(wt)]


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


#: (K, row period used): baseline-major at K = 1, generic at 3 and 5
ROUTES = [(1, True), (1, False), (3, True), (5, True)]


@pytest.mark.parametrize("cost_wt", [False, True])
@pytest.mark.parametrize("wname", ["uniform", "os", "irls"])
@pytest.mark.parametrize("K,period", ROUTES)
def test_normal_equations_match(K, period, wname, cost_wt):
    t = _toy(K=K, T=5 if K < 5 else 10, seed=K)
    wt = _weights(wname, t["B"], t["nbase"], t["rng"])
    cw = np.ones_like(wt) if cost_wt else None
    rp = t["nbase"] if period else 0
    N = t["N"]
    x8, J, coh, s1, s2, cid, w = _args(t, wt, False)
    want = ne.normal_equations(x8, J, coh, s1, s2, cid, w, N, K,
                               cost_wt=None if cw is None
                               else jnp.asarray(cw), row_period=rp)
    got = tne.normal_equations(*_args(t, wt, True), N, K,
                               cost_wt=None if cw is None
                               else torch.as_tensor(cw), row_period=rp)
    for g, h in zip(got, want):
        _close(g, h)
    # the dense oracle: the same JTJ and JTe, and the cost of wt
    dense = ne._normal_equations_dense(x8, J, coh, s1, s2, cid, w, N, K)
    _close(got[0], dense[0])
    _close(got[1], dense[1])
    if cw is None:
        _close(got[2], dense[2])


@pytest.mark.parametrize("wname", ["uniform", "os", "irls"])
@pytest.mark.parametrize("K,period", ROUTES)
def test_gn_factors_match(K, period, wname):
    t = _toy(K=K, T=5 if K < 5 else 10, seed=10 + K)
    wt = _weights(wname, t["B"], t["nbase"], t["rng"])
    rp = t["nbase"] if period else 0
    N = t["N"]
    fj, jtej, cj = ne.gn_factors(*_args(t, wt, False), N, K, row_period=rp)
    ft, jtet, ct = tne.gn_factors(*_args(t, wt, True), N, K, row_period=rp)
    for name in ("MA", "MB", "w2", "D"):
        _close(getattr(ft, name), getattr(fj, name))
    _close(jtet, jtej)
    _close(ct, cj)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("K,period", ROUTES)
def test_gn_matvec_matches(K, period, shift):
    t = _toy(K=K, T=5 if K < 5 else 10, seed=20 + K)
    wt = _weights("irls", t["B"], t["nbase"], t["rng"])
    rp = t["nbase"] if period else 0
    N = t["N"]
    v = t["rng"].normal(size=(K, 8 * N))
    sh = t["rng"].uniform(0.1, 2.0, K) if shift else None
    fj, _, _ = ne.gn_factors(*_args(t, wt, False), N, K, row_period=rp)
    ft, _, _ = tne.gn_factors(*_args(t, wt, True), N, K, row_period=rp)
    want = ne.gn_matvec(fj, jnp.asarray(v), jnp.asarray(t["sta1"]),
                        jnp.asarray(t["sta2"]), jnp.asarray(t["cid"]), K, N,
                        shift=None if sh is None else jnp.asarray(sh),
                        row_period=rp)
    got = tne.gn_matvec(ft, torch.as_tensor(v), torch.as_tensor(t["sta1"]),
                        torch.as_tensor(t["sta2"]), torch.as_tensor(t["cid"]),
                        K, N, shift=None if sh is None
                        else torch.as_tensor(sh), row_period=rp)
    _close(got, want)
    # the operator is the dense JTJ (+ shift I)
    JTJ, _, _ = tne.normal_equations(*_args(t, wt, True), N, K,
                                     row_period=rp)
    dense = torch.einsum("kij,kj->ki", JTJ, torch.as_tensor(v))
    if sh is not None:
        dense = dense + torch.as_tensor(sh)[:, None] * torch.as_tensor(v)
    _close(got, dense)


def test_baseline_jacobians_match():
    t = _toy(K=2, seed=30)
    want = ne.baseline_jacobians(*[jnp.asarray(t[k]) for k in (
        "J", "coh", "sta1", "sta2", "cid")])
    got = tne.baseline_jacobians(*[torch.as_tensor(t[k]) for k in (
        "J", "coh", "sta1", "sta2", "cid")])
    for g, h in zip(got, want):
        _close(g, h)


@pytest.mark.parametrize("K", [1, 2])
def test_folded_visits_match_each_visit(K):
    """A group of V = 3 visits folded as ``ops.sweep.Lanes`` lays it out
    (rows [V B], chunk ids v K + k, Jones [V K, N]) gives each visit's
    own equations, operator and product: per visit by the time-axis
    contraction at K = 1, by the generic scatter at K = 2."""
    V = 3
    ts = [_toy(K=K, seed=40 + v) for v in range(V)]
    N, nb, B = ts[0]["N"], ts[0]["nbase"], ts[0]["B"]
    cat = lambda k: torch.cat([torch.as_tensor(t[k]) for t in ts])
    wts = [_weights("irls", B, nb, t["rng"]) for t in ts]
    cid = torch.cat([torch.as_tensor(t["cid"]) + v * K
                     for v, t in enumerate(ts)])
    folded = (cat("x8"), cat("J"), cat("coh"), cat("sta1"), cat("sta2"),
              cid, torch.cat([torch.as_tensor(w) for w in wts]))
    ne_f = tne.normal_equations(*folded, N, V * K, row_period=nb, visits=V)
    fac_f, jte_f, cost_f = tne.gn_factors(*folded, N, V * K, row_period=nb,
                                          visits=V)
    v_in = ts[0]["rng"].normal(size=(V * K, 8 * N))
    y_f = tne.gn_matvec(fac_f, torch.as_tensor(v_in), folded[3], folded[4],
                        cid, V * K, N, row_period=nb, visits=V)
    for v, t in enumerate(ts):
        one = _args(t, wts[v], True)
        sl = slice(v * K, (v + 1) * K)
        JTJ, JTe, cost = tne.normal_equations(*one, N, K, row_period=nb)
        _close(ne_f[0][sl], JTJ)
        _close(ne_f[1][sl], JTe)
        _close(ne_f[2][sl], cost)
        fac, jte, cst = tne.gn_factors(*one, N, K, row_period=nb)
        _close(fac_f.D[sl], fac.D)
        _close(jte_f[sl], jte)
        y = tne.gn_matvec(fac, torch.as_tensor(v_in[sl]), one[3], one[4],
                          one[5], K, N, row_period=nb)
        _close(y_f[sl], y)
