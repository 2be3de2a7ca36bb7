"""The persistent-memory stochastic LBFGS (``solvers/lbfgs.py``:
``lbfgs_fit_minibatch``, ``lbfgs_minibatch_lanes``) against the JAX
``lbfgs_fit_minibatch`` in float64.

A robust least-squares problem made from a numpy seed, sum log1p((A x -
b)^2 / nu) over 40 rows of 12 parameters, is solved over 3 successive
minibatches (new rows each) with one persistent memory of 3 pairs (so the
circular slots wrap): x atol 1e-10 after every minibatch and every memory
field equal (s, y, rho, running_avg, running_avg_sq atol 1e-10; head,
nfilled, niter exactly), and the iteration counts equal. Also: a stiff
quadratic whose first line search fails all 15 Armijo tests (the last
alpha is taken untested), a NaN cost on the second minibatch (the
adaptive step turns NaN: the bad-alpha stop freezes x and stores no
pair), ``lbfgs_memory_reset``, and lanes: 3
problems on lanes, one of them stopped by a NaN cost on the second
minibatch while the others run on, against each solved alone."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import lbfgs as jl
from sagecal_tpu_torch.solvers import lbfgs as tl

NU = 2.0
N_PAR, N_ROWS, N_MEM, ITMAX = 12, 40, 3, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seed, n=3, scale=1.0):
    rng = np.random.default_rng(seed)
    xt = rng.normal(size=N_PAR)
    out = []
    for _ in range(n):
        A = scale * rng.normal(size=(N_ROWS, N_PAR))
        b = A @ xt + 0.05 * rng.standard_t(2.0, N_ROWS)
        out.append((A, b))
    return out


def _jax_fns(A, b, nan=False):
    A, b = jnp.asarray(A), jnp.asarray(b)

    def cost(x):
        r = A @ x - b
        c = jnp.sum(jnp.log1p(r * r / NU))
        return c * jnp.nan if nan else c
    return cost, jax.grad(cost)


def _torch_cost(A, b, nan=False):
    A, b = torch.as_tensor(A), torch.as_tensor(b)

    def cost(x):
        r = x @ A.T - b if x.dim() > 1 else A @ x - b
        c = torch.log1p(r * r / NU).sum(-1)
        return c * float("nan") if nan else c
    return cost


def _grad(cost):
    def grad(x):
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(cost(xv).sum(), xv)
        return g
    return grad


def _assert_memory(tm, jm):
    for f in ("s", "y", "rho", "running_avg", "running_avg_sq"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), atol=1e-10,
                                   err_msg=f)
    for f in ("head", "nfilled", "niter"):
        assert int(getattr(tm, f)) == int(getattr(jm, f)), f


def _run(batches, nan_at=None):
    """Both packages over ``batches`` with one persistent memory each:
    per minibatch (torch x, torch mem, torch k, jax x, jax mem, jax k)."""
    jx = jnp.zeros(N_PAR)
    jm = jl.lbfgs_memory_init(N_PAR, N_MEM, jnp.float64)
    tx = torch.zeros(N_PAR, dtype=torch.float64)
    tm = tl.lbfgs_memory_init(N_PAR, N_MEM, tx)
    out = []
    for i, (A, b) in enumerate(batches):
        nan = i == nan_at
        jc, jg = _jax_fns(A, b, nan)
        jx, jm, jk = jl.lbfgs_fit_minibatch(jc, jg, jx, jm, itmax=ITMAX)
        tc = _torch_cost(A, b, nan)
        tx, tm, tk = tl.lbfgs_fit_minibatch(tc, _grad(tc), tx, tm,
                                            itmax=ITMAX)
        out.append((tx, tm, tk, jx, jm, int(jk)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minibatch_chain_matches_reference(seed):
    steps = _run(_batches(seed))
    for tx, tm, tk, jx, jm, jk in steps:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-10)
        _assert_memory(tm, jm)
        assert tk == jk
    # the chain exercised what it claims: the slots wrapped, the count
    # ran across minibatches, the variance accumulator moved
    tm = steps[-1][1]
    assert tm.niter == sum(s[2] for s in steps) and tm.nfilled == N_MEM
    assert float(tm.running_avg_sq.abs().sum()) > 0


def test_exhausted_line_search_matches_reference():
    """A stiff quadratic, 1e8 |A x - b|^2: the first step from alpha = 1
    fails all 15 Armijo tests and the line search returns its last
    alpha untested, as the reference does; the iterations after it and a
    second minibatch follow: x (rtol 1e-10), the pair counters and the
    iteration counts equal, the memory's vectors to 1e-6 of their
    scale."""
    K = 1e8
    out = []
    for side in ("jax", "torch"):
        x = None
        for i, (A, b) in enumerate(_batches(9, n=2)):
            if side == "jax":
                Aj, bj = jnp.asarray(A), jnp.asarray(b)

                def cost(x, Aj=Aj, bj=bj):
                    r = Aj @ x - bj
                    return K * jnp.sum(r * r)
                if x is None:
                    x = jnp.zeros(N_PAR)
                    mem = jl.lbfgs_memory_init(N_PAR, N_MEM, jnp.float64)
                x, mem, k = jl.lbfgs_fit_minibatch(cost, jax.grad(cost), x,
                                                   mem, itmax=ITMAX)
                out.append((np.asarray(x), mem, int(k), None))
            else:
                At, bt = torch.as_tensor(A), torch.as_tensor(b)

                def cost(x, At=At, bt=bt):
                    r = x @ At.T - bt if x.dim() > 1 else At @ x - bt
                    return K * (r * r).sum(-1)
                if x is None:
                    x = torch.zeros(N_PAR, dtype=torch.float64)
                    mem = tl.lbfgs_memory_init(N_PAR, N_MEM, x)
                margins = []
                x, mem, k = tl.lbfgs_fit_minibatch(cost, _grad(cost), x, mem,
                                                   itmax=ITMAX,
                                                   armijo=margins)
                out.append((x.numpy(), mem, k, margins))
    n = len(out) // 2
    for (jx, jm, jk, _), (tx, tm, tk, margins) in zip(out[:n], out[n:]):
        np.testing.assert_allclose(tx, jx, rtol=1e-10, atol=1e-10)
        # gradients of ~1e10 carry ~1e-6 of float64 roundoff into y = g1 -
        # g and the gradient averages: those fields to 1e-6 of their scale
        for f in ("s", "y", "rho", "running_avg", "running_avg_sq"):
            want = np.asarray(getattr(jm, f))
            np.testing.assert_allclose(getattr(tm, f).numpy(), want,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f)
        for f in ("head", "nfilled", "niter"):
            assert int(getattr(tm, f)) == int(getattr(jm, f)), f
        assert tk == jk
    first = out[n][3][0]
    assert len(first) == 15 and all(m > 0 for m in first)


def test_nan_cost_is_a_bad_alpha_stop():
    """A NaN cost on minibatch 2: alphabar is NaN, the step a bad alpha;
    x stays, no pair is stored, niter still counts the iteration."""
    steps = _run(_batches(3), nan_at=1)
    for tx, tm, tk, jx, jm, jk in steps:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-10)
        _assert_memory(tm, jm)
        assert tk == jk
    (x1, m1, *_), (x2, m2, k2, *_) = steps[0], steps[1]
    assert k2 == 1 and torch.equal(x2, x1)
    assert m2.nfilled == m1.nfilled and m2.head == m1.head
    assert m2.niter == m1.niter + 1
    assert torch.isnan(m2.running_avg).all()


def test_memory_reset_matches_reference():
    steps = _run(_batches(4)[:1])
    tm, jm = steps[0][1], steps[0][4]
    assert tm.nfilled > 0
    _assert_memory(tl.lbfgs_memory_reset(tm), jl.lbfgs_memory_reset(jm))


def test_lanes_match_solo_solves():
    """Three problems on lanes over 3 minibatches (their own memories,
    steps and counts; lane 2's cost NaN on minibatch 2, so it stops at
    its first iteration and stays frozen while lanes 0 and 1 run on)
    against each lane solved alone: x and every memory field equal to
    1e-12, iterations equal."""
    probs = [_batches(s) for s in (5, 6, 7)]
    W = len(probs)
    x = torch.zeros(W, N_PAR, dtype=torch.float64)
    mem = tl.stack_memories([tl.lbfgs_memory_init(N_PAR, N_MEM, x[0])
                             for _ in range(W)])
    solo = [(torch.zeros(N_PAR, dtype=torch.float64),
             tl.lbfgs_memory_init(N_PAR, N_MEM, x[0])) for _ in range(W)]
    for i in range(3):
        costs = [_torch_cost(*p[i], nan=(w == 2 and i == 1))
                 for w, p in enumerate(probs)]
        itmax = ITMAX if i != 1 else ITMAX + 2

        def lanes(X):
            return torch.stack([c(X[w]) for w, c in enumerate(costs)])
        x, mem, k = tl.lbfgs_minibatch_lanes(lanes, _grad(lanes), x, mem,
                                             itmax)
        for w in range(W):
            sx, sm, sk = tl.lbfgs_fit_minibatch(costs[w], _grad(costs[w]),
                                                *solo[w], itmax=itmax)
            solo[w] = (sx, sm)
            np.testing.assert_allclose(x[w].numpy(), sx.numpy(), atol=1e-12)
            lm = tl.lane_memory(mem, w)
            for f in ("s", "y", "rho", "running_avg", "running_avg_sq"):
                np.testing.assert_allclose(getattr(lm, f).numpy(),
                                           getattr(sm, f).numpy(),
                                           atol=1e-12)
            assert (lm.head, lm.nfilled, lm.niter) == \
                (sm.head, sm.nfilled, sm.niter)
            assert int(k[w]) == sk
        if i == 1:
            assert list(k) == [itmax, itmax, 1]
