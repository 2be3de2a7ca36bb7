"""Constrained Jones modes of the port (``--jones diag|phase``;
sagecal_tpu_torch/solvers/normal_eq.py, solvers/rtr.py) against the JAX
reference in float64: the mode helpers (rtol 1e-12), the mode-aware XLA
assembly ``normal_equations_mode``, ``gn_factors_mode`` and
``gn_matvec_mode`` with uniform and IRLS weights (rtol 1e-10 of the
largest entry: the same sums in another order), the reduced blocks as the
projection of the full-Jones system at the constrained point (5e-12, as
tests/test_jones.py holds the reference), full mode as the full-Jones
functions bit for bit, and the gauge projection, which removes the global
phase and nothing else. The Jones fed to the assemblies has non-zero
off-diagonals: each constrains it at entry."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import normal_eq as ne
from sagecal_tpu.solvers import robust as rb
from sagecal_tpu.solvers import rtr as rtr_mod
from sagecal_tpu_torch.solvers import normal_eq as tne
from sagecal_tpu_torch.solvers import rtr as trtr

RTOL = 1e-10
REL = 5e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _geometry(N=5, nb=8, T=6, K=2, seed=0):
    """tests/test_jones.py's geometry as numpy arrays: tiled rows of 8
    baselines (stations repeat), time-contiguous chunks, random data and
    coherencies, a full Jones with non-zero off-diagonals."""
    rng = np.random.default_rng(seed)
    s1 = np.array([0, 1, 2, 3, 4, 0, 1, 2])[:nb]
    s2 = np.array([1, 2, 3, 4, 0, 2, 3, 4])[:nb]
    B = nb * T
    return dict(
        N=N, nb=nb, T=T, K=K, B=B, rng=rng,
        sta1=np.tile(s1, T).astype(np.int64),
        sta2=np.tile(s2, T).astype(np.int64),
        chunk=(np.repeat(np.arange(T), nb) * K // T).astype(np.int64),
        coh=rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2)),
        x8=rng.normal(size=(B, 8)),
        J=rng.normal(size=(K, N, 2, 2)) + 1j * rng.normal(size=(K, N, 2, 2)))


def _weights(kind, g):
    """Uniform, or IRLS E-step weights (nu + 1) / (nu + e^2) of the
    residual at the full J."""
    if kind == "uniform":
        return np.ones((g["B"], 8))
    J = g["J"]
    Jp, Jq = J[g["chunk"], g["sta1"]], J[g["chunk"], g["sta2"]]
    mf = np.einsum("bij,bjk,blk->bil", Jp, g["coh"], Jq.conj()).reshape(
        g["B"], 4)
    m8 = np.stack([mf.real, mf.imag], -1).reshape(g["B"], 8)
    return np.asarray(rb.update_weights(jnp.asarray(g["x8"] - m8), 5.0))


def _args(g, wt):
    return (g["x8"], g["J"], g["coh"], g["sta1"], g["sta2"], g["chunk"], wt)


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _t(args):
    return tuple(torch.as_tensor(np.array(a)) for a in args)


@pytest.mark.parametrize("mode", ["full", "diag", "phase"])
def test_mode_helpers_match_reference(mode):
    """jones_constrain, params_from_jones and jones_from_params equal the
    reference's; diag parameters round-trip exactly, phase encodes
    theta = 0 and its retraction is Jref exp(i theta)."""
    assert tne.JONES_MODES == ne.JONES_MODES
    assert tne.jones_mdim(mode) == ne.jones_mdim(mode)
    assert tne.jones_npar(mode) == ne.jones_npar(mode)
    g = _geometry()
    J = g["J"]
    Jc = tne.jones_constrain(torch.as_tensor(J), mode)
    np.testing.assert_array_equal(Jc.numpy(), np.asarray(
        ne.jones_constrain(jnp.asarray(J), mode)))
    if mode != "full":
        assert not Jc[..., 0, 1].any() and not Jc[..., 1, 0].any()
    p = tne.params_from_jones(Jc, mode)
    pr = ne.params_from_jones(jnp.asarray(Jc.numpy()), mode)
    _close(p.numpy(), pr, rtol=1e-12)
    back = tne.jones_from_params(p, mode, Jref=Jc)
    if mode != "phase":
        np.testing.assert_array_equal(back.numpy(), Jc.numpy())
    else:
        assert not p.any()
        _close(back.numpy(), Jc.numpy(), rtol=1e-12)
    th = g["rng"].normal(size=tuple(p.shape))
    got = tne.jones_from_params(torch.as_tensor(th), mode, Jref=Jc)
    want = ne.jones_from_params(jnp.asarray(th), mode,
                                Jref=jnp.asarray(Jc.numpy()))
    _close(got.numpy(), want, rtol=1e-12)


CASES = [(m, w) for m in ("diag", "phase") for w in ("uniform", "irls")]


@pytest.mark.parametrize("mode,wkind", CASES)
def test_mode_assembly_matches_reference(mode, wkind):
    """normal_equations_mode (with a separate cost weight),
    gn_factors_mode and gn_matvec_mode (with and without a shift) against
    the reference at an unconstrained J."""
    g = _geometry(seed=1 + len(mode))
    wt = _weights(wkind, g)
    cw = np.abs(g["rng"].normal(size=(g["B"], 8))) + 0.1
    N, K = g["N"], g["K"]
    ref = ne.normal_equations_mode(*_j(_args(g, wt)), N, K, mode,
                                   cost_wt=jnp.asarray(cw))
    got = tne.normal_equations_mode(*_t(_args(g, wt)), N, K, mode,
                                    cost_wt=torch.as_tensor(cw))
    npar = tne.jones_npar(mode)
    assert got[0].shape == (K, npar * N, npar * N)
    for a, b in zip(got, ref):
        _close(a.numpy(), b)
    fr, JTer, costr = ne.gn_factors_mode(*_j(_args(g, wt)), N, K, mode)
    fac, JTe, cost = tne.gn_factors_mode(*_t(_args(g, wt)), N, K, mode)
    assert isinstance(fac, tne.GNFactorsMode)
    for a, b in zip(tuple(fac) + (JTe, cost), tuple(fr) + (JTer, costr)):
        _close(a.numpy(), b)
    v = g["rng"].normal(size=(K, npar * N))
    for shift in (None, np.array([0.3, 0.05])):
        want = ne.gn_matvec_mode(
            fr, jnp.asarray(v), jnp.asarray(g["sta1"]),
            jnp.asarray(g["sta2"]), jnp.asarray(g["chunk"]), K, N,
            shift=None if shift is None else jnp.asarray(shift))
        y = tne.gn_matvec_mode(
            fac, torch.as_tensor(v), torch.as_tensor(g["sta1"]),
            torch.as_tensor(g["sta2"]), torch.as_tensor(g["chunk"]), K, N,
            shift=None if shift is None else torch.as_tensor(shift))
        _close(y.numpy(), want)
        # the matrix-free product is the dense operator
        dense = torch.einsum("kij,kj->ki", got[0], torch.as_tensor(v))
        if shift is not None:
            dense = dense + torch.as_tensor(shift)[:, None] \
                * torch.as_tensor(v)
        _close(y.numpy(), dense.numpy())


def _tmat(J, mode):
    """[K, N, 8, npar]: column m is d(full 8-real params) / d(reduced
    param m) (tests/test_jones.py:_tmat)."""
    K, N = J.shape[:2]
    if mode == "diag":
        T = np.zeros((K, N, 8, 4))
        for m, ix in enumerate((0, 1, 6, 7)):
            T[:, :, ix, m] = 1.0
    else:
        T = np.zeros((K, N, 8, 2))
        for c, (re, im) in enumerate(((0, 1), (6, 7))):
            jcc = J[:, :, c, c]
            T[:, :, re, c] = -jcc.imag
            T[:, :, im, c] = jcc.real
    Tb = np.zeros((K, 8 * N, T.shape[-1] * N))
    for k in range(K):
        for n in range(N):
            Tb[k, 8 * n:8 * n + 8, T.shape[-1] * n:T.shape[-1] * (n + 1)] \
                = T[k, n]
    return Tb


@pytest.mark.parametrize("mode", ["diag", "phase"])
def test_reduced_blocks_are_the_masked_full_blocks(mode):
    """At the constrained J the reduced system is the projection of the
    port's full-Jones system: JTJ_m = T^T JTJ T, JTe_m = T^T JTe, and the
    cost is the full mode's (tests/test_jones.py:188)."""
    g = _geometry()
    wt = _weights("irls", g)
    Jc = tne.jones_constrain(torch.as_tensor(g["J"]), mode)
    args = _t(_args(g, wt))
    args = args[:1] + (Jc,) + args[2:]
    JTJf, JTef, costf = tne.normal_equations(*args, g["N"], g["K"])
    JTJm, JTem, costm = tne.normal_equations_mode(*args, g["N"], g["K"],
                                                  mode)
    Tb = _tmat(Jc.numpy(), mode)
    assert _rel(JTJm.numpy(), np.einsum("kij,kim,kjn->kmn", JTJf.numpy(),
                                        Tb, Tb)) < REL
    assert _rel(JTem.numpy(), np.einsum("ki,kim->km", JTef.numpy(),
                                        Tb)) < REL
    assert _rel(costm.numpy(), costf.numpy()) < REL


def test_full_mode_delegates_bit_for_bit():
    """In full mode the *_mode entry points are the full-Jones functions:
    the same bits."""
    g = _geometry()
    args = _t(_args(g, _weights("irls", g)))
    for a, b in zip(tne.normal_equations_mode(*args, g["N"], g["K"], "full",
                                              row_period=g["nb"]),
                    tne.normal_equations(*args, g["N"], g["K"],
                                         row_period=g["nb"])):
        assert torch.equal(a, b)
    fm, JTem, cm = tne.gn_factors_mode(*args, g["N"], g["K"], "full")
    ff, JTef, cf = tne.gn_factors(*args, g["N"], g["K"])
    assert isinstance(fm, tne.GNFactors)
    assert all(torch.equal(a, b) for a, b in zip(tuple(fm) + (JTem, cm),
                                                 tuple(ff) + (JTef, cf)))


@pytest.mark.parametrize("mode", ["diag", "phase"])
def test_project_tangent_mode_removes_global_phase_only(mode):
    """The gauge direction (the global phase) maps to zero, the
    projection is idempotent and leaves a vector orthogonal to the gauge
    direction; it equals the reference's (tests/test_jones.py:498)."""
    g = _geometry(K=2)
    K, N = g["K"], g["N"]
    npar = tne.jones_npar(mode)
    Jc = tne.jones_constrain(torch.as_tensor(g["J"]), mode)
    # a point away from theta = 0 in phase mode
    p = (tne.params_from_jones(Jc, mode).reshape(K, -1)
         + (0.3 if mode == "phase" else 0.0))
    if mode == "phase":
        gauge = torch.ones_like(p)
    else:
        d = torch.stack([Jc[..., 0, 0], Jc[..., 1, 1]], -1)
        gauge = torch.stack([-d.imag, d.real], -1).reshape(K, -1)
    out = trtr.project_tangent_mode(p, gauge, K, N, mode)
    assert float(out.abs().max()) < REL * float(gauge.abs().max())
    v = torch.as_tensor(g["rng"].normal(size=(K, npar * N)))
    once = trtr.project_tangent_mode(p, v, K, N, mode)
    twice = trtr.project_tangent_mode(p, once, K, N, mode)
    assert _rel(twice.numpy(), once.numpy()) < REL
    assert float((once * gauge).sum(-1).abs().max()) \
        < 1e-9 * float(v.abs().max() * gauge.abs().max())
    want = rtr_mod.project_tangent_mode(jnp.asarray(p.numpy()),
                                        jnp.asarray(v.numpy()), K, N, mode)
    _close(once.numpy(), want, rtol=1e-12)
