"""The port's reduced storage policies (``--dtype-policy bf16|f16``,
sagecal_tpu_torch/dtypes.py) against the JAX package on the CPU: the
policy helpers, the plain sweep and multi-visit sweep at the reduced
instances' storage dtypes, the LU damped block solve, and the XLA-route
assemblies.

- Helpers: the ``f32`` policy is the identity (the same tensor back), and
  rounding float32 to bf16 and f16 gives the JAX package's bits.
- Plain sweep and visits at bf16 and f16, md = 4, 2, 1, K = 1, 2, 4,
  against ``sweep_pallas.sweep_blocks(..., interpret=True)`` and
  ``sweep_blocks_visits`` on the same storage inputs: the same planes are
  rounded at the same boundary, so only float32 sums in another order
  differ (gate 5e-5 of each output's largest magnitude; measured up to
  1.6e-5, on a jte of cancelling terms, with no storage rounding of an A,
  Bm or model plane differing between the two packages' float32 planes).
  An empty chunk's blocks are exactly 0.
- The assemblies (``normal_equations`` on both aggregations,
  ``gn_factors``/``gn_matvec``, ``os_subset_equations`` and the ``_mode``
  forms) against the JAX package at the same policy (the same 5e-5 of
  the largest magnitude: the same storage roundings, float32 sums in
  another order), and against the float32 path at
  tests/test_dtype_policy.py's own tolerances (2e-2 / 4e-3 / 3e-2).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import dtypes as jdt
from sagecal_tpu.ops import sweep_pallas as jsw
from sagecal_tpu.solvers import lm as jlm
from sagecal_tpu.solvers import normal_eq as jne
from sagecal_tpu_torch import dtypes as tdt
from sagecal_tpu_torch.ops import sweep as tsw
from sagecal_tpu_torch.solvers import normal_eq as tne

POLICIES = ("bf16", "f16")
JST = {"bf16": jnp.bfloat16, "f16": jnp.float16}
TST = {"bf16": torch.bfloat16, "f16": torch.float16}
#: port against JAX at the same policy, in units of each output's
#: largest magnitude: the same storage roundings, float32 sums in another
#: order
SAME = 5e-5
#: reduced against float32 (tests/test_dtype_policy.py's tolerances)
NE_TOL = {"bf16": 2e-2, "f16": 4e-3}
MATVEC_TOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(N=6, T=4, K=1, seed=0, noise=0.05):
    """tests/test_dtype_policy.py's toy problem (float32 data, complex64
    coherencies) as numpy arrays, with K time chunks."""
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nbase = len(p)
    sta1 = np.tile(p, T).astype(np.int32)
    sta2 = np.tile(q, T).astype(np.int32)
    B = nbase * T
    chunk_id = ((np.arange(B) // nbase) * K // T).astype(np.int32)
    coh = rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2))
    Jtrue = (rng.normal(size=(K, N, 2, 2)) * 0.3
             + 1j * rng.normal(size=(K, N, 2, 2)) * 0.3 + np.eye(2))
    V = (Jtrue[chunk_id, sta1] @ coh
         @ np.conj(Jtrue[chunk_id, sta2].transpose(0, 2, 1)))
    V = V + noise * (rng.normal(size=V.shape) + 1j * rng.normal(size=V.shape))
    x8 = np.stack([V.reshape(B, 4).real, V.reshape(B, 4).imag],
                  -1).reshape(B, 8)
    return (x8.astype(np.float32), coh.astype(np.complex64), sta1, sta2,
            chunk_id, nbase)


def _jones(K, N, seed):
    rng = np.random.default_rng(seed)
    return (np.eye(2) + 0.1 * (rng.normal(size=(K, N, 2, 2))
                               + 1j * rng.normal(size=(K, N, 2, 2)))
            ).astype(np.complex64)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jst(a, policy):
    """float32 numpy -> JAX array in the storage dtype of ``policy``."""
    return jnp.asarray(a, jnp.float32).astype(JST[policy])


def _tst(a, policy):
    return _t(a, torch.float32).to(TST[policy])


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_f32_policy_is_the_identity():
    x = torch.ones((5, 8), dtype=torch.float64)
    assert tdt.validate("f32") == "f32"
    assert tdt.storage_dtype("f32", torch.float64) == torch.float64
    assert tdt.to_storage(x, torch.float64) is x
    assert tdt.acc(x) is x
    assert tdt.pet(x, x)[0] is x
    assert tdt.acc_dtype(torch.float32) == torch.float32
    assert not tdt.is_reduced(torch.float32)
    assert tdt.storage_tensor(np.ones(3), "f32", torch.float64).dtype \
        == torch.float64
    for policy in POLICIES:
        st = tdt.storage_dtype(policy, torch.float64)
        assert st == TST[policy] and tdt.is_reduced(st)
        assert tdt.acc_dtype(st) == torch.float32
        assert tdt.acc(x.to(st)).dtype == torch.float32
    with pytest.raises(ValueError):
        tdt.validate("f8")


@pytest.mark.parametrize("policy", POLICIES)
def test_rounding_matches_jax_bit_for_bit(policy):
    """Float32 values (ties, f16 overflows and subnormals among them)
    round to the JAX package's storage bits; ``storage_tensor`` stages
    float64 host data through float32 as the JAX pipeline does."""
    rng = np.random.default_rng(3)
    v = np.concatenate([
        rng.normal(scale=10.0, size=20000),
        rng.normal(scale=1e5, size=2000),                  # f16 overflow
        rng.normal(scale=1e-6, size=2000),                 # subnormals
        (1.0 + (np.arange(512) + 0.5) * 2.0 ** -8),       # bf16 ties
        (1.0 + (np.arange(512) + 0.5) * 2.0 ** -11)]).astype(np.float32)
    ref = np.asarray(jnp.asarray(v).astype(JST[policy]).astype(jnp.float32))
    got = _t(v).to(TST[policy]).float().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    staged = tdt.storage_tensor(v.astype(np.float64), policy)
    assert staged.dtype == TST[policy]
    np.testing.assert_array_equal(staged.float().numpy(), ref)


# ---------------------------------------------------------------------------
# the plain sweep and visits at the reduced instances' storage dtypes
# ---------------------------------------------------------------------------

SWEEP_CASES = [(p, j, K) for p in POLICIES for j in ("full", "diag", "phase")
               for K in (1, 2, 4)]


@pytest.mark.parametrize("policy,jones,K", SWEEP_CASES)
def test_plain_sweep_matches_pallas(policy, jones, K):
    x8, coh, s1, s2, cid, nb = _toy(N=6, T=4, K=K, seed=3 + K)
    J = _jones(K, 6, 7)
    rng = np.random.default_rng(11)
    wt = (rng.random(x8.shape) * (rng.random((x8.shape[0], 1)) > 0.1)
          ).astype(np.float32)
    cw = rng.random(x8.shape).astype(np.float32)
    ref = jsw.sweep_blocks(_jst(x8, policy), jnp.asarray(J), jnp.asarray(coh),
                           jnp.asarray(s1), jnp.asarray(s2),
                           jnp.asarray(cid), _jst(wt, policy),
                           _jst(cw, policy), nb, K, interpret=True,
                           jones=jones)
    got = tsw.sweep_blocks(_tst(x8, policy), _t(J), _t(coh), _t(s1).long(),
                           _t(s2).long(), _t(cid).long(), _tst(wt, policy),
                           _tst(cw, policy), nb, K, jones=jones)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        assert _rel(g.numpy(), r) <= SAME


@pytest.mark.parametrize("policy", POLICIES)
def test_plain_sweep_empty_chunk_is_zero(policy):
    """A cluster of one chunk solved at kmax = 2: chunk 1 has no rows and
    its blocks and cost are exactly 0 at the reduced dtypes too."""
    x8, coh, s1, s2, cid, nb = _toy(N=6, T=4, K=1, seed=5)
    J = _jones(2, 6, 8)
    w = _tst(np.ones_like(x8), policy)
    got = tsw.sweep_blocks(_tst(x8, policy), _t(J), _t(coh), _t(s1).long(),
                           _t(s2).long(), _t(cid).long(), w, w, nb, 2)
    assert all(float(g[1].abs().max()) == 0.0 for g in got)
    assert all(float(g[0].abs().max()) > 0.0 for g in got)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("jones", ["full", "diag", "phase"])
def test_plain_visits_match_pallas(policy, jones):
    """V = 3 visits, K = 2, the data, Jones and coherencies per visit and
    the weights and chunk ids shared, against the JAX package's visits
    kernel in interpret mode."""
    V, K, N = 3, 2, 6
    x8s, cohs = [], []
    for v in range(V):
        x8, coh, s1, s2, cid, nb = _toy(N=N, T=4, K=K, seed=20 + v)
        x8s.append(x8)
        cohs.append(coh)
    x8, coh = np.stack(x8s), np.stack(cohs)
    J = np.stack([_jones(K, N, 30 + v) for v in range(V)])
    wt = np.random.default_rng(4).random(x8.shape[1:]).astype(np.float32)
    ref = jsw.sweep_blocks_visits(
        _jst(x8, policy), jnp.asarray(J), jnp.asarray(coh), jnp.asarray(s1),
        jnp.asarray(s2), jnp.asarray(cid), _jst(wt, policy),
        _jst(wt, policy), nb, K, V, (True, True, True, False, False, False),
        interpret=True, jones=jones)
    got = tsw.sweep_blocks_visits(
        _tst(x8, policy), _t(J), _t(coh), _t(s1).long(), _t(s2).long(),
        _t(cid).long(), _tst(wt, policy), _tst(wt, policy), nb, K, V,
        jones=jones)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        assert _rel(g.numpy(), r) <= SAME


@pytest.mark.parametrize("policy", POLICIES)
def test_reduced_block_solve_is_lu_with_retry(policy):
    """The reduced policies' damped block solve (LU) against the JAX
    package's ``solve_damped_blocks(reduced=True)``: a one-chunk cluster
    at kmax = 2 whose empty chunk 1 has a zero system at a zero shift
    fails its first LU and is solved at the boosted shift (dp = 0), as
    in the JAX package; chunk 0 agrees with the Cholesky solve to float32
    roundoff (gate 1e-4 at mu = 1)."""
    x8, coh, s1, s2, cid, nb = _toy(N=6, T=4, K=1, seed=9)
    J = _jones(2, 6, 10)
    w = np.ones_like(x8)
    jfac, jJTe, _ = jsw.gn_blocks(_jst(x8, policy), jnp.asarray(J),
                                  jnp.asarray(coh), jnp.asarray(s1),
                                  jnp.asarray(s2), jnp.asarray(cid),
                                  _jst(w, policy), 6, 2, nb,
                                  interpret=True)
    tfac, tJTe, _ = tsw.gn_blocks(_tst(x8, policy), _t(J), _t(coh),
                                  _t(s1).long(), _t(s2).long(),
                                  _t(cid).long(), _tst(w, policy), 6, 2, nb)
    mu = np.array([1.0, 0.0], np.float32)
    jdp, jok = jsw.solve_damped_blocks(jfac, jJTe, jnp.asarray(mu), 0.0,
                                       jnp.asarray(s1), jnp.asarray(s2), 6,
                                       reduced=True)
    tdp, tok = tsw.solve_damped_blocks(tfac, tJTe, _t(mu), 0.0,
                                       _t(s1).long(), _t(s2).long(), 6,
                                       reduced=True)
    _, first = tsw.chol_solve_blocks_shift(tfac, tJTe, _t(mu), _t(s1).long(),
                                           _t(s2).long(), 6,
                                           reduced=True)
    assert first.tolist() == [True, False]
    assert tok.tolist() == np.asarray(jok).tolist() == [True, True]
    assert float(tdp[1].abs().max()) == 0.0 == float(jnp.abs(jdp[1]).max())
    assert _rel(tdp.numpy(), jdp) <= 1e-4
    cdp, _ = tsw.solve_damped_blocks(tfac, tJTe, _t(mu), 0.0, _t(s1).long(),
                                     _t(s2).long(), 6)
    assert _rel(tdp[0].numpy(), cdp[0].numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# the XLA-route assemblies
# ---------------------------------------------------------------------------

def _assembly_inputs(K, seed, irls=False):
    x8, coh, s1, s2, cid, nb = _toy(N=6, T=4, K=K, seed=seed)
    rng = np.random.default_rng(seed + 1)
    wt = np.full(x8.shape, 0.7, np.float32)
    if irls:
        wt = rng.random(x8.shape).astype(np.float32)
    return x8, coh, s1, s2, cid, nb, wt, _jones(K, 6, seed + 2)


def _both_sides(policy, x8, wt, coh, s1, s2, cid, J):
    jx = (_jst(x8, policy), _jst(wt, policy), jnp.asarray(coh),
          jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(cid), jnp.asarray(J))
    tx = (_tst(x8, policy), _tst(wt, policy), _t(coh), _t(s1).long(),
          _t(s2).long(), _t(cid).long(), _t(J))
    return jx, tx


NE_CASES = [(p, K, rp) for p in POLICIES for K, rp in ((1, True), (1, False),
                                                       (2, False))]


@pytest.mark.parametrize("policy,K,baseline_major", NE_CASES)
def test_normal_equations_reduced(policy, K, baseline_major):
    """``normal_equations`` on storage data: the baseline-major branch
    (one chunk, row_period) and the generic scatter, float32 outputs,
    against the JAX package at the same policy and the float32 path at
    NE_TOL."""
    x8, coh, s1, s2, cid, nb, wt, J = _assembly_inputs(K, 40 + K, irls=True)
    rp = nb if baseline_major else 0
    (jx8, jwt, jcoh, js1, js2, jcid, jJ), (tx8, twt, tcoh, ts1, ts2, tcid,
                                            tJ) = _both_sides(
        policy, x8, wt, coh, s1, s2, cid, J)
    ref = jne.normal_equations(jx8, jJ, jcoh, js1, js2, jcid, jwt, 6, K,
                               row_period=rp)
    got = tne.normal_equations(tx8, tJ, tcoh, ts1, ts2, tcid, twt, 6, K,
                               row_period=rp)
    f32 = tne.normal_equations(_t(x8), tJ, tcoh, ts1, ts2, tcid, _t(wt), 6,
                               K, row_period=rp)
    for r, g, f in zip(ref, got, f32):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), r) <= SAME
        rel = float(torch.linalg.vector_norm(g - f)
                    / torch.linalg.vector_norm(f))
        assert rel < NE_TOL[policy], rel


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("baseline_major", [True, False])
def test_gn_factors_and_matvec_reduced(policy, baseline_major):
    """``gn_factors`` keeps MA/MB and w2 in the storage dtype and D, JTe
    and the cost in float32; ``gn_matvec`` rounds v and w^2 u to the
    storage dtype per product: both against the JAX package at the same
    policy, and the product against the float32 path at MATVEC_TOL."""
    x8, coh, s1, s2, cid, nb, wt, J = _assembly_inputs(1, 50, irls=True)
    rp = nb if baseline_major else 0
    (jx8, jwt, jcoh, js1, js2, jcid, jJ), (tx8, twt, tcoh, ts1, ts2, tcid,
                                            tJ) = _both_sides(
        policy, x8, wt, coh, s1, s2, cid, J)
    jfac, jJTe, jc = jne.gn_factors(jx8, jJ, jcoh, js1, js2, jcid, jwt, 6, 1,
                                    row_period=rp)
    tfac, tJTe, tc = tne.gn_factors(tx8, tJ, tcoh, ts1, ts2, tcid, twt, 6, 1,
                                    row_period=rp)
    assert tfac.MA.dtype == TST[policy] and tfac.w2.dtype == TST[policy]
    assert tfac.D.dtype == torch.float32
    for r, g in zip(tuple(jfac) + (jJTe, jc), tuple(tfac) + (tJTe, tc)):
        assert _rel(g.float().numpy(), np.asarray(r, np.float32)) <= SAME
    v = np.random.default_rng(51).normal(size=(1, 48)).astype(np.float32)
    jy = jne.gn_matvec(jfac, jnp.asarray(v), js1, js2, jcid, 1, 6,
                       shift=jnp.asarray([0.3], jnp.float32), row_period=rp)
    ty = tne.gn_matvec(tfac, _t(v), ts1, ts2, tcid, 1, 6,
                       shift=_t([0.3]), row_period=rp)
    assert ty.dtype == torch.float32 and _rel(ty.numpy(), jy) <= SAME
    ffac, _, _ = tne.gn_factors(_t(x8), tJ, tcoh, ts1, ts2, tcid, _t(wt), 6,
                                1, row_period=rp)
    fy = tne.gn_matvec(ffac, _t(v), ts1, ts2, tcid, 1, 6, shift=_t([0.3]),
                       row_period=rp)
    rel = float(torch.linalg.vector_norm(ty - fy)
                / torch.linalg.vector_norm(fy))
    assert rel < MATVEC_TOL, rel


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["full", "diag", "phase"])
def test_os_subset_equations_reduced(policy, mode):
    """The reduced OS body from each subset's rows alone (the short tail
    subset included) against the JAX package at the same policy, and
    against the float32 masked full pass at 2e-2 (the JAX package's gate
    in test_os_subset_equations_exact_vs_masked)."""
    T = 5
    x8, coh, s1, s2, cid, nb = _toy(N=6, T=T, seed=61)
    wt = np.ones_like(x8)
    J = _jones(1, 6, 62)
    os_ids, ns = jlm.os_subset_ids(T, nb)
    ntper = -(-T // ns)
    (jx8, jwt, jcoh, js1, js2, jcid, jJ), (tx8, twt, tcoh, ts1, ts2, tcid,
                                            tJ) = _both_sides(
        policy, x8, wt, coh, s1, s2, cid, J)
    for sub in range(ns):
        ref = jne.os_subset_equations_mode(
            jx8, jJ, jcoh, js1, js2, jwt, jnp.asarray(os_ids),
            jnp.asarray(sub, jnp.int32), ntper, nb, 6, jwt, mode=mode)
        got = tne.os_subset_equations_mode(
            tx8, tJ, tcoh, ts1, ts2, twt, _t(os_ids).long(), sub, ntper, nb,
            6, twt, mode=mode)
        wmask = _t(wt * (os_ids == sub)[:, None])
        f32 = tne.normal_equations_mode(_t(x8), tJ, tcoh, ts1, ts2, tcid,
                                        wmask, 6, 1, mode=mode,
                                        cost_wt=_t(wt), row_period=nb)
        for r, g, f in zip(ref, got, f32):
            assert g.dtype == torch.float32
            assert _rel(g.numpy(), r) <= SAME
            rel = float(torch.linalg.vector_norm(g - f)
                        / torch.linalg.vector_norm(f))
            assert rel < 2e-2, (sub, rel)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["diag", "phase"])
def test_mode_assemblies_reduced(policy, mode):
    """``normal_equations_mode``, ``gn_factors_mode`` and
    ``gn_matvec_mode`` on storage data (two chunks, IRLS weights) against
    the JAX package at the same policy, and the dense equations against
    the float32 path at NE_TOL."""
    x8, coh, s1, s2, cid, nb, wt, J = _assembly_inputs(2, 70, irls=True)
    (jx8, jwt, jcoh, js1, js2, jcid, jJ), (tx8, twt, tcoh, ts1, ts2, tcid,
                                            tJ) = _both_sides(
        policy, x8, wt, coh, s1, s2, cid, J)
    ref = jne.normal_equations_mode(jx8, jJ, jcoh, js1, js2, jcid, jwt, 6, 2,
                                    mode=mode)
    got = tne.normal_equations_mode(tx8, tJ, tcoh, ts1, ts2, tcid, twt, 6, 2,
                                    mode=mode)
    f32 = tne.normal_equations_mode(_t(x8), tJ, tcoh, ts1, ts2, tcid, _t(wt),
                                    6, 2, mode=mode)
    for r, g, f in zip(ref, got, f32):
        assert g.dtype == torch.float32 and _rel(g.numpy(), r) <= SAME
        rel = float(torch.linalg.vector_norm(g - f)
                    / torch.linalg.vector_norm(f))
        assert rel < NE_TOL[policy], rel
    jfac, jJTe, jc = jne.gn_factors_mode(jx8, jJ, jcoh, js1, js2, jcid, jwt,
                                         6, 2, mode=mode)
    tfac, tJTe, tc = tne.gn_factors_mode(tx8, tJ, tcoh, ts1, ts2, tcid, twt,
                                         6, 2, mode=mode)
    assert tfac.FA.dtype == TST[policy] and tfac.D.dtype == torch.float32
    for r, g in zip(tuple(jfac) + (jJTe, jc), tuple(tfac) + (tJTe, tc)):
        assert _rel(g.float().numpy(), np.asarray(r, np.float32)) <= SAME
    md = tne.jones_mdim(mode)
    v = np.random.default_rng(71).normal(size=(2, 2 * md * 6)).astype(
        np.float32)
    jy = jne.gn_matvec_mode(jfac, jnp.asarray(v), js1, js2, jcid, 2, 6,
                            shift=jnp.asarray([0.2, 0.4], jnp.float32))
    ty = tne.gn_matvec_mode(tfac, _t(v), ts1, ts2, tcid, 2, 6,
                            shift=_t([0.2, 0.4]))
    assert ty.dtype == torch.float32 and _rel(ty.numpy(), jy) <= SAME


@pytest.mark.parametrize("policy", POLICIES)
def test_residual_and_cost_in_storage(policy):
    """``residual8`` stays in the storage dtype (the model rounded to it
    first) and ``weighted_cost`` sums in float32, as in the JAX
    package."""
    x8, coh, s1, s2, cid, nb, wt, J = _assembly_inputs(2, 80, irls=True)
    (jx8, jwt, jcoh, js1, js2, jcid, jJ), (tx8, twt, tcoh, ts1, ts2, tcid,
                                            tJ) = _both_sides(
        policy, x8, wt, coh, s1, s2, cid, J)
    r = tne.residual8(tx8, tJ, tcoh, ts1, ts2, tcid)
    assert r.dtype == TST[policy]
    np.testing.assert_array_equal(
        r.float().numpy(),
        np.asarray(jne.residual8(jx8, jJ, jcoh, js1, js2, jcid), np.float32))
    c = tne.weighted_cost(tx8, tJ, tcoh, ts1, ts2, tcid, twt, 2)
    assert c.dtype == torch.float32
    assert _rel(c.numpy(), jne.weighted_cost(jx8, jJ, jcoh, js1, js2, jcid,
                                             jwt, 2)) <= SAME
    assert jdt.is_reduced(JST[policy]) and tdt.is_reduced(TST[policy])
