"""Port fused-sweep module (sagecal_tpu_torch/ops/sweep.py) against the
JAX reference in float64: the plain PyTorch sweep against the Pallas
kernel in interpret mode, the station aggregation, and the damped
block solve with its boosted-jitter retry. Tolerances are those of
tests/test_sweep_pallas.py (atol 5e-9 of the largest Gram entry on the
blocks, rtol 1e-9 on the cost): the same sums in another order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.ops import sweep_pallas as swp
from sagecal_tpu.solvers import normal_eq as ne
from sagecal_tpu_torch.ops import sweep as tswp
from sagecal_tpu_torch.solvers import normal_eq as tne


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(N=6, T=4, K=1, seed=0, noise=0.0):
    """The tests/test_sweep_pallas.py _toy problem, as numpy arrays."""
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
    if noise:
        V = V + noise * (rng.normal(size=V.shape)
                         + 1j * rng.normal(size=V.shape))
    x8 = np.stack([V.reshape(B, 4).real, V.reshape(B, 4).imag],
                  -1).reshape(B, 8)
    return x8, coh, sta1, sta2, chunk_id, nbase


def _weights(B, nbase, seed):
    """Uniform, OS-style contiguous zeroing and IRLS-style weights."""
    rng = np.random.default_rng(seed)
    ones = np.ones((B, 8))
    os_wt = ones.copy()
    os_wt[: 2 * nbase] = 0.0
    irls = rng.random((B, 8)) * (rng.random((B, 1)) > 0.1)
    return {"uniform": ones, "os_subset": os_wt, "irls": irls}


def _both(x8, coh, s1, s2, cid, J, wt, cw, nbase, K):
    ref = swp.sweep_blocks(jnp.asarray(x8), jnp.asarray(J), jnp.asarray(coh),
                           jnp.asarray(s1), jnp.asarray(s2),
                           jnp.asarray(cid), jnp.asarray(wt),
                           jnp.asarray(cw), nbase, K, interpret=True)
    t = _t
    got = tswp.sweep_blocks(t(x8), t(J), t(coh), t(s1), t(s2), t(cid),
                            t(wt), t(cw), nbase, K)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _t(a):
    return torch.as_tensor(np.array(a))


CASES = [(K, w) for K in (1, 2, 4) for w in ("uniform", "os_subset", "irls")]


@pytest.mark.parametrize("K,wname", CASES)
def test_sweep_blocks_match_pallas(K, wname):
    x8, coh, s1, s2, cid, nbase = _toy(N=6, T=4, K=K, seed=3 + K,
                                       noise=0.05)
    rng = np.random.default_rng(10 + K)
    J = (rng.normal(size=(K, 6, 2, 2))
         + 1j * rng.normal(size=(K, 6, 2, 2))) * 0.4 + np.eye(2)
    wt = _weights(x8.shape[0], nbase, 5)[wname]
    cw = rng.random(wt.shape)                # cost_wt != wt
    ref, got = _both(x8, coh, s1, s2, cid, J, wt, cw, nbase, K)
    scale = np.abs(ref[0]).max() + 1e-30
    for name, r, g in zip(("pp", "qq", "pq", "jtep", "jteq"), ref, got):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=5e-9 * scale, err_msg=name)
    np.testing.assert_allclose(got[5], ref[5], rtol=1e-9)


@pytest.mark.parametrize("K", [1, 2])
def test_gn_blocks_match_pallas(K):
    x8, coh, s1, s2, cid, nbase = _toy(N=6, T=4, K=K, seed=7)
    rng = np.random.default_rng(8)
    p = rng.normal(size=(K, 6, 8))
    J = np.asarray(ne.jones_r2c(jnp.asarray(p)))
    wt = np.ones((x8.shape[0], 8))
    fac, JTe, cost = swp.gn_blocks(
        jnp.asarray(x8), jnp.asarray(J), jnp.asarray(coh), jnp.asarray(s1),
        jnp.asarray(s2), jnp.asarray(cid), jnp.asarray(wt), 6, K, nbase,
        interpret=True)
    t = _t
    tfac, tJTe, tcost = tswp.gn_blocks(t(x8), t(J), t(coh), t(s1), t(s2),
                                       t(cid), t(wt), 6, K, nbase)
    scale = float(jnp.abs(fac.D).max())
    np.testing.assert_allclose(tfac.D.numpy(), np.asarray(fac.D),
                               atol=5e-9 * scale)
    np.testing.assert_allclose(tJTe.numpy(), np.asarray(JTe),
                               atol=5e-9 * scale)
    np.testing.assert_allclose(tcost.numpy(), np.asarray(cost), rtol=1e-9)
    A = swp._assemble_damped(fac, jnp.full((K,), 0.3), jnp.asarray(s1),
                             jnp.asarray(s2), 6)
    tA = tswp._assemble_damped(tfac, torch.full((K,), 0.3,
                                                dtype=torch.float64),
                               t(s1), t(s2), 6)
    np.testing.assert_allclose(tA.numpy(), np.asarray(A), atol=5e-9 * scale)


def test_station_aggregates_accumulate_repeats():
    """Repeated station indices must accumulate (index_add_), not
    overwrite: a baseline list whose stations repeat."""
    rng = np.random.default_rng(0)
    K, nb, N = 2, 5, 3
    pp = torch.as_tensor(rng.normal(size=(K, nb, 2, 4, 4)))
    qq = torch.as_tensor(rng.normal(size=(K, nb, 2, 4, 4)))
    jp = torch.as_tensor(rng.normal(size=(K, nb, 2, 4)))
    jq = torch.as_tensor(rng.normal(size=(K, nb, 2, 4)))
    s1 = torch.tensor([0, 0, 1, 0, 1])
    s2 = torch.tensor([1, 2, 2, 1, 2])
    D, JTe = tswp._station_aggregates(pp, qq, jp, jq, s1, s2, N)
    Dr, JTer = swp._station_aggregates(
        jnp.asarray(pp.numpy()), jnp.asarray(qq.numpy()),
        jnp.asarray(jp.numpy()), jnp.asarray(jq.numpy()),
        jnp.asarray(s1.numpy()), jnp.asarray(s2.numpy()), N)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dr), rtol=1e-13)
    np.testing.assert_allclose(JTe.numpy(), np.asarray(JTer), rtol=1e-13)


def _fac_pair(K, seed):
    x8, coh, s1, s2, cid, nbase = _toy(N=6, T=5, K=K, seed=seed,
                                       noise=0.05)
    J = np.tile(np.eye(2, dtype=complex), (K, 6, 1, 1))
    wt = np.ones((x8.shape[0], 8))
    fac, JTe, _ = swp.gn_blocks(
        jnp.asarray(x8), jnp.asarray(J), jnp.asarray(coh), jnp.asarray(s1),
        jnp.asarray(s2), jnp.asarray(cid), jnp.asarray(wt), 6, K, nbase,
        interpret=True)
    t = _t
    tfac, tJTe, _ = tswp.gn_blocks(t(x8), t(J), t(coh), t(s1), t(s2),
                                   t(cid), t(wt), 6, K, nbase)
    return fac, JTe, tfac, tJTe, s1, s2


@pytest.mark.parametrize("K", [1, 2])
def test_solve_damped_blocks_matches(K):
    fac, JTe, tfac, tJTe, s1, s2 = _fac_pair(K, 12)
    mu = np.linspace(0.1, 0.5, K)
    dp, ok = swp.solve_damped_blocks(fac, JTe, jnp.asarray(mu), 1e-9,
                                     jnp.asarray(s1), jnp.asarray(s2), 6)
    tdp, tok = tswp.solve_damped_blocks(tfac, tJTe, torch.as_tensor(mu),
                                        1e-9, torch.as_tensor(s1),
                                        torch.as_tensor(s2), 6)
    assert tok.numpy().tolist() == np.asarray(ok).tolist() == [True] * K
    np.testing.assert_allclose(tdp.numpy(), np.asarray(dp),
                               rtol=1e-7, atol=1e-9 * np.abs(dp).max())


def test_solve_damped_blocks_retry_branch():
    """An indefinite damped system (negative shift on chunk 0) fails the
    first factorization; the boosted-jitter retry recovers it, chunk 1
    solves first time — in both packages, chunk for chunk."""
    K = 2
    fac, JTe, tfac, tJTe, s1, s2 = _fac_pair(K, 13)
    A = np.asarray(swp._assemble_damped(fac, None, jnp.asarray(s1),
                                        jnp.asarray(s2), 6))
    lam = np.linalg.eigvalsh(A)[:, 0]
    dd = np.abs(np.diagonal(np.asarray(fac.D), axis1=-2, axis2=-1))
    dmax = dd.reshape(K, -1).max(axis=-1)
    mu = np.array([-lam[0] - 0.5e-3 * dmax[0], 0.2])
    dp, ok = swp.solve_damped_blocks(fac, JTe, jnp.asarray(mu), 1e-9,
                                     jnp.asarray(s1), jnp.asarray(s2), 6)
    _, ok1 = swp.chol_solve_blocks_shift(fac, JTe, jnp.asarray(mu) + 1e-9,
                                         jnp.asarray(s1), jnp.asarray(s2), 6)
    assert np.asarray(ok1).tolist() == [False, True]   # retry is exercised
    tdp, tok = tswp.solve_damped_blocks(tfac, tJTe, torch.as_tensor(mu),
                                        1e-9, torch.as_tensor(s1),
                                        torch.as_tensor(s2), 6)
    assert tok.numpy().tolist() == np.asarray(ok).tolist() == [True, True]
    np.testing.assert_allclose(tdp.numpy(), np.asarray(dp), rtol=1e-6,
                               atol=1e-8 * np.abs(dp).max())


def test_unported_modes_raise():
    """Every Jones mode of the JAX package runs (diag and phase give md =
    2 and 1 blocks); a mode it does not have raises."""
    x8, coh, s1, s2, cid, nbase = _toy()
    t = _t
    args = (t(x8), t(np.ones((1, 6, 2, 2), complex)), t(coh), t(s1), t(s2),
            t(cid), t(np.ones((60, 8))), t(np.ones((60, 8))), nbase, 1)
    for jones, md in (("full", 4), ("diag", 2), ("phase", 1)):
        assert tswp.sweep_blocks(*args, jones=jones)[0].shape[-1] == md
    with pytest.raises(ValueError, match="jones"):
        tswp.sweep_blocks(*args, jones="polar")
    with pytest.raises(ValueError, match="jones"):
        tswp.sweep_blocks_visits(*args, 1, jones="polar")


MODE_CASES = [(jones, K) for jones in ("diag", "phase") for K in (1, 3)]


def _mode_inputs(K, seed):
    """The _toy rows with IRLS-style weights, a separate cost weight and a
    Jones whose off-diagonals are not zero."""
    x8, coh, s1, s2, cid, nbase = _toy(N=6, T=4, K=K, seed=seed, noise=0.05)
    rng = np.random.default_rng(seed + 100)
    J = (rng.normal(size=(K, 6, 2, 2))
         + 1j * rng.normal(size=(K, 6, 2, 2))) * 0.4 + np.eye(2)
    wt = _weights(x8.shape[0], nbase, seed)["irls"]
    cw = rng.random(wt.shape)
    return x8, J, coh, s1, s2, cid, wt, cw, nbase


@pytest.mark.parametrize("jones,K", MODE_CASES)
def test_sweep_blocks_modes_match_pallas(jones, K):
    """The diag (md = 2) and phase (md = 1) sweep against the reference's
    sweep_blocks(jones=) in interpret mode, at one chunk and three, on a
    J whose off-diagonals are not zero: both constrain it on entry, so
    the port gives the same bits on the constrained J."""
    x8, J, coh, s1, s2, cid, wt, cw, nbase = _mode_inputs(K, 30 + K)
    md = tne.jones_mdim(jones)
    ref = swp.sweep_blocks(*(jnp.asarray(a) for a in (x8, J, coh, s1, s2,
                                                       cid, wt, cw)),
                           nbase, K, interpret=True, jones=jones)
    got = tswp.sweep_blocks(*(_t(a) for a in (x8, J, coh, s1, s2, cid, wt,
                                              cw)), nbase, K, jones=jones)
    scale = np.abs(np.asarray(ref[0])).max() + 1e-30
    for name, r, g in zip(("pp", "qq", "pq", "jtep", "jteq"), ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape and g.shape[-1] == md, name
        np.testing.assert_allclose(g.numpy(), r, atol=5e-9 * scale,
                                   err_msg=name)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]),
                               rtol=1e-9)
    Jc = J * np.eye(2)
    again = tswp.sweep_blocks(*(_t(a) for a in (x8, Jc, coh, s1, s2, cid,
                                                wt, cw)), nbase, K,
                              jones=jones)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("jones", ["diag", "phase"])
def test_mode_blocks_solve_and_matvec_match_pallas(jones):
    """At md = 2 and 1, from the sweep's blocks (K = 2): the station
    aggregates (D, JTe) and cost of gn_blocks, the damped dense
    assembly, the damped block solve and its factor-and-solve, the blocks
    matvec and the station-block preconditioner against the reference."""
    from sagecal_tpu.solvers import normal_eq as jne
    K, N = 2, 6
    x8, J, coh, s1, s2, cid, wt, cw, nbase = _mode_inputs(K, 40)
    md = tne.jones_mdim(jones)
    fac, JTe, cost = swp.gn_blocks(
        *(jnp.asarray(a) for a in (x8, J, coh, s1, s2, cid, wt)), N, K,
        nbase, cost_wt=jnp.asarray(cw), interpret=True, jones=jones)
    tfac, tJTe, tcost = tswp.gn_blocks(
        *(_t(a) for a in (x8, J, coh, s1, s2, cid, wt)), N, K, nbase,
        cost_wt=_t(cw), jones=jones)
    scale = float(jnp.abs(fac.D).max())
    assert tfac.D.shape == (K, N, 2, md, md)
    for a, b in ((tfac.D, fac.D), (tJTe, JTe)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=5e-9 * scale)
    np.testing.assert_allclose(tcost.numpy(), np.asarray(cost), rtol=1e-9)
    shift = np.array([0.3, 0.05])
    A = swp._assemble_damped(fac, jnp.asarray(shift), jnp.asarray(s1),
                             jnp.asarray(s2), N)
    tA = tswp._assemble_damped(tfac, _t(shift), _t(s1), _t(s2), N)
    assert tA.shape == (K, 2 * md * N, 2 * md * N)
    np.testing.assert_allclose(tA.numpy(), np.asarray(A), atol=5e-9 * scale)
    dp, ok = swp.solve_damped_blocks(fac, JTe, jnp.asarray(shift), 1e-9,
                                     jnp.asarray(s1), jnp.asarray(s2), N)
    tdp, tok = tswp.solve_damped_blocks(tfac, tJTe, _t(shift), 1e-9, _t(s1),
                                        _t(s2), N)
    _, tok1 = tswp.chol_solve_blocks_shift(tfac, tJTe, _t(shift) + 1e-9,
                                           _t(s1), _t(s2), N)
    assert tok.tolist() == tok1.tolist() == np.asarray(ok).tolist() \
        == [True] * K
    np.testing.assert_allclose(tdp.numpy(), np.asarray(dp), rtol=1e-7,
                               atol=1e-9 * np.abs(np.asarray(dp)).max())
    v = np.random.default_rng(41).normal(size=(K, 2 * md * N))
    y = swp.gn_matvec_blocks(fac, jnp.asarray(v), jnp.asarray(s1),
                             jnp.asarray(s2), N, shift=jnp.asarray(shift),
                             interpret=True)
    ty = tswp.gn_matvec_blocks_plain(tfac, _t(v), _t(s1[:nbase]).long(),
                                     _t(s2[:nbase]).long(), N,
                                     shift=_t(shift))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y),
                               atol=1e-10 * np.abs(np.asarray(y)).max())
    L = jne.gn_precond_factor(fac.D, jnp.asarray(shift))
    tL = tne.gn_precond_factor(tfac.D, _t(shift))
    np.testing.assert_allclose(tL.numpy(), np.tril(np.asarray(L[0])),
                               atol=5e-9 * np.abs(np.asarray(L[0])).max())
    z = jne.gn_precond_apply(L, jnp.asarray(v), K, N)
    tz = tne.gn_precond_apply(tL, _t(v), K, N)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z),
                               atol=1e-9 * np.abs(np.asarray(z)).max())



def _chunk_ids(T, nb, K, nchunk):
    """Row chunk ids of a cluster with ``nchunk`` hybrid chunks solved
    with kmax = K (``predict.chunk_indices``): chunks nchunk .. K - 1, and
    any that the timeslots do not reach, have no rows."""
    tilechunk = -(-T // nchunk)
    return np.minimum((np.arange(T * nb) // nb) // tilechunk, nchunk - 1)


GEOMETRY = [(T, nb, K) for T in (1, 5, 120) for nb in (1, 7, 1891)
            for K in (1, 2, 3, 4)]


@pytest.mark.parametrize("V", [1, 2, 4])
@pytest.mark.parametrize("T,nb,K", GEOMETRY)
def test_sweep_geometry_covers_rows_once(T, nb, K, V):
    """The sweep kernel's launch geometry for V visits, which the wrapper
    passes to the kernel, replayed block by block in the kernel's grid
    order (rank fastest, then visit, then tile): every row of every
    visit is walked by exactly one (cluster, block, lane) and added to
    the sums of its own visit and chunk only (every row to chunk 0 at K
    = 1), whatever chunks are empty; every word of every (visit, tile)'s
    records is written by exactly one block of its cluster. At V = 1 the
    cluster is the largest with which every block runs in the first
    wave, where one exists."""
    for slots, nchunk in ((660, K), (396, 1), (8, max(1, K - 1))):
        geo = tswp.sweep_geometry(T, nb, K, slots, V)
        C = geo.cluster
        assert 1 <= C <= tswp.MAX_CLUSTER and C <= T
        assert len(geo.times) == C + 1 and geo.times[0] == 0
        assert geo.times[-1] == T and all(len(w) == C + 1 for w in geo.words)
        assert geo.rec % 4 == 0 and geo.rec >= tswp.N_OUT
        if V == 1 and slots >= geo.tiles:
            first = min(tswp.MAX_CLUSTER, T, slots // geo.tiles)
            assert C == -(-T // -(-T // first))
        # the C arrays the launch passes to the kernel hold this geometry
        g2, tb, wb = tswp._geometry_args(T, nb, K, slots, V)
        row = tswp.MAX_CLUSTER + 1
        assert g2 == geo and tuple(tb)[:C + 1] == geo.times
        assert (tuple(wb)[:C + 1], tuple(wb)[row:row + C + 1]) == geo.words
        # visit v has its own chunk ids (a cluster of nchunk - v chunks)
        cid = np.stack([_chunk_ids(T, nb, K, max(1, nchunk - v)).reshape(
            T, nb) for v in range(V)])
        walked = np.zeros((V, T, nb), dtype=int)
        sums = np.zeros((V, K, nb), dtype=int)
        covered = np.zeros((V, geo.tiles, K * tswp.SWEEP_TILE * geo.rec),
                           dtype=int)
        for block in range(C * V * geo.tiles):
            rank, v, tile = block % C, block // C % V, block // (C * V)
            b0 = tile * tswp.SWEEP_TILE
            b1 = min(nb, b0 + tswp.SWEEP_TILE)
            words = geo.words[tile == geo.tiles - 1]
            t0, t1 = geo.times[rank], geo.times[rank + 1]
            assert t0 < t1
            walked[v, t0:t1, b0:b1] += 1
            c = cid[v, t0:t1, b0:b1] if K > 1 else np.zeros(
                (t1 - t0, b1 - b0), int)
            for k in range(K):
                sums[v, k, b0:b1] += (c == k).sum(axis=0)
            covered[v, tile, words[rank]:words[rank + 1]] += 1
        assert (walked == 1).all()
        for tile in range(geo.tiles):
            nbt = min(nb, (tile + 1) * tswp.SWEEP_TILE) \
                - tile * tswp.SWEEP_TILE
            n = K * nbt * geo.rec
            assert (covered[:, tile, :n] == 1).all()
            assert (covered[:, tile, n:] == 0).all()
        want = np.stack([[(cid[v] == k).sum(axis=0) for k in range(K)]
                         for v in range(V)]) \
            if K > 1 else np.full((V, 1, nb), T)
        np.testing.assert_array_equal(sums, want)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_sweep_geometry_takes_a_given_cluster(cluster):
    """A cluster size given to sweep_geometry (as the cluster-timing tool
    gives it) replaces the rule's choice, capped by T, and its time
    ranges still cover every timeslot once."""
    for T in (1, 5, 120):
        geo = tswp.sweep_geometry(T, 1891, 4, 396, 4, cluster=cluster)
        assert geo.cluster <= min(cluster, T)
        assert geo.cluster == -(-T // -(-T // min(cluster, T)))
        assert geo.times[0] == 0 and geo.times[-1] == T
        assert all(a < b for a, b in zip(geo.times, geo.times[1:]))


@pytest.mark.parametrize("md", [2, 1])
def test_sweep_geometry_modes_cover_words_once(md):
    """At md = 2 and 1 the records are REC_WORDS[md] words (the caller
    layout's n_out(md) padded to a multiple of md) and the geometry's word
    bounds cover every word of each tile's records once, as the kernel
    checks at launch; the time ranges do not depend on md."""
    rec = tswp.REC_WORDS[md]
    assert rec >= tswp.n_out(md) and rec % md == 0 and rec % 4 == 0
    for T, nb, K, V in ((5, 7, 2, 1), (120, 1891, 4, 4), (1, 1, 1, 2)):
        geo = tswp.sweep_geometry(T, nb, K, 396, V, md=md)
        assert geo.rec == rec
        assert geo.times == tswp.sweep_geometry(T, nb, K, 396, V).times
        g2, tb, wb = tswp._geometry_args(T, nb, K, 396, V, md)
        row = tswp.MAX_CLUSTER + 1
        assert g2 == geo and tuple(tb)[:geo.cluster + 1] == geo.times
        assert tuple(wb)[row:row + geo.cluster + 1] == geo.words[1]
        for last, words in enumerate(geo.words):
            nbt = nb - tswp.SWEEP_TILE * (geo.tiles - 1) if last \
                else min(tswp.SWEEP_TILE, nb)
            assert words[0] == 0 and words[-1] == K * nbt * rec
            assert all(a <= b for a, b in zip(words, words[1:]))


@pytest.mark.parametrize("jones", ["diag", "phase"])
def test_mode_records_match_packed_layout(jones):
    """At md = 2 and 1 the card's records (REC_WORDS[md] apart) and the
    packed caller layout (n_out(md)) hold the same blocks: record_views,
    the station aggregates and the matvec's block views agree, and the
    records are read in place (each block row of md words on 4 md
    bytes)."""
    K, N, T = 2, 6, 4
    x8, J, coh, s1, s2, cid, wt, cw, nbase = _mode_inputs(K, 50)
    md = tne.jones_mdim(jones)
    got = tswp.sweep_blocks(*(_t(a) for a in (x8, J, coh, s1, s2, cid, wt,
                                              cw)), nbase, K, jones=jones)
    views = {}
    for R in (tswp.n_out(md), tswp.REC_WORDS[md]):
        out = torch.zeros((K, nbase, R), dtype=torch.float64)
        for (o, shp, _), g in zip(tswp.rec_parts(md), got[:5]):
            out[..., o:o + int(np.prod(shp))] = g.reshape(K, nbase, -1)
        views[R] = tswp.record_views(out, md)
        for g, v in zip(got[:5], views[R]):
            assert v.shape == g.shape and torch.equal(v, g)
    b1, b2 = _t(s1[:nbase]).long(), _t(s2[:nbase]).long()
    al = views[tswp.REC_WORDS[md]]
    D, JTe = tswp._station_aggregates(al[0], al[1], al[3], al[4], b1, b2, N)
    fac = tswp.gn_blocks(*(_t(a) for a in (x8, J, coh, s1, s2, cid, wt)), N,
                         K, nbase, jones=jones)[0]
    assert torch.equal(fac.D, D) and JTe.shape == (K, 2 * md * N)
    for blk in range(3):
        ta, sa = tswp._block_view(al[blk], nbase)
        assert ta is al[blk] and sa == tswp.REC_WORDS[md]


def test_aligned_records_match_packed_layout():
    """The card's records (REC words a baseline) and the packed 145-word
    caller layout hold the same blocks: record_views, the station
    aggregates, the Gram blocks and the matvec's block views agree."""
    K, N, T = 2, 6, 4
    x8, coh, s1, s2, cid, nbase = _toy(N=N, T=T, K=K, seed=21, noise=0.05)
    rng = np.random.default_rng(22)
    J = (rng.normal(size=(K, N, 2, 2))
         + 1j * rng.normal(size=(K, N, 2, 2))) * 0.3 + np.eye(2)
    t = _t
    wt = t(rng.random((x8.shape[0], 8)))
    got = tswp.sweep_blocks(t(x8), t(J), t(coh), t(s1), t(s2), t(cid), wt,
                            wt, nbase, K)
    views = {}
    for R in (tswp.N_OUT, tswp.REC):
        out = torch.zeros((K, nbase, R), dtype=torch.float64)
        for (o, shp, _), g in zip(tswp.REC_PARTS, got[:5]):
            out[..., o:o + int(np.prod(shp))] = g.reshape(K, nbase, -1)
        views[R] = tswp.record_views(out)
        for g, v in zip(got[:5], views[R]):
            assert v.shape == g.shape and torch.equal(v, g)
    b1, b2 = t(s1[:nbase]).long(), t(s2[:nbase]).long()
    pk, al = views[tswp.N_OUT], views[tswp.REC]
    D0, JTe0 = tswp._station_aggregates(pk[0], pk[1], pk[3], pk[4], b1, b2,
                                        N)
    D1, JTe1 = tswp._station_aggregates(al[0], al[1], al[3], al[4], b1, b2,
                                        N)
    assert torch.equal(D0, D1) and torch.equal(JTe0, JTe1)
    fac = tswp.gn_blocks(t(x8), t(J), t(coh), t(s1), t(s2), t(cid), wt, N,
                         K, nbase)[0]
    assert torch.equal(fac.D, D1)
    for blk in range(3):
        tp, sp = tswp._block_view(pk[blk], nbase)
        ta, sa = tswp._block_view(al[blk], nbase)
        assert ta is al[blk] and sa == tswp.REC
        assert tp is not pk[blk] and sp == int(np.prod(pk[blk].shape[2:]))
        assert torch.equal(tp, ta)
