"""Port blocks matvec, dense fused operator and PCG preconditioner
(sagecal_tpu_torch/ops/sweep.py, solvers/normal_eq.py) against the JAX
reference in float64: ``gn_matvec_blocks_plain`` against the Pallas
``_matvec_kernel`` in interpret mode, with and without a shift, K in
{1, 2} and on a baseline list whose stations repeat (rtol 1e-10 of the
largest element: the same sums in another order), the preconditioner
pair and ``normal_equations_fused`` likewise. The station lists and the
warps' runs of them that the CUDA kernel walks are checked here by a
PyTorch replica of its walk; the per-blocks plan by its checks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.ops import sweep_pallas as swp
from sagecal_tpu.solvers import normal_eq as ne
from sagecal_tpu_torch.ops import sweep as tswp
from sagecal_tpu_torch.solvers import normal_eq as tne

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _blocks(K, nb, N, seed, s1=None, s2=None, md=4):
    """Random symmetric-diagonal Gram blocks of width md and their
    station sums, as (JAX GNBlocks, port GNBlocks, s1, s2)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(K, nb, 2, md, md))
    pp = a @ np.swapaxes(a, -1, -2)
    b = rng.normal(size=(K, nb, 2, md, md))
    qq = b @ np.swapaxes(b, -1, -2)
    pq = rng.normal(size=(K, nb, 2, 2, md, md))
    if s1 is None:
        p, q = np.triu_indices(N, k=1)
        s1, s2 = p[:nb], q[:nb]
    s1, s2 = np.asarray(s1, np.int32), np.asarray(s2, np.int32)
    D = np.zeros((K, N, 2, md, md))
    np.add.at(D, (slice(None), s1), pp)
    np.add.at(D, (slice(None), s2), qq)
    jf = swp.GNBlocks(pp=jnp.asarray(pp), qq=jnp.asarray(qq),
                      pq=jnp.asarray(pq), D=jnp.asarray(D))
    tf = tswp.GNBlocks(*(torch.as_tensor(x) for x in (pp, qq, pq, D)))
    return jf, tf, s1, s2


CASES = [(K, shifted) for K in (1, 2) for shifted in (False, True)]


@pytest.mark.parametrize("K,shifted", CASES)
def test_matvec_plain_matches_pallas(K, shifted):
    N = 7
    nb = N * (N - 1) // 2
    jf, tf, s1, s2 = _blocks(K, nb, N, seed=K)
    v = np.random.default_rng(10 + K).normal(size=(K, 8 * N))
    shift = np.linspace(0.3, 0.7, K) if shifted else None
    want = swp.gn_matvec_blocks(
        jf, jnp.asarray(v), jnp.asarray(s1), jnp.asarray(s2), N,
        shift=None if shift is None else jnp.asarray(shift), interpret=True)
    got = tswp.gn_matvec_blocks(
        tf, torch.as_tensor(v), torch.as_tensor(s1), torch.as_tensor(s2), N,
        shift=None if shift is None else torch.as_tensor(shift))
    assert got.shape == (K, 8 * N)
    _close(got.numpy(), want)


@pytest.mark.parametrize("md", [2, 1])
@pytest.mark.parametrize("shifted", [False, True])
def test_matvec_modes_match_pallas(md, shifted):
    """The blocks matvec at md = 2 (diag) and 1 (phase), K = 2, against
    the reference's gn_matvec_blocks (its kernel reads md off the block
    shapes) in interpret mode, and the kernel's walk of the station lists
    replayed at md."""
    N, K = 7, 2
    nb = N * (N - 1) // 2
    jf, tf, s1, s2 = _blocks(K, nb, N, seed=60 + md, md=md)
    v = np.random.default_rng(61 + md).normal(size=(K, 2 * md * N))
    shift = np.array([0.3, 0.7]) if shifted else None
    want = swp.gn_matvec_blocks(
        jf, jnp.asarray(v), jnp.asarray(s1), jnp.asarray(s2), N,
        shift=None if shift is None else jnp.asarray(shift), interpret=True)
    t1, t2 = torch.as_tensor(s1), torch.as_tensor(s2)
    sh = None if shift is None else torch.as_tensor(shift)
    lists = tswp.station_lists(t1, t2, nb, N)
    got = tswp.gn_matvec_blocks(tf, torch.as_tensor(v), t1, t2, N, shift=sh,
                                lists=lists)
    assert got.shape == (K, 2 * md * N)
    _close(got.numpy(), want)
    zero = torch.zeros(K, dtype=torch.float64)
    _close(_kernel_replica(tf, torch.as_tensor(v), lists,
                           zero if sh is None else sh, K, N).numpy(), want)


@pytest.mark.parametrize("md", [2, 1])
def test_precond_pair_modes_match_reference(md):
    """The station-block preconditioner on [2, md, md] blocks."""
    N, K = 6, 2
    rng = np.random.default_rng(70 + md)
    a = rng.normal(size=(K, N, 2, md, md))
    D = a @ np.swapaxes(a, -1, -2)
    shift = np.array([0.01, 0.1])
    r = rng.normal(size=(K, 2 * md * N))
    Lj = ne.gn_precond_factor(jnp.asarray(D), jnp.asarray(shift))
    Lt = tne.gn_precond_factor(torch.as_tensor(D), torch.as_tensor(shift))
    _close(Lt.numpy(), np.tril(np.asarray(Lj[0])))
    _close(tne.gn_precond_apply(Lt, torch.as_tensor(r), K, N).numpy(),
           ne.gn_precond_apply(Lj, jnp.asarray(r), K, N))


def test_matvec_repeated_stations_match_pallas():
    """Stations repeat across baselines (and rows tile the baseline
    period): the per-station sums accumulate every product."""
    N, K = 3, 2
    s1, s2 = [0, 0, 1, 0, 1], [1, 2, 2, 1, 2]
    jf, tf, s1, s2 = _blocks(K, 5, N, seed=4, s1=s1, s2=s2)
    v = np.random.default_rng(5).normal(size=(K, 8 * N))
    rows1, rows2 = np.tile(s1, 3), np.tile(s2, 3)     # [T = 3, nb]
    want = swp.gn_matvec_blocks(jf, jnp.asarray(v), jnp.asarray(rows1),
                                jnp.asarray(rows2), N,
                                shift=jnp.asarray([0.1, 0.2]),
                                interpret=True)
    got = tswp.gn_matvec_blocks(tf, torch.as_tensor(v),
                                torch.as_tensor(rows1),
                                torch.as_tensor(rows2), N,
                                shift=torch.tensor([0.1, 0.2],
                                                   dtype=torch.float64))
    _close(got.numpy(), want)


@pytest.mark.parametrize("K", [1, 2])
def test_matvec_is_the_dense_operator(K):
    """The blocks matvec applies exactly the matrix _assemble_damped
    builds from the same blocks."""
    N = 6
    nb = N * (N - 1) // 2
    _, tf, s1, s2 = _blocks(K, nb, N, seed=20 + K)
    shift = torch.linspace(0.2, 0.4, K, dtype=torch.float64)
    v = torch.as_tensor(np.random.default_rng(K).normal(size=(K, 8 * N)))
    t1, t2 = torch.as_tensor(s1), torch.as_tensor(s2)
    A = tswp._assemble_damped(tf, shift, t1, t2, N)
    _close(tswp.gn_matvec_blocks(tf, v, t1, t2, N, shift=shift).numpy(),
           torch.einsum("kij,kj->ki", A, v).numpy())


def _kernel_replica(fac, v, lists, shift, K, N):
    """The CUDA kernel's walk in PyTorch at the blocks' width md: per
    (chunk, station) each warp of the block takes its run of the station's
    (baseline, side) entries (``lists.runs``, which the kernel reads as
    given), applies the side's diagonal block to the station's own v and
    the pq block (or its transpose) to the other station's v, and the
    warps' sums are added in order, then shift v."""
    s1, s2, _, ent, runs = lists
    md = fac.pp.shape[-1]
    vr = v.reshape(K, N, 2, md)
    y = torch.zeros((K, N, 2, md), dtype=v.dtype)
    for n in range(N):
        for w0, w1 in runs[n].tolist():
            part = torch.zeros((K, 2, md), dtype=v.dtype)
            for e in ent[w0:w1].tolist():
                b, side = e // 2, e % 2
                if side == 0:
                    vo = vr[:, int(s2[b])]
                    part += (torch.einsum("kaij,kaj->kai", fac.pp[:, b],
                                          vr[:, n])
                             + torch.einsum("kaoij,koj->kai", fac.pq[:, b],
                                            vo))
                else:
                    vo = vr[:, int(s1[b])]
                    part += (torch.einsum("koji,koi->koj", fac.qq[:, b],
                                          vr[:, n])
                             + torch.einsum("kaoij,kai->koj", fac.pq[:, b],
                                            vo))
            y[:, n] += part
    return y.reshape(K, 2 * md * N) + shift[:, None] * v


@pytest.mark.parametrize("repeat", [False, True])
def test_station_lists_drive_the_kernel_gather(repeat):
    """ptr/ent list every (baseline, side) once, grouped by station in
    ascending order, and the kernel's per-station walk replayed on them
    gives the plain matvec."""
    N, K = 5, 2
    s1, s2 = ([0, 0, 1, 0, 3], [1, 2, 2, 1, 4]) if repeat else (None, None)
    nb = 5 if repeat else N * (N - 1) // 2
    _, tf, s1, s2 = _blocks(K, nb, N, seed=30, s1=s1, s2=s2)
    t1, t2 = torch.as_tensor(s1), torch.as_tensor(s2)
    lists = tswp.station_lists(t1, t2, nb, N)
    l1, l2, ptr, ent, runs = lists
    # a pure function of the layout: a second build is the same
    assert all(torch.equal(a, b) for a, b in
               zip(lists, tswp.station_lists(t1.clone(), t2.clone(), nb, N)))
    assert l1.dtype == ptr.dtype == ent.dtype == runs.dtype == torch.int32
    assert int(ptr[-1]) == 2 * nb and sorted(ent.tolist()) == list(
        range(2 * nb))
    for n in range(N):
        e = ent[ptr[n]:ptr[n + 1]].tolist()
        assert e == sorted(e, key=lambda x: (x % 2, x // 2))
        assert all((s1 if x % 2 == 0 else s2)[x // 2] == n for x in e)
    v = torch.as_tensor(np.random.default_rng(3).normal(size=(K, 8 * N)))
    shift = torch.tensor([0.5, 0.25], dtype=torch.float64)
    _close(_kernel_replica(tf, v, lists, shift, K, N).numpy(),
           tswp.gn_matvec_blocks(tf, v, t1, t2, N, shift=shift,
                                 lists=lists).numpy())


def test_block_view_keeps_sweep_output_strides():
    """The kernel reads the sweep's [K, nb, REC] records in place; a
    layout whose rows are not on 16 bytes (the 145-word caller layout)
    is copied once."""
    K, nb = 2, 9
    out = torch.zeros((K, nb, tswp.REC))
    pp = out[..., 0:32].view(K, nb, 2, 4, 4)
    pq = out[..., 64:128].view(K, nb, 2, 2, 4, 4)
    for blk in (pp, pq):
        t, stride = tswp._block_view(blk, nb)
        assert t is blk and stride == tswp.REC
    t, stride = tswp._block_view(pp.transpose(-1, -2), nb)
    assert t.is_contiguous() and stride == 32
    packed = torch.zeros((K, nb, tswp.N_OUT))
    t, stride = tswp._block_view(packed[..., 64:128].view(K, nb, 2, 2, 4, 4),
                                 nb)
    assert t.is_contiguous() and stride == 64
    # md = 2: rows of 2 words need 8 bytes; the 41-word packed layout's
    # odd stride is copied, the 44-word records are read in place
    for R, kept in ((tswp.REC_WORDS[2], True), (tswp.n_out(2), False)):
        out = torch.zeros((K, nb, R))
        pq = tswp.record_views(out, 2)[2]
        t, stride = tswp._block_view(pq, nb)
        assert (t is pq) == kept and stride == (R if kept else 16)


def _layouts(N):
    """Baseline layouts with nb in {1, 7, 1891}: one baseline, a list
    whose stations repeat, and the full-width array."""
    if N == 2:
        return [0], [1]
    if N == 4:
        return [0, 0, 1, 0, 2, 1, 3], [1, 2, 2, 3, 3, 3, 0]
    p, q = np.triu_indices(N, k=1)
    return p.tolist(), q.tolist()


@pytest.mark.parametrize("N", [2, 4, 62])
def test_matvec_runs_cover_each_entry_once(N):
    """The kernel's launch geometry: one block per (station, chunk), and
    the warps' runs of a station's entries cover each entry of the
    station lists exactly once, within the station's own range. The
    station lists carry the runs the kernel reads."""
    s1, s2 = _layouts(N)
    nb = len(s1)
    lists = tswp.station_lists(torch.tensor(s1), torch.tensor(s2), nb, N)
    ptr = lists.ptr.long()
    assert torch.equal(lists.runs.long(), tswp.matvec_runs(ptr))
    for warps in (1, 3, tswp.MATVEC_WARPS):
        runs = tswp.matvec_runs(ptr, warps)
        assert runs.shape == (N, warps, 2)
        seen = np.zeros(2 * nb, dtype=int)
        for n in range(N):
            for w0, w1 in runs[n].tolist():
                assert ptr[n] <= w0 <= w1 <= ptr[n + 1]
                seen[w0:w1] += 1
        assert (seen == 1).all()


def _fac_cpu(K=2, N=6, seed=60):
    _, tf, s1, s2 = _blocks(K, N * (N - 1) // 2, N, seed=seed)
    return tf, torch.as_tensor(s1), torch.as_tensor(s2)


def test_matvec_plan_is_the_product():
    """A plan built once and applied to several vectors gives the
    one-call product each time (the solvers' PCG and tCG loops)."""
    tf, t1, t2 = _fac_cpu()
    N, K = 6, 2
    shift = torch.tensor([0.3, 0.6], dtype=torch.float64)
    lists = tswp.station_lists(t1, t2, 15, N)
    plan = tswp.matvec_plan(tf, t1, t2, N, shift=shift, lists=lists)
    rng = np.random.default_rng(1)
    for _ in range(3):
        v = torch.as_tensor(rng.normal(size=(K, 8 * N)))
        _close(tswp.matvec_apply(plan, v).numpy(),
               tswp.gn_matvec_blocks(tf, v, t1, t2, N, shift=shift).numpy())


def test_matvec_plan_rejects_mismatches():
    """The per-blocks plan raises on station lists of another layout, on
    blocks of mixed dtypes and on blocks or shifts of mismatched shapes."""
    tf, t1, t2 = _fac_cpu()
    N = 6
    with pytest.raises(ValueError):
        tswp.matvec_plan(tf, t1, t2, N,
                         lists=tswp.station_lists(t1, t2, 14, N))
    with pytest.raises(ValueError):
        tswp.matvec_plan(tf, t1, t2, N,
                         lists=tswp.station_lists(t1, t2, 15, N + 1))
    lists = tswp.station_lists(t1, t2, 15, N)
    with pytest.raises(TypeError):
        tswp.matvec_plan(tf, t1, t2, N, lists=tswp.StationLists(
            *(t.long() for t in lists)))
    with pytest.raises(ValueError):
        tswp.matvec_plan(tf, t1, t2, N, lists=lists._replace(
            runs=tswp.matvec_runs(lists.ptr, 3).int()))
    with pytest.raises(TypeError):
        tswp.matvec_plan(tf._replace(pq=tf.pq.float()), t1, t2, N)
    with pytest.raises(ValueError):
        tswp.matvec_plan(tf._replace(qq=tf.qq[:, :-1]), t1, t2, N)
    with pytest.raises(ValueError):
        tswp.matvec_plan(tf._replace(pq=tf.pq[..., :2]), t1, t2, N)
    with pytest.raises(ValueError):
        tswp.matvec_plan(tf, t1, t2, N, shift=torch.ones(3))


@pytest.mark.parametrize("K", [1, 2])
def test_precond_pair_matches_reference(K):
    N = 6
    rng = np.random.default_rng(40 + K)
    a = rng.normal(size=(K, N, 2, 4, 4))
    D = a @ np.swapaxes(a, -1, -2)
    shift = np.linspace(0.01, 0.1, K)
    r = rng.normal(size=(K, 8 * N))
    Lj = ne.gn_precond_factor(jnp.asarray(D), jnp.asarray(shift))
    Lt = tne.gn_precond_factor(torch.as_tensor(D), torch.as_tensor(shift))
    _close(Lt.numpy(), np.tril(np.asarray(Lj[0])))
    _close(tne.gn_precond_apply(Lt, torch.as_tensor(r), K, N).numpy(),
           ne.gn_precond_apply(Lj, jnp.asarray(r), K, N))


@pytest.mark.parametrize("K", [1, 2])
def test_normal_equations_fused_matches_pallas(K):
    from test_torch_sweep import _toy
    x8, coh, s1, s2, cid, nbase = _toy(N=6, T=4, K=K, seed=50 + K,
                                       noise=0.05)
    rng = np.random.default_rng(K)
    J = (rng.normal(size=(K, 6, 2, 2))
         + 1j * rng.normal(size=(K, 6, 2, 2))) * 0.3 + np.eye(2)
    wt = rng.random((x8.shape[0], 8))
    A, JTe, cost = swp.normal_equations_fused(
        *(jnp.asarray(a) for a in (x8, J, coh, s1, s2, cid, wt)), 6, K,
        nbase, interpret=True)
    tA, tJTe, tcost = tswp.normal_equations_fused(
        *(torch.as_tensor(a) for a in (x8, J, coh, s1, s2, cid, wt)), 6, K,
        nbase)
    assert tA.shape == (K, 48, 48)
    _close(tA.numpy(), A)
    _close(tJTe.numpy(), JTe)
    _close(tcost.numpy(), cost)
