"""The port's CUDA kernels on the card (marker ``cuda``; skipped on a
machine without a CUDA device). This file imports neither jax nor the
JAX package, so it runs on a card machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

Each kernel is held against its plain PyTorch version in float32 at
max|diff| <= 1e-4 max|ref| (the chip_smoke.py gate), and a CUDA tensor
must launch the kernel or raise — never fall back. Three tests drive the
solvers with ``--inner cg`` on the card (robust RTR alone, LM as an
in-flight group of two clusters, LM as a batch of two solve intervals)
against the same solve on the CPU in float64; the last two hold the
split predict of a mixed sky against the generic predict in float64 on
the card, and one LM solve on the XLA assembly against the CPU. The
bf16 and f16 instances of the sweep and visits kernels are held against
their plain versions at the same gate, and one pipeline run at
``--dtype-policy bf16`` against the CPU at bf16. The MPI CLI's ``-N``
(federated stochastic calibration) runs at 16 stations on the card
against the CPU."""

import numpy as np
import pytest
import torch

from sagecal_tpu_torch.ops import coh as tcoh
from sagecal_tpu_torch.ops import sweep as tswp
from sagecal_tpu_torch.solvers import normal_eq as tne

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, ref):
    return float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


#: the coherency kernel's edge shapes (chip_smoke.py COH_EDGES): channels
#: F (17: three channel tiles), sources S (130 crosses the 128-source
#: shared-memory chunk), which sources are gaussians, channel spacing;
#: and "random", chip_smoke.py's random geometry (COH_RANDOM)
COH_EDGES = [(1, 64, "mixed", "even"), (3, 64, "mixed", "even"),
             (8, 64, "mixed", "even"), (17, 64, "mixed", "even"),
             (8, 1, "mixed", "even"), (8, 130, "mixed", "even"),
             (8, 64, "point", "even"), (8, 64, "gauss", "even"),
             (8, 64, "mixed", "uneven"), (17, 130, "mixed", "uneven"),
             (4, 20, "random", "even")]


def _coh_case(F, S, kind, spacing):
    """chip_smoke.py's coh inputs (run from the repository root): the
    edge inputs, M = 3 clusters and B = 1000 rows (not a multiple of the
    256-row block) of the 62-station tracks, a ~3 degree field (phases up
    to ~1e3 rad); or ("random") random uvw of ~1e-5 s and sources ~0.03
    from the phase centre (phases up to ~4e3 rad), about half of them
    gaussians."""
    import chip_smoke
    if kind == "random":
        return chip_smoke._coh_random_inputs(F, S)
    return chip_smoke._coh_edge_inputs(F, S, kind, spacing)


def _coh_errors(args, step):
    """Two kernel calls (one launch each, bitwise equal), the float32
    plain version, and the errors of both against the plain version in
    float64: (kernel, plain, kernel's error, plain's error)."""
    n0 = tcoh.LAUNCHES
    got = tcoh.coherencies_points(*args, step=step)
    again = tcoh.coherencies_points(*args, step=step)
    torch.cuda.synchronize()
    assert tcoh.LAUNCHES == n0 + 2
    assert torch.equal(got, again)
    ref = tcoh.coherencies_points_plain(*args)
    truth = tcoh.coherencies_points_plain(*(a.double() for a in args[:5]),
                                          args[5])
    err = lambda x: float((x.double() - truth).abs().max()
                          / truth.abs().max())
    return got, ref, err(got), err(ref)


@pytest.mark.parametrize("F,S,kind,spacing", COH_EDGES)
def test_coh_kernel_matches_plain(card, F, S, kind, spacing):
    """One launch a call, two calls bitwise equal, within 1e-4 of the
    plain version, and against the plain version in float64 at most
    twice the float32 plain version's error; by the channel step the
    host finds and, where it finds one, by per-channel sincos too."""
    args, _, fl = _coh_case(F, S, kind, spacing)
    step = tcoh.channel_step(fl)
    assert (step is None) == (spacing == "uneven" or F == 1)
    M, B = args[1].shape[0], args[0].shape[1]
    for route in ((None,) if step is None else (step, None)):
        got, ref, err_kernel, err_plain = _coh_errors(args, route)
        assert got.shape == (M, B, F, 8) and _close(got, ref)
        assert err_kernel <= 2 * err_plain


def test_coh_kernel_one_source_is_near_float64(card):
    """chip_smoke.py's random geometry with one source (phases up to ~4e3
    rad). An output then carries its term's float32 phase roundoff
    undiluted, and kernel against plain measures the plain version's own
    roundoff, so this case is held to float64 alone: the kernel's error
    against the plain version in float64 is at most twice the float32
    plain version's, by either phasor route."""
    import chip_smoke
    args, _, fl = chip_smoke._coh_random_inputs(8, 1)
    step = tcoh.channel_step(fl)
    assert step is not None
    for route in (step, None):
        got, _, err_kernel, err_plain = _coh_errors(args, route)
        assert got.shape == (3, 1000, 8, 8)
        assert err_kernel <= 2 * err_plain


def test_coh_launch_refuses_a_geometry_that_misses_a_channel(card,
                                                             monkeypatch):
    """The kernel walks the channel tiles the wrapper's geometry gives it,
    and the launch refuses tiles that leave a channel out."""
    real = tcoh.coh_geometry
    monkeypatch.setattr(tcoh, "coh_geometry", lambda F, B: real(F, B)
                        ._replace(tile=real(F, B).tile - 1))
    z = torch.zeros((3, 300), device=card)
    with pytest.raises(RuntimeError, match="coh_points_kernel"):
        tcoh.coherencies_points(z, z.new_zeros((1, 3, 2)),
                                z.new_zeros((1, 8, 4, 2)),
                                z.new_zeros((1, 11, 2)), z.new_zeros(8), 1.0)


def test_coh_kernel_refuses_float64(card):
    z = torch.zeros((3, 4), dtype=torch.float64, device=card)
    with pytest.raises(TypeError):
        tcoh.coherencies_points(z, z.new_zeros((1, 3, 2)),
                                z.new_zeros((1, 1, 4, 2)),
                                z.new_zeros((1, 11, 2)), z.new_zeros(1), 1.0)


@pytest.mark.parametrize("K", [1, 4])
def test_sweep_kernel_matches_plain(card, K):
    rng = np.random.default_rng(K)
    N, T = 9, 12
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    lng = lambda a: torch.as_tensor(a, device=card).long()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=card)
    s1, s2 = lng(np.tile(p, T)), lng(np.tile(q, T))
    cid = lng(np.minimum((np.arange(B) // nb) // -(-T // K), K - 1))
    coh = c64(rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2)))
    J = c64((rng.normal(size=(K, N, 2, 2))
             + 1j * rng.normal(size=(K, N, 2, 2))) * 0.3 + np.eye(2))
    x8, wt, cw = (f32(rng.random((B, 8))) for _ in range(3))
    n0 = tswp.LAUNCHES
    got = tswp.sweep_blocks(x8, J, coh, s1, s2, cid, wt, cw, nb, K)
    assert tswp.LAUNCHES == n0 + 1
    ref = tswp.sweep_blocks_plain(x8, J[:, s1[:nb]], J[:, s2[:nb]], coh,
                                  cid, wt, cw, nb)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _close(g, r)


@pytest.mark.parametrize("N,T,K,nchunk", [(62, 120, 4, 4), (20, 5, 3, 3),
                                            (62, 120, 2, 1), (62, 1, 2, 2)])
def test_sweep_kernel_edges_are_deterministic(card, N, T, K, nchunk):
    """The sweep kernel at the full-width shape (nb = 1891) and at edges:
    nb = 190 (not a multiple of the 32-baseline tile), a 1-chunk cluster
    at kmax = 2 and one timeslot at kmax = 2 (chunk 1 without rows, whose
    blocks and cost are exactly zero); each matches the plain version and
    two calls give the same bits."""
    rng = np.random.default_rng(N + T + K)
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    lng = lambda a: torch.as_tensor(a, device=card).long()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=card)
    s1, s2 = lng(np.tile(p, T)), lng(np.tile(q, T))
    cid = lng(np.minimum((np.arange(B) // nb) // -(-T // nchunk),
                         nchunk - 1))
    coh = c64(rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2)))
    J = c64((rng.normal(size=(K, N, 2, 2))
             + 1j * rng.normal(size=(K, N, 2, 2))) * 0.3 + np.eye(2))
    x8, wt, cw = (f32(rng.random((B, 8))) for _ in range(3))
    got = tswp.sweep_blocks(x8, J, coh, s1, s2, cid, wt, cw, nb, K)
    again = tswp.sweep_blocks(x8, J, coh, s1, s2, cid, wt, cw, nb, K)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = tswp.sweep_blocks_plain(x8, J[:, s1[:nb]], J[:, s2[:nb]], coh,
                                  cid, wt, cw, nb)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _close(g, r)
    for k in range(K):
        if not bool((cid == k).any()):
            assert all(float(g[k].abs().max()) == 0.0 for g in got)


def test_sweep_launch_refuses_a_geometry_that_misses_rows(card,
                                                          monkeypatch):
    """The kernel walks the time ranges the wrapper's geometry gives it,
    and the launch refuses one that leaves a timeslot out."""
    real = tswp._geometry_args

    def short(T, nb, K, slots, V=1, md=4):
        geo, tb, wb = real(T, nb, K, slots, V, md)
        tb = type(tb)(*tb)
        tb[geo.cluster] -= 1
        return geo, tb, wb

    monkeypatch.setattr(tswp, "_geometry_args", short)
    N, T = 6, 4
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    lng = lambda a: torch.as_tensor(a, device=card).long()
    x8 = torch.ones((T * nb, 8), device=card)
    coh = torch.ones((T * nb, 2, 2), dtype=torch.complex64, device=card)
    J = torch.ones((1, N, 2, 2), dtype=torch.complex64, device=card)
    with pytest.raises(RuntimeError, match="sweep_cluster_kernel"):
        tswp.sweep_blocks(x8, J, coh, lng(np.tile(p, T)), lng(np.tile(q, T)),
                          lng(np.zeros(T * nb)), x8, x8, nb, 1)


def _mode_rows(card, K, seed, N=9, T=12, V=None):
    """Rows of the constrained-mode card tests ([V, ...] per visit when V
    is given): Jones whose off-diagonals are not zero, which the kernel
    must zero itself."""
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    lead = () if V is None else (V,)
    lng = lambda a: torch.as_tensor(a, device=card).long()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=card)
    s1, s2 = lng(np.tile(p, T)), lng(np.tile(q, T))
    cid = lng(np.minimum((np.arange(B) // nb) // -(-T // K), K - 1))
    coh = c64(rng.normal(size=lead + (B, 2, 2))
              + 1j * rng.normal(size=lead + (B, 2, 2)))
    J = c64((rng.normal(size=lead + (K, N, 2, 2))
             + 1j * rng.normal(size=lead + (K, N, 2, 2))) * 0.3 + np.eye(2))
    x8, wt, cw = (f32(rng.random(lead + (B, 8))) for _ in range(3))
    return x8, J, coh, s1, s2, cid, wt, cw, nb


@pytest.mark.parametrize("jones", ["diag", "phase"])
@pytest.mark.parametrize("K", [1, 4])
def test_sweep_kernel_modes_match_plain(card, jones, K):
    """The sweep kernel at md = 2 and 1: one launch a call, the plain
    version's blocks (of the constrained J), two calls the same bits."""
    x8, J, coh, s1, s2, cid, wt, cw, nb = _mode_rows(card, K, 20 + K)
    n0 = tswp.LAUNCHES
    got = tswp.sweep_blocks(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                            jones=jones)
    again = tswp.sweep_blocks(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                              jones=jones)
    torch.cuda.synchronize()
    assert tswp.LAUNCHES == n0 + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = tswp.sweep_blocks_plain(x8, J[:, s1[:nb]], J[:, s2[:nb]], coh,
                                  cid, wt, cw, nb, jones)
    md = tne.jones_mdim(jones)
    assert got[0].shape == (K, nb, 2, md, md)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _close(g, r)


@pytest.mark.parametrize("jones", ["diag", "phase"])
def test_visits_kernel_modes_match_plain(card, jones):
    """The multi-visit sweep at md = 2 and 1 (V = 3, K = 2, every operand
    per visit) against its plain version, and its records read in place
    by the matvec kernel at md."""
    V, K, N = 3, 2, 9
    x8, J, coh, s1, s2, cid, wt, cw, nb = _mode_rows(card, K, 30, V=V)
    n0 = tswp.VISITS_LAUNCHES
    got = tswp.sweep_blocks_visits(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                                   V, jones=jones)
    assert tswp.VISITS_LAUNCHES == n0 + 1
    ref = tswp.sweep_blocks_visits_plain(x8, J[:, :, s1[:nb]],
                                         J[:, :, s2[:nb]], coh, cid, wt, cw,
                                         nb, V, jones)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _close(g, r)
    md = tne.jones_mdim(jones)
    fac = tswp.GNBlocks(*(g.reshape((V * K,) + tuple(g.shape[2:]))
                          for g in got[:3]),
                        D=torch.zeros((V * K, N, 2, md, md), device=card))
    assert tswp._block_view(fac.pq, nb)[0] is fac.pq
    v = torch.randn((V * K, 2 * md * N), device=card,
                    generator=torch.Generator(device=card).manual_seed(2))
    y = tswp.gn_matvec_blocks(fac, v, s1, s2, N)
    assert _close(y, tswp.gn_matvec_blocks_plain(fac, v, s1[:nb], s2[:nb],
                                                 N))


@pytest.mark.parametrize("jones", ["diag", "phase"])
@pytest.mark.parametrize("K,shifted", [(1, False), (4, True)])
def test_matvec_kernel_modes_match_plain(card, jones, K, shifted):
    """The matvec kernel at md = 2 and 1 on the sweep's records (read in
    place): one launch a product, the plain version's product, two
    products the same bits."""
    N = 9
    x8, J, coh, s1, s2, cid, wt, cw, nb = _mode_rows(card, K, 40 + K)
    fac, _, _ = tswp.gn_blocks(x8, J, coh, s1, s2, cid, wt, N, K, nb,
                               jones=jones)
    md = tne.jones_mdim(jones)
    assert tswp._block_view(fac.pp, nb)[0] is fac.pp
    gen = torch.Generator(device=card).manual_seed(K)
    v = torch.randn((K, 2 * md * N), device=card, generator=gen)
    shift = torch.rand((K,), device=card, generator=gen) if shifted \
        else None
    plan = tswp.matvec_plan(fac, s1, s2, N, shift=shift)
    n0 = tswp.MATVEC_LAUNCHES
    got, again = tswp.matvec_apply(plan, v), tswp.matvec_apply(plan, v)
    torch.cuda.synchronize()
    assert tswp.MATVEC_LAUNCHES == n0 + 2 and torch.equal(got, again)
    ref = tswp.gn_matvec_blocks_plain(fac, v, s1[:nb], s2[:nb], N,
                                      shift=shift)
    assert got.shape == ref.shape and _close(got, ref)
    with pytest.raises(TypeError):
        tswp.matvec_apply(plan, torch.zeros((K, 8 * N), device=card))


REDUCED = {"bf16": torch.bfloat16, "f16": torch.float16}


@pytest.mark.parametrize("jones", ["full", "diag", "phase"])
@pytest.mark.parametrize("policy", ["bf16", "f16"])
def test_sweep_kernel_reduced_matches_plain(card, policy, jones):
    """The bf16 and f16 instances of the sweep kernel at md = 4, 2, 1 (K
    = 2 chunks): rows in the storage dtype, blocks and cost in float32,
    held against the plain version (which rounds the model and factor
    planes at the JAX kernel's q() boundary) at the 1e-4 gate; one launch
    a call, counted under its storage dtype; two calls the same bits."""
    st = REDUCED[policy]
    K = 2
    x8, J, coh, s1, s2, cid, wt, cw, nb = _mode_rows(card, K, 50)
    x8, wt, cw = (a.to(st) for a in (x8, wt, cw))
    tswp.reset_launches()
    got = tswp.sweep_blocks(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                            jones=jones)
    again = tswp.sweep_blocks(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                              jones=jones)
    torch.cuda.synchronize()
    assert tswp.ST_LAUNCHES == {("sweep", policy): 2}
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = tswp.sweep_blocks_plain(x8, J[:, s1[:nb]], J[:, s2[:nb]], coh,
                                  cid, wt, cw, nb, jones)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert _close(g, r)
    # the instance differs from the float32 kernel on the same values
    f32 = tswp.sweep_blocks(x8.float(), J, coh, s1, s2, cid, wt.float(),
                            cw.float(), nb, K, jones=jones)
    assert not torch.equal(got[0], f32[0])


@pytest.mark.parametrize("jones", ["full", "diag", "phase"])
@pytest.mark.parametrize("policy", ["bf16", "f16"])
def test_visits_kernel_reduced_matches_plain(card, policy, jones):
    """The bf16 and f16 instances of the multi-visit sweep (V = 4, K = 2,
    the weights shared by the visits) against the plain version, two
    calls the same bits, the launches counted under the storage dtype."""
    st = REDUCED[policy]
    V, K = 4, 2
    x8, J, coh, s1, s2, cid, wt, cw, nb = _mode_rows(card, K, 60, V=V)
    x8, wt, cw = x8.to(st), wt[0].to(st), cw[0].to(st)
    tswp.reset_launches()
    got = tswp.sweep_blocks_visits(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                                   V, jones=jones)
    again = tswp.sweep_blocks_visits(x8, J, coh, s1, s2, cid, wt, cw, nb,
                                     K, V, jones=jones)
    torch.cuda.synchronize()
    assert tswp.ST_LAUNCHES == {("visits", policy): 2}
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = tswp.sweep_blocks_visits_plain(x8, J[:, :, s1[:nb]],
                                         J[:, :, s2[:nb]], coh, cid, wt, cw,
                                         nb, V, jones)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert _close(g, r)


def test_sweep_kernel_refuses_mixed_storage(card):
    """x8, wt and cost_wt must share one storage dtype."""
    x8, J, coh, s1, s2, cid, wt, cw, nb = _mode_rows(card, 1, 70)
    with pytest.raises(TypeError):
        tswp.sweep_blocks(x8.to(torch.bfloat16), J, coh, s1, s2, cid,
                          wt.to(torch.float16), cw.to(torch.bfloat16), nb, 1)
    with pytest.raises(TypeError):
        tswp.sweep_blocks(x8.to(torch.bfloat16), J, coh, s1, s2, cid, wt, cw,
                          nb, 1)


def test_reduced_pipeline_on_card_matches_cpu(card, tmp_path):
    """One small pipeline run at --dtype-policy bf16 (16 stations, 3
    single-chunk clusters, 2 tiles of 120 timeslots at noise 0.05, -j 5
    --inner cg: OS robust LM with PCG on the sweep and matvec kernels) on
    the card against the same run on the CPU at bf16 (float32 there too),
    as chip_smoke's slice_parity holds a reduced run: per-tile residuals
    within max(1e-3, SPREAD_FACTOR x the CPU run's own spread, its move
    when every source flux moves by one float32 ulp), a gate of at most
    SPREAD_CAP; both runs' res_1 within ENVELOPE of the CPU run without
    the policy; only bf16 sweep instances launched. The observation is
    bf16_default's (chip_smoke.REDUCED_OBS), where the CPU's own spread
    is 3.2e-4; on 8 clusters of 3 sources at 10 timeslots and noise 0.02
    it was 3.6e-2 (the card read 1.2e-2 there), too chaotic to compare
    (ROADMAP C10)."""
    import shutil
    import chip_smoke
    tilesz, noise = chip_smoke.REDUCED_OBS["bf16_default"]
    ms, sky, clus = chip_smoke.make_observation(
        str(tmp_path), 16, tilesz, chip_smoke.FREQS[:2], 3, 6, (1, 1, 1), 2,
        "cpu", seed=9, noise=noise)
    for ext in (".cpu", ".ulp", ".f32"):
        shutil.copytree(ms, ms + ext)
    f32 = ["-j", "5", "--inner", "cg"]
    run = f32 + ["--dtype-policy", "bf16"]
    tswp.reset_launches()
    got, _ = chip_smoke._parity_run(ms, sky, clus, run, None, tilesz)
    assert tswp.ST_LAUNCHES and all(st == "bf16"
                                    for _, st in tswp.ST_LAUNCHES)
    ref, _ = chip_smoke._parity_run(ms + ".cpu", sky, clus, run, "cpu",
                                    tilesz)
    ulp, _ = chip_smoke._parity_run(ms + ".ulp", chip_smoke.perturb_sky(sky),
                                    clus, run, "cpu", tilesz)
    hf, _ = chip_smoke._parity_run(ms + ".f32", sky, clus, f32, "cpu",
                                   tilesz)
    spread = max(abs(u[k] - c[k]) / abs(c[k]) for u, c in zip(ulp, ref)
                 for k in ("res_0", "res_1"))
    gate = max(1e-3, chip_smoke.SPREAD_FACTOR * spread)
    assert gate <= chip_smoke.SPREAD_CAP, spread
    for g, c, f in zip(got, ref, hf):
        assert g["res_1"] < g["res_0"]
        for key in ("res_0", "res_1"):
            assert abs(g[key] - c[key]) <= gate * abs(c[key]), (key, spread)
        for h in (g, c):
            assert abs(h["res_1"] / f["res_1"] - 1.0) <= \
                chip_smoke.ENVELOPE["bf16"]


def test_sweep_kernel_refuses_float64(card):
    x8 = torch.zeros((6, 8), dtype=torch.float64, device=card)
    J = torch.zeros((1, 4, 2, 2), dtype=torch.complex128, device=card)
    coh = torch.zeros((6, 2, 2), dtype=torch.complex128, device=card)
    s = torch.zeros(6, dtype=torch.long, device=card)
    with pytest.raises(TypeError):
        tswp.sweep_blocks(x8, J, coh, s, s, s, x8, x8, 6, 1)


@pytest.mark.parametrize("K,shared", [(1, "wt"), (4, "wt"), (2, "cid"),
                                      (4, "none")])
def test_visits_kernel_matches_plain(card, K, shared):
    """V = 3 visits with the weights, or the chunk ids, shared, or all
    operands per visit: one launch, each visit's blocks the plain
    version's."""
    rng = np.random.default_rng(20 + K)
    V, N, T = 3, 9, 12
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    lng = lambda a: torch.as_tensor(a, device=card).long()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=card)
    s1, s2 = lng(np.tile(p, T)), lng(np.tile(q, T))
    cid = lng(np.stack([np.minimum((np.arange(B) // nb) // -(-T // K) + v,
                                   K - 1) for v in range(V)]))
    if shared == "cid":
        cid = cid[0]
    coh = c64(rng.normal(size=(V, B, 2, 2))
              + 1j * rng.normal(size=(V, B, 2, 2)))
    J = c64((rng.normal(size=(V, K, N, 2, 2))
             + 1j * rng.normal(size=(V, K, N, 2, 2))) * 0.3 + np.eye(2))
    wshape = (B, 8) if shared == "wt" else (V, B, 8)
    x8 = f32(rng.random((V, B, 8)))
    wt, cw = f32(rng.random(wshape)), f32(rng.random(wshape))
    n0 = tswp.VISITS_LAUNCHES
    got = tswp.sweep_blocks_visits(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                                   V)
    assert tswp.VISITS_LAUNCHES == n0 + 1
    ref = tswp.sweep_blocks_visits_plain(x8, J[:, :, s1[:nb]],
                                         J[:, :, s2[:nb]], coh, cid, wt, cw,
                                         nb, V)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _close(g, r)


@pytest.mark.parametrize("N,T,K,nchunk", [(62, 120, 4, 4), (20, 5, 3, 3),
                                            (62, 120, 2, 1), (62, 1, 2, 2)])
def test_visits_kernel_edges_are_deterministic(card, N, T, K, nchunk):
    """The multi-visit sweep at V = 3 (a ragged group: V is the real
    member count), each visit with its own chunk ids (visit v a
    cluster of max(1, nchunk - v) chunks at kmax = K), the weights
    shared: at nb = 1891 and at the sweep's edge shapes (nb = 190, a
    1-chunk cluster at kmax = 2, one timeslot). One launch a call, each
    visit's blocks the plain version's, an empty (visit, chunk)'s blocks
    exactly zero, and two calls give the same bits."""
    rng = np.random.default_rng(30 + N + T + K)
    V = 3
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    lng = lambda a: torch.as_tensor(a, device=card).long()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=card)
    s1, s2 = lng(np.tile(p, T)), lng(np.tile(q, T))
    rows = np.arange(B) // nb
    cid = torch.as_tensor(np.stack([
        np.minimum(rows // -(-T // max(1, nchunk - v)),
                   max(1, nchunk - v) - 1) for v in range(V)]),
        dtype=torch.int64, device=card)
    coh = c64(rng.normal(size=(V, B, 2, 2))
              + 1j * rng.normal(size=(V, B, 2, 2)))
    J = c64((rng.normal(size=(V, K, N, 2, 2))
             + 1j * rng.normal(size=(V, K, N, 2, 2))) * 0.3 + np.eye(2))
    x8, wt, cw = f32(rng.random((V, B, 8))), f32(rng.random((B, 8))), \
        f32(rng.random((B, 8)))
    n0 = tswp.VISITS_LAUNCHES
    got = tswp.sweep_blocks_visits(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                                   V)
    again = tswp.sweep_blocks_visits(x8, J, coh, s1, s2, cid, wt, cw, nb, K,
                                     V)
    assert tswp.VISITS_LAUNCHES == n0 + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = tswp.sweep_blocks_visits_plain(x8, J[:, :, s1[:nb]],
                                         J[:, :, s2[:nb]], coh, cid, wt, cw,
                                         nb, V)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _close(g, r)
    for v in range(V):
        for k in range(K):
            if not bool((cid[v] == k).any()):
                assert all(float(g[v, k].abs().max()) == 0.0 for g in got)


def test_visits_launch_refuses_a_geometry_that_misses_rows(card,
                                                           monkeypatch):
    """At V > 1 the kernel walks the same wrapper geometry for every
    visit, and the launch refuses one that leaves a timeslot out."""
    real = tswp._geometry_args

    def short(T, nb, K, slots, V=1, md=4):
        geo, tb, wb = real(T, nb, K, slots, V, md)
        tb = type(tb)(*tb)
        tb[geo.cluster] -= 1
        return geo, tb, wb

    monkeypatch.setattr(tswp, "_geometry_args", short)
    V, N, T = 2, 6, 4
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    lng = lambda a: torch.as_tensor(a, device=card).long()
    x8 = torch.ones((V, T * nb, 8), device=card)
    coh = torch.ones((V, T * nb, 2, 2), dtype=torch.complex64, device=card)
    J = torch.ones((V, 1, N, 2, 2), dtype=torch.complex64, device=card)
    with pytest.raises(RuntimeError, match="sweep_cluster_kernel"):
        tswp.sweep_blocks_visits(x8, J, coh, lng(np.tile(p, T)),
                                 lng(np.tile(q, T)), lng(np.zeros(T * nb)),
                                 x8[0], x8[0], nb, 1, V)


def test_visits_kernel_refuses_float64(card):
    x8 = torch.zeros((2, 6, 8), dtype=torch.float64, device=card)
    J = torch.zeros((2, 1, 4, 2, 2), dtype=torch.complex128, device=card)
    coh = torch.zeros((2, 6, 2, 2), dtype=torch.complex128, device=card)
    s = torch.zeros(6, dtype=torch.long, device=card)
    with pytest.raises(TypeError):
        tswp.sweep_blocks_visits(x8, J, coh, s, s, s, x8, x8, 6, 1, 2)


def _blocks_on_card(card, K, seed, N=9, T=12):
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    lng = lambda a: torch.as_tensor(a, device=card).long()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=card)
    s1, s2 = lng(np.tile(p, T)), lng(np.tile(q, T))
    cid = lng(np.minimum((np.arange(B) // nb) // -(-T // K), K - 1))
    coh = c64(rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2)))
    J = c64((rng.normal(size=(K, N, 2, 2))
             + 1j * rng.normal(size=(K, N, 2, 2))) * 0.3 + np.eye(2))
    x8, wt = f32(rng.random((B, 8))), f32(rng.random((B, 8)))
    fac, _, _ = tswp.gn_blocks(x8, J, coh, s1, s2, cid, wt, N, K, nb)
    return fac, s1, s2, nb


@pytest.mark.parametrize("K,shifted", [(1, False), (4, True)])
def test_matvec_kernel_matches_plain(card, K, shifted):
    N = 9
    fac, s1, s2, nb = _blocks_on_card(card, K, 10 + K, N=N)
    gen = torch.Generator(device=card).manual_seed(K)
    v = torch.randn((K, 8 * N), device=card, generator=gen)
    shift = torch.rand((K,), device=card, generator=gen) if shifted \
        else None
    n0 = tswp.MATVEC_LAUNCHES
    got = tswp.gn_matvec_blocks(fac, v, s1, s2, N, shift=shift)
    torch.cuda.synchronize()
    assert tswp.MATVEC_LAUNCHES == n0 + 1
    ref = tswp.gn_matvec_blocks_plain(fac, v, s1[:nb], s2[:nb], N,
                                      shift=shift)
    assert got.shape == ref.shape and _close(got, ref)
    # contiguous copies of the strided sweep views, on station lists built
    # once beforehand as sagefit_host builds them, give the same product
    flat = tswp.GNBlocks(*(t.contiguous() for t in fac))
    lists = tswp.station_lists(s1, s2, nb, N)
    again = tswp.gn_matvec_blocks(flat, v, s1, s2, N, shift=shift,
                                  lists=lists)
    assert _close(again, ref)
    with pytest.raises(ValueError):
        tswp.gn_matvec_blocks(fac, v, s1, s2, N, shift=shift,
                              lists=tswp.station_lists(s1, s2, nb - 1, N))


def test_matvec_kernel_on_visit_records_is_deterministic(card):
    """The matvec kernel reads a group's [V K, nb, REC] records from the
    multi-visit sweep in place, through one plan, and two products give
    the same bits."""
    rng = np.random.default_rng(5)
    V, K, N, T = 3, 2, 9, 12
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    lng = lambda a: torch.as_tensor(a, device=card).long()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=card)
    s1, s2 = lng(np.tile(p, T)), lng(np.tile(q, T))
    cid = lng(np.minimum((np.arange(B) // nb) // -(-T // K), K - 1))
    coh = c64(rng.normal(size=(V * B, 2, 2))
              + 1j * rng.normal(size=(V * B, 2, 2)))
    J = c64((rng.normal(size=(V * K, N, 2, 2))
             + 1j * rng.normal(size=(V * K, N, 2, 2))) * 0.3 + np.eye(2))
    x8, wt = f32(rng.random((V * B, 8))), f32(rng.random((B, 8)))
    lanes = tswp.Lanes(V=V, K=K, cid=cid)
    fac, _, _ = tswp.gn_blocks(x8, J, coh, s1, s2, cid, wt, N, V * K, nb,
                               lanes=lanes)
    assert tswp._block_view(fac.pq, nb)[0] is fac.pq
    plan = tswp.matvec_plan(fac, s1, s2, N, shift=torch.full(
        (V * K,), 0.25, device=card))
    v = torch.randn((V * K, 8 * N), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    got, again = tswp.matvec_apply(plan, v), tswp.matvec_apply(plan, v)
    assert torch.equal(got, again)
    ref = tswp.gn_matvec_blocks_plain(fac, v, s1[:nb], s2[:nb], N,
                                      shift=torch.full((V * K,), 0.25,
                                                       device=card))
    assert _close(got, ref)


def test_matvec_kernel_refuses_float64(card):
    fac, s1, s2, nb = _blocks_on_card(card, 1, 3)
    f64 = tswp.GNBlocks(*(t.double() for t in fac))
    with pytest.raises(TypeError):
        tswp.gn_matvec_blocks(f64, torch.zeros((1, 72), dtype=torch.float64,
                                               device=card), s1, s2, 9)


def test_group_solve_on_card_matches_cpu(card):
    """One in-flight group of 2 clusters (LM, PCG on the matvec kernel)
    solved through the multi-visit sweep kernel, against the CPU float64
    group solve: each lane's final cost within 1e-3. (LM: on these data
    the robust RTR trajectory already parts between float32 and float64
    on the CPU, serial or grouped alike.)"""
    from sagecal_tpu_torch.solvers import sage as tsage
    rng = np.random.default_rng(8)
    V, N, T, K = 2, 9, 12, 2
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    cid = np.stack([np.minimum((np.arange(B) // nb) // -(-T // K), K - 1)]
                   * V)
    coh = rng.normal(size=(V, B, 2, 2)) + 1j * rng.normal(size=(V, B, 2, 2))
    Jt = (rng.normal(size=(V, K, N, 2, 2))
          + 1j * rng.normal(size=(V, K, N, 2, 2))) * 0.2 + np.eye(2)
    sa, sb = np.tile(p, T), np.tile(q, T)
    Vis = np.stack([Jt[v][cid[v], sa] @ coh[v]
                    @ np.conj(np.swapaxes(Jt[v][cid[v], sb], -1, -2))
                    for v in range(V)])
    Vis = Vis + 0.05 * (rng.normal(size=Vis.shape)
                        + 1j * rng.normal(size=Vis.shape))
    x8 = np.stack([Vis.reshape(V, B, 4).real, Vis.reshape(V, B, 4).imag],
                  -1).reshape(V, B, 8)
    J0 = np.tile(np.eye(2, dtype=complex), (V, K, N, 1, 1))
    cfg = tsage.SageConfig(max_iter=6, solver_mode=1, inner="cg", nbase=nb)
    out = {}
    for dev, rdt, cdt in ((card, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        r = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
        c = lambda a: torch.as_tensor(a, dtype=cdt, device=dev)
        i = lambda a: torch.as_tensor(a, device=dev).long()
        n0 = tswp.VISITS_LAUNCHES
        res = tsage._group_solve(
            1, r(x8), c(coh), i(cid), torch.ones((V, K), dtype=torch.bool,
                                                 device=dev),
            c(J0), r([2.0, 2.0]), i(sa), i(sb), r(np.ones((B, 8))), N, cfg,
            [6, 6], 9, None, False, None, cid_shared=True)
        out[str(dev)] = (res[3].double().cpu(), tswp.VISITS_LAUNCHES - n0)
    (gc, gl), (cc, cl) = out[str(card)], out["cpu"]
    assert gl > 0 and cl == 0
    assert float((gc - cc).abs().max()) <= 1e-3 * float(cc.abs().max())


def test_tile_lanes_on_card_match_cpu(card):
    """One lane-batched solve of a batch of V = T = 2 solve intervals (a
    sweep step of ``sagefit_host_tiles``: LM, PCG on the matvec kernel):
    each tile its own data, coherencies, flagged weights and chunk ids (a
    cluster of 2 chunks in tile 0, of 1 in tile 1), through the
    multi-visit sweep kernel with every operand per visit, against the
    CPU float64 solve: each lane's final cost within 1e-3."""
    from sagecal_tpu_torch.solvers import sage as tsage
    rng = np.random.default_rng(9)
    V, N, T, K = 2, 9, 12, 2
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    cid = np.stack([np.minimum((np.arange(B) // nb) // -(-T // nck),
                               nck - 1) for nck in (2, 1)])
    coh = rng.normal(size=(V, B, 2, 2)) + 1j * rng.normal(size=(V, B, 2, 2))
    Jt = (rng.normal(size=(V, K, N, 2, 2))
          + 1j * rng.normal(size=(V, K, N, 2, 2))) * 0.2 + np.eye(2)
    sa, sb = np.tile(p, T), np.tile(q, T)
    Vis = np.stack([Jt[v][cid[v], sa] @ coh[v]
                    @ np.conj(np.swapaxes(Jt[v][cid[v], sb], -1, -2))
                    for v in range(V)])
    Vis = Vis + 0.05 * (rng.normal(size=Vis.shape)
                        + 1j * rng.normal(size=Vis.shape))
    x8 = np.stack([Vis.reshape(V, B, 4).real, Vis.reshape(V, B, 4).imag],
                  -1).reshape(V, B, 8)
    wt = np.repeat((rng.random((V * B, 1)) > 0.1).astype(float), 8, axis=1)
    cmask = np.array([[True, True], [True, False]])
    J0 = np.tile(np.eye(2, dtype=complex), (V, K, N, 1, 1))
    cfg = tsage.SageConfig(max_iter=6, solver_mode=1, inner="cg", nbase=nb)
    out = {}
    for dev, rdt, cdt in ((card, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        r = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
        c = lambda a: torch.as_tensor(a, dtype=cdt, device=dev)
        i = lambda a: torch.as_tensor(a, device=dev).long()
        n0 = (tswp.VISITS_LAUNCHES, tswp.MATVEC_LAUNCHES, tswp.LAUNCHES)
        res = tsage._group_solve(
            1, r(x8), c(coh), i(cid), torch.as_tensor(cmask, device=dev),
            c(J0), r([2.0, 2.0]), i(sa), i(sb), r(wt), N, cfg, [6, 4], 9,
            None, False, None, cid_shared=False, tiles=V)
        counts = (tswp.VISITS_LAUNCHES, tswp.MATVEC_LAUNCHES, tswp.LAUNCHES)
        out[str(dev)] = (res[3].double().cpu(),
                         [b - a for a, b in zip(n0, counts)], res[4])
    (gc, gl, gi), (cc, cl, ci) = out[str(card)], out["cpu"]
    assert gl[0] > 0 and gl[1] > 0 and gl[2] == 0 and cl == [0, 0, 0]
    assert gi[1] <= 4 and ci[1] <= 4
    assert float((gc - cc).abs().max()) <= 1e-3 * float(cc.abs().max())


def robust_rtr_problem(point: bool = True):
    """The robust RTR card test's input (seed 6, N = 9, T = 12, K = 2):
    visibilities of a truth 0.2 from identity with noise 0.05, solved from
    J0 = identity. ``point``: the coherencies of a point source, a seeded
    phase times 2 I, on which the solve is well posed (a one-ulp change
    of the data moves the final cost by ~1e-15 in float64); else random
    coherencies, on which float64 roundoff already splits the trajectory
    (tests/test_torch_rtr.py holds both packages to both facts). Returns
    (x8, coh, sta1, sta2, cid, J0, N, nb) as numpy arrays."""
    rng = np.random.default_rng(6)
    N, T, K = 9, 12, 2
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    cid = np.minimum((np.arange(B) // nb) // -(-T // K), K - 1)
    if point:
        phase = np.exp(2j * np.pi * rng.random(B))
        coh = phase[:, None, None] * (2.0 * np.eye(2))
    else:
        coh = rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2))
    Jt = (rng.normal(size=(K, N, 2, 2))
          + 1j * rng.normal(size=(K, N, 2, 2))) * 0.2 + np.eye(2)
    sa, sb = np.tile(p, T), np.tile(q, T)
    V = Jt[cid, sa] @ coh @ np.conj(np.swapaxes(Jt[cid, sb], -1, -2))
    V = V + 0.05 * (rng.normal(size=V.shape) + 1j * rng.normal(size=V.shape))
    x8 = np.stack([V.reshape(B, 4).real, V.reshape(B, 4).imag],
                  -1).reshape(B, 8)
    J0 = np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    return x8, coh, sa, sb, cid, J0, N, nb


def test_robust_rtr_cg_on_card_matches_cpu(card):
    """One robust RTR cluster solve with the matvec kernel in every tCG
    product, against the CPU float64 solve: final cost within 1e-3, on
    the well-posed point-source input (on random coherencies float64
    roundoff alone splits the trajectory: tests/test_torch_rtr.py)."""
    from sagecal_tpu_torch.solvers import rtr as trtr
    x8, coh, sa, sb, cid, J0, N, nb = robust_rtr_problem(point=True)
    B = x8.shape[0]
    out = {}
    for dev, rdt, cdt in ((card, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        r = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
        c = lambda a: torch.as_tensor(a, dtype=cdt, device=dev)
        i = lambda a: torch.as_tensor(a, device=dev).long()
        n0 = tswp.MATVEC_LAUNCHES
        J, nu, info = trtr.rtr_solve_robust(
            r(x8), c(coh), i(sa), i(sb), i(cid), r(np.ones((B, 8))), c(J0),
            N, row_period=nb, config=trtr.RTRConfig(itmax=6, inner="cg"))
        out[str(dev)] = (info["final_cost"].double().cpu(),
                         tswp.MATVEC_LAUNCHES - n0)
    (gc, gl), (cc, cl) = out[str(card)], out["cpu"]
    assert gl > 0 and cl == 0
    assert float((gc - cc).abs().max()) <= 1e-3 * float(cc.abs().max())


def test_split_predict_on_card_matches_float64(card, tmp_path):
    """The split predict of a mixed sky (chip_smoke.py's write_sky: every
    morphology, shapelets of n0 = 2..6) in float32 on the card (the
    coherency kernel on the point/gaussian half, one launch, plus the
    eager rest) against the port's generic predict in float64 on the
    card: max|diff| <= 1e-4 max|ref|."""
    import chip_smoke
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.rime import predict as trp
    sky_path, clus_path = chip_smoke.write_sky(
        str(tmp_path / "sky.txt"), 3, 30, (1, 1, 1), seed=4, mixed=True)
    sky = skymodel.read_sky_cluster(sky_path, clus_path, chip_smoke.RA0,
                                    chip_smoke.DEC0, 150e6)
    rng = np.random.default_rng(2)
    uvw = rng.normal(0, 4e-6, (3, 2000)) * np.array([[1.0], [1.0], [0.1]])
    freqs = chip_smoke.FREQS
    t = lambda dt: [torch.as_tensor(a, dtype=dt, device=card) for a in uvw]
    n0 = tcoh.LAUNCHES
    got = trp.coherencies(trp.split_sky(sky, torch.float32, card),
                          *t(torch.float32), freqs, 0.18e6,
                          per_channel_flux=True)
    assert tcoh.LAUNCHES - n0 == 1
    ref = trp.coherencies_generic(
        trp.sky_to_device(sky, torch.float64, card), *t(torch.float64),
        freqs, 0.18e6, per_channel_flux=True)
    assert _close(got.to(torch.complex128), ref)


def test_xla_lm_solve_on_card_matches_cpu(card):
    """One LM solve on the XLA assembly (--kernel xla, --inner chol) on
    the card, against the CPU float64 solve: final cost within 1e-3; the
    solve counts in XLA_SOLVES and launches no sweep kernel."""
    from sagecal_tpu_torch.solvers import lm as tlm
    x8, coh, sa, sb, cid, J0, N, nb = robust_rtr_problem(point=True)
    B = x8.shape[0]
    out = {}
    for dev, rdt, cdt in ((card, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        r = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
        c = lambda a: torch.as_tensor(a, dtype=cdt, device=dev)
        i = lambda a: torch.as_tensor(a, device=dev).long()
        n0, s0 = tlm.XLA_SOLVES, tswp.LAUNCHES
        J, info = tlm.lm_solve(
            r(x8), c(coh), i(sa), i(sb), i(cid), r(np.ones((B, 8))), c(J0),
            N, row_period=nb, config=tlm.LMConfig(itmax=8, kernel="xla"))
        out[str(dev)] = info["final_cost"].double().cpu()
        assert tlm.XLA_SOLVES - n0 == 1 and tswp.LAUNCHES == s0
    gc, cc = out[str(card)], out["cpu"]
    assert float((gc - cc).abs().max()) <= 1e-3 * float(cc.abs().max())


@pytest.mark.parametrize("flags,md,nchunk", [
    (["-j", "1", "--jones", "diag", "--inflight", "2", "-g", "30"], 2,
     (1, 2) * 4),
    (["-j", "1", "--inner", "cg", "--jones", "phase"], 1, (1, 2) * 4),
    (["-j", "5", "--inner", "cg", "--jones", "phase"], 1, (1,) * 8),
    (["-j", "5", "--inner", "cg"], 4, (1,) * 8)])
def test_tile_batch_jones_pipeline_on_card_matches_cpu(card, tmp_path,
                                                       flags, md, nchunk):
    """The pipeline at --tile-batch 2 on the card (16 stations, 8
    clusters, 3 tiles of 10 timeslots: tile 0 alone, tiles 1-2 one batch)
    against the CPU pipeline: per-tile residuals within 1e-3; the batch
    launches the visits kernel, at the mode's md only, and no
    single-visit sweep. Cases: LM with groups in diag mode and LM with
    PCG on the matvec kernel in phase mode, on clusters of 1 and 2
    chunks; and -j 5 --inner cg, which 16 stations run as OS robust LM
    with PCG, in phase mode and in full Jones, on single-chunk clusters.
    (With 2-chunk clusters the OS modes' float32 runs leave float64 by
    up to ~2e-2, ROADMAP queue C item 4; slice_parity's 16-station
    default run uses single-chunk clusters for the same reason.)"""
    import shutil
    import chip_smoke
    ms, sky, clus = chip_smoke.make_observation(
        str(tmp_path), 16, 10, chip_smoke.FREQS[:2], 8, 3, nchunk, 3,
        "cpu", seed=9, noise=0.02)
    shutil.copytree(ms, ms + ".cpu")
    run = flags + ["--tile-batch", "2"]
    tswp.reset_launches()
    got, _ = chip_smoke._parity_run(ms, sky, clus, run, device=None)
    ref, _ = chip_smoke._parity_run(ms + ".cpu", sky, clus, run,
                                    device="cpu")
    assert [h["batch"] and h["batch"]["tiles"] for h in got] == \
        [None, [1, 2], [1, 2]]
    assert got[1]["launches"]["visits"] > 0
    assert got[1]["launches"]["sweep"] == 0
    assert tswp.MD_LAUNCHES and all(m == md for _, m in tswp.MD_LAUNCHES)
    for g, c in zip(got, ref):
        for key in ("res_0", "res_1"):
            assert abs(g[key] - c[key]) <= 1e-3 * abs(c[key]), key


def test_band_solver_on_card_matches_cpu(card, tmp_path):
    """The stochastic band solver at W = 2 bands of 4 channels over two
    successive minibatches of 10 timeslots with persistent memories
    (chip_smoke.py's STOCHASTIC_PARITY shapes, one tile), on the card
    (float32: the coherency kernel predicts each band) against the CPU
    (float64, plain versions): p and res_0/res_1 within 1e-3; each solve
    launches the coherency kernel once a band and no solve kernel."""
    import chip_smoke
    from sagecal_tpu_torch import skymodel, stochastic
    from sagecal_tpu_torch.cli import build_parser, config_from_args
    from sagecal_tpu_torch.io import dataset as tds
    from sagecal_tpu_torch.solvers import lbfgs as tl
    ms, sky, clus = chip_smoke.make_observation(
        str(tmp_path), 16, 20, chip_smoke.FREQS, 8, 6, (1, 2) * 4, 1,
        "cpu", seed=9, noise=0.02)
    cfg = config_from_args(build_parser().parse_args(
        ["-d", ms, "-s", sky, "-c", clus, "-N", "1", "-M", "2", "-w", "2",
         "-l", "10", "-m", "7", "-t", "20"]))
    meta = tds.SimMS(ms).meta
    csky = skymodel.read_sky_cluster(sky, clus, meta["ra0"], meta["dec0"],
                                     meta["freq0"])
    out = {}
    for dev in (card, "cpu"):
        rn = stochastic.StochasticRunner(cfg, tds.SimMS(ms), csky,
                                         device=dev, log=lambda *a: None)
        solve = stochastic.make_band_solver_batched(
            rn.dsky, rn.n, rn.cidx, rn.cmask, rn.fdelta_chan, 2.0, 10)
        inputs = rn.build_tile_inputs(tds.SimMS(ms).read_tile(0))
        pinit, pfreq = rn.initial_p()
        like = torch.zeros((), dtype=rn.rdt, device=rn.device)
        p, mem = rn.stack_state(pfreq, [
            tl.lbfgs_memory_init(rn.nparam, 7, like) for _ in pfreq])
        recs = []
        for nmb in range(rn.minibatches):
            c0, s0 = tcoh.LAUNCHES, (tswp.LAUNCHES, tswp.MATVEC_LAUNCHES,
                                     tswp.VISITS_LAUNCHES)
            o = solve(*inputs[nmb], p, mem)
            p, mem = o.p, o.mem
            if dev == card:
                assert tcoh.LAUNCHES - c0 == 2
                assert (tswp.LAUNCHES, tswp.MATVEC_LAUNCHES,
                        tswp.VISITS_LAUNCHES) == s0
            recs.append((o.p.double().cpu(), o.res_0.double().cpu(),
                         o.res_1.double().cpu()))
        out[str(dev)] = recs
    for (pg, r0g, r1g), (pc, r0c, r1c) in zip(out[str(card)], out["cpu"]):
        assert float((pg - pc).abs().max()) <= 1e-3 * float(pc.abs().max())
        for g, c in ((r0g, r0c), (r1g, r1c)):
            assert float(((g - c) / c).abs().max()) <= 1e-3
        assert bool((r1c < r0c).all())



@pytest.mark.parametrize("solver,inner", [("lm", "chol"), ("lm", "cg"),
                                          ("rtr", "cg")])
def test_admm_solve_on_card_matches_cpu(card, solver, inner):
    """One cluster solve with the consensus-ADMM term on the sweep route
    (the blocks Cholesky with rho in its shift, or the matvec kernel with
    rho in its shift; RTR's tCG with 2 rho v beside each matvec), on the
    point-source input with y, bz and rho of the consensus run's size,
    against the CPU float64 solve: final (augmented) cost within 1e-3.
    RTR, not robust RTR: on this input robust RTR under ADMM moves 8e-4
    to 1e-2 with float32 alone on the CPU (its nu grid; ROADMAP C13),
    RTR 8e-8."""
    from sagecal_tpu_torch.solvers import lm as tlm
    from sagecal_tpu_torch.solvers import rtr as trtr
    x8, coh, sa, sb, cid, J0, N, nb = robust_rtr_problem(point=True)
    B = x8.shape[0]
    rng = np.random.default_rng(12)
    y = 0.2 * rng.normal(size=(2, N, 8))
    bz = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 1.0, 0]), (2, N, 1)) \
        + 0.1 * rng.normal(size=(2, N, 8))
    out = {}
    for dev, rdt, cdt in ((card, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        r = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
        c = lambda a: torch.as_tensor(a, dtype=cdt, device=dev)
        i = lambda a: torch.as_tensor(a, device=dev).long()
        n0, m0 = tswp.LAUNCHES, tswp.MATVEC_LAUNCHES
        args = (r(x8), c(coh), i(sa), i(sb), i(cid), r(np.ones((B, 8))),
                c(J0), N)
        admm = (r(y), r(bz), 2.5)
        if solver == "lm":
            _, info = tlm.lm_solve(*args, row_period=nb, admm=admm,
                                   config=tlm.LMConfig(itmax=8, inner=inner))
        else:
            _, info = trtr.rtr_solve(
                *args, row_period=nb, admm=admm,
                config=trtr.RTRConfig(itmax=6, inner=inner))
        out[str(dev)] = (info["final_cost"].double().cpu(),
                         tswp.LAUNCHES - n0, tswp.MATVEC_LAUNCHES - m0)
    (gc, gs, gm), (cc, cs, cm) = out[str(card)], out["cpu"]
    assert gs > 0 and cs == cm == 0
    assert (gm > 0) == (inner == "cg")
    assert float((gc - cc).abs().max()) <= 1e-3 * float(cc.abs().max())


def test_federated_on_card_matches_cpu(card, tmp_path):
    """The MPI CLI's ``-N`` (federated stochastic calibration) on 2 slave
    subbands of 16 stations (chip_smoke.py's FEDERATED_PARITY: 40
    timeslots, 8 channels, 8 clusters, ``-N 1 -M 2 -w 2 -A 2 -u 0.5 -r
    0.5``; 40 timeslots because at 20 float32 alone moves the written
    column 8.1e-4 from float64 on the CPU: ROADMAP C8,
    ``tools_dev/torch_federated_float32.py``) on the card (float32: the
    coherency kernel predicts every band) against the CPU (float64, plain
    versions): res_0/res_1 and each slave's residuals within 1e-3; the
    card run launches the coherency kernel and no solve kernel, and every
    slave's residual falls."""
    import chip_smoke
    from sagecal_tpu_torch import cli_mpi
    n_st, nchunk, tsz, flags = chip_smoke.FEDERATED_PARITY
    lst, sky, clus, paths = chip_smoke.make_subbands(
        str(tmp_path), n_st, tsz, chip_smoke.CONSENSUS_PARITY_CENTRES[:2],
        chip_smoke.FREQS, len(nchunk), 6, nchunk, 1, "cpu", seed=9,
        noise=0.02)
    import shutil
    with open(lst + ".cpu", "w") as f:
        for p in paths:
            shutil.copytree(p, p + ".cpu")
            f.write(p + ".cpu\n")
    out = {}
    for dev, lf, extra in ((card, lst, []), ("cpu", lst + ".cpu",
                                             ["--platform", "cpu"])):
        c0 = tcoh.LAUNCHES
        s0 = (tswp.LAUNCHES, tswp.MATVEC_LAUNCHES, tswp.VISITS_LAUNCHES)
        hist = cli_mpi.run(["-f", lf, "-s", sky, "-c", clus, "-p",
                            lf + ".sol"] + list(flags) + extra,
                           log=lambda *a: None)
        if dev == card:
            assert tcoh.LAUNCHES - c0 > 0
            assert (tswp.LAUNCHES, tswp.MATVEC_LAUNCHES,
                    tswp.VISITS_LAUNCHES) == s0
        out[str(dev)] = hist
    for g, c in zip(out[str(card)], out["cpu"]):
        for key in ("res_0", "res_1"):
            assert abs(g[key] - c[key]) <= 1e-3 * abs(c[key]), key
        for (g0, g1), (c0, c1) in zip(g["slave_res"], c["slave_res"]):
            assert abs(g0 - c0) <= 1e-3 * abs(c0)
            assert abs(g1 - c1) <= 1e-3 * abs(c1)
            assert g1 < g0 and c1 < c0
