"""The stochastic band solvers (``stochastic.make_band_solver`` and
``make_band_solver_batched``) against the JAX ones, float64, on the
tests/test_stochastic.py sky (2 point-source clusters) over a simulated
tile of 8 stations, 4 timeslots and 4 channels, for both losses.

Each case solves two successive minibatches (timeslots 0-1, then 2-3)
with one persistent memory a band, so the second solve takes the adaptive
first step. Gates: p atol 1e-8, res_0/res_1 rtol 1e-10, iterations equal.
The batched solver runs W = 2 bands (channels 0-1, 2-3) and W = 3 (a
third band of channel 1 alone, padded to 2 channels with its first
channel repeated at zero weight), against the JAX batched solver and
against W single-band port solves, at the same gates."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagecal_tpu import skymodel, stochastic as jst
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.rime import predict as rp
from sagecal_tpu.solvers import lbfgs as jl
from sagecal_tpu_torch import stochastic as tst
from sagecal_tpu_torch.rime import predict as trp
from sagecal_tpu_torch.solvers import lbfgs as tl

from test_stochastic import CLUSTER, SKY

N_ST, TILESZ, MB = 8, 4, 2
FREQS = np.array([148e6, 150e6, 152e6, 154e6])
NU, ITMAX, N_MEM = 2.0, 6, 4
#: bands: (channels, padded width); the last of BANDS3 is padded
BANDS2 = ([0, 1], [2, 3])
BANDS3 = BANDS2 + ([1],)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("band_solver")
    (tmp / "sky.txt").write_text(SKY)
    (tmp / "sky.txt.cluster").write_text(CLUSTER)
    ra0, dec0 = (41 / 60) * math.pi / 12, 40 * math.pi / 180
    sky = skymodel.build_cluster_sky(
        skymodel.parse_sky_model(str(tmp / "sky.txt"), ra0, dec0, 150e6),
        skymodel.parse_cluster_file(str(tmp / "sky.txt.cluster")))
    J = ds.random_jones(sky.n_clusters, sky.nchunk, N_ST, seed=2, scale=0.15)
    tile = ds.simulate_dataset(rp.sky_to_device(sky, jnp.float64), N_ST,
                               TILESZ, FREQS, ra0, dec0, jones=J,
                               nchunk=sky.nchunk, noise_sigma=0.01, seed=3)
    tile.flags[5] = 1                            # one flagged row
    return sky, tile


def _band(tile, rows, chans, fpad):
    """(x8F [B, fpad, 8], wtF, freqsF) of one band over ``rows``."""
    nb = len(rows)
    x = np.zeros((nb, fpad, 4), np.complex128)
    x[:, :len(chans)] = tile.x[rows][:, chans].reshape(nb, len(chans), 4)
    x8 = np.stack([x.real, x.imag], -1).reshape(nb, fpad, 8)
    wt = np.zeros((nb, fpad, 8))
    wt[:, :len(chans)] = (tile.flags[rows] == 0)[:, None, None]
    fl = np.full(fpad, FREQS[chans[0]])
    fl[:len(chans)] = FREQS[chans]
    return x8, wt, fl


def _minibatches(tile, bands):
    """Per minibatch: (u, v, w, sta1, sta2, [(x8F, wtF, freqsF)] a band)."""
    nbase = N_ST * (N_ST - 1) // 2
    out = []
    for t0 in range(0, TILESZ, MB):
        rows = np.arange(t0 * nbase, (t0 + MB) * nbase)
        out.append((tile.u[rows], tile.v[rows], tile.w[rows],
                    tile.sta1[rows], tile.sta2[rows],
                    [_band(tile, rows, c, 2) for c in bands]))
    return out


def _common(sky):
    kmax = int(sky.nchunk.max())
    cmask = np.arange(kmax)[None] < sky.nchunk[:, None]
    cidx = rp.chunk_indices(MB, N_ST * (N_ST - 1) // 2, sky.nchunk)
    p0 = np.tile(np.array([1, 0, 0, 0, 0, 0, 1, 0], np.float64),
                 (sky.n_clusters, kmax, N_ST, 1))
    return kmax, cmask, cidx, p0


def _jax_solves(sky, tile, bands, loss, batched):
    """The JAX band solver over the minibatches: per minibatch (p, res_0,
    res_1, iters), each [W, ...]."""
    kmax, cmask, cidx, p0 = _common(sky)
    dsky = rp.sky_to_device(sky, jnp.float64)
    fd = 2e6 / len(FREQS)
    nparam = p0.size
    make = jst.make_band_solver_batched if batched else jst.make_band_solver
    solve = make(dsky, N_ST, cidx, cmask, fd, NU, ITMAX, False, loss=loss)
    W = len(bands)
    mems = [jl.lbfgs_memory_init(nparam, N_MEM, jnp.float64)
            for _ in range(W)]
    ps = [jnp.asarray(p0)] * W
    out = []
    for u, v, w, s1, s2, bd in _minibatches(tile, bands):
        geo = [jnp.asarray(a) for a in (u, v, w)] + \
            [jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)]
        ts = jnp.zeros(len(u), jnp.int32)
        if batched:
            mem = jax.tree.map(lambda *xs: jnp.stack(xs), *mems)
            o = solve(jnp.stack([jnp.asarray(b[0]) for b in bd]), *geo,
                      jnp.stack([jnp.asarray(b[1]) for b in bd]),
                      jnp.stack([jnp.asarray(b[2]) for b in bd]), ts,
                      jnp.stack(ps), mem, None, None, None, None)
            ps = [o.p[b] for b in range(W)]
            mems = [jax.tree.map(lambda a: a[b], o.mem) for b in range(W)]
            out.append(tuple(np.asarray(a) for a in (o.p, o.res_0, o.res_1,
                                                     o.iters)))
        else:
            rec = []
            for b in range(W):
                o = solve(jnp.asarray(bd[b][0]), *geo, jnp.asarray(bd[b][1]),
                          jnp.asarray(bd[b][2]), ts, ps[b], mems[b])
                ps[b], mems[b] = o.p, o.mem
                rec.append((o.p, o.res_0, o.res_1, o.iters))
            out.append(tuple(np.stack([np.asarray(r[i]) for r in rec])
                             for i in range(4)))
    return out


def _torch_solves(sky, tile, bands, loss, batched):
    """The port's solver over the minibatches, as :func:`_jax_solves`."""
    kmax, cmask, cidx, p0 = _common(sky)
    dsky = trp.split_sky(sky, torch.float64, "cpu")
    fd = 2e6 / len(FREQS)
    t = torch.as_tensor
    make = tst.make_band_solver_batched if batched else tst.make_band_solver
    solve = make(dsky, N_ST, t(cidx).long(), cmask, fd, NU, ITMAX,
                 loss=loss)
    W = len(bands)
    like = torch.zeros((), dtype=torch.float64)
    mems = [tl.lbfgs_memory_init(p0.size, N_MEM, like) for _ in range(W)]
    ps = [t(p0)] * W
    out = []
    for u, v, w, s1, s2, bd in _minibatches(tile, bands):
        geo = [t(u), t(v), t(w), t(s1).long(), t(s2).long()]
        if batched:
            o = solve(t(np.stack([b[0] for b in bd])), *geo,
                      t(np.stack([b[1] for b in bd])), [b[2] for b in bd],
                      torch.stack(ps), tl.stack_memories(mems))
            ps = list(o.p)
            mems = [tl.lane_memory(o.mem, b) for b in range(W)]
            out.append((o.p.numpy(), o.res_0.numpy(), o.res_1.numpy(),
                        np.asarray(o.iters)))
        else:
            rec = []
            for b in range(W):
                o = solve(t(bd[b][0]), *geo, t(bd[b][1]), bd[b][2], ps[b],
                          mems[b])
                ps[b], mems[b] = o.p, o.mem
                rec.append((o.p.numpy(), float(o.res_0), float(o.res_1),
                            o.iters))
            out.append(tuple(np.stack([np.asarray(r[i]) for r in rec])
                             for i in range(4)))
    return out


def _assert_same(got, want):
    for (p, r0, r1, k), (wp, wr0, wr1, wk) in zip(got, want):
        np.testing.assert_allclose(p, wp, atol=1e-8)
        np.testing.assert_allclose(r0, wr0, rtol=1e-10)
        np.testing.assert_allclose(r1, wr1, rtol=1e-10)
        np.testing.assert_array_equal(k, wk)


@pytest.mark.parametrize("loss", ["robust", "huber"])
def test_band_solver_matches_reference(problem, loss):
    sky, tile = problem
    got = _torch_solves(sky, tile, BANDS2, loss, batched=False)
    _assert_same(got, _jax_solves(sky, tile, BANDS2, loss, batched=False))
    # the solves moved: the residual fell on every band
    assert all((r1 < r0).all() for _, r0, r1, _ in got)


@pytest.mark.parametrize("loss", ["robust", "huber"])
@pytest.mark.parametrize("bands", [BANDS2, BANDS3], ids=["W2", "W3_padded"])
def test_batched_band_solver_matches_reference(problem, loss, bands):
    sky, tile = problem
    got = _torch_solves(sky, tile, bands, loss, batched=True)
    _assert_same(got, _jax_solves(sky, tile, bands, loss, batched=True))


@pytest.mark.parametrize("loss", ["robust", "huber"])
@pytest.mark.parametrize("bands", [BANDS2, BANDS3], ids=["W2", "W3_padded"])
def test_batched_band_solver_matches_single_band_solves(problem, loss,
                                                        bands):
    sky, tile = problem
    _assert_same(_torch_solves(sky, tile, bands, loss, batched=True),
                 _torch_solves(sky, tile, bands, loss, batched=False))


def test_model8_multifreq_matches_reference(problem):
    sky, tile = problem
    rng = np.random.default_rng(0)
    kmax, _, cidx, _ = _common(sky)
    M, B, F = sky.n_clusters, cidx.shape[1], 3
    J = (rng.normal(size=(M, kmax, N_ST, 2, 2))
         + 1j * rng.normal(size=(M, kmax, N_ST, 2, 2)))
    coh = (rng.normal(size=(M, B, F, 2, 2))
           + 1j * rng.normal(size=(M, B, F, 2, 2)))
    s1, s2 = tile.sta1[:B], tile.sta2[:B]
    want = np.asarray(jst.model8_multifreq(jnp.asarray(J), jnp.asarray(coh),
                                           jnp.asarray(s1), jnp.asarray(s2),
                                           jnp.asarray(cidx)))
    t = torch.as_tensor
    got = tst.model8_multifreq(t(J), t(coh), t(s1), t(s2), t(cidx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    lanes = tst.model8_multifreq(t(np.stack([J, 2 * J])),
                                 t(np.stack([coh, coh])), t(s1), t(s2),
                                 t(cidx))
    np.testing.assert_allclose(lanes[1].numpy(), 4 * want, rtol=1e-12,
                               atol=1e-12)
