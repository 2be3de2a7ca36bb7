"""The port's extended-source envelopes (``sagecal_tpu_torch/rime/
envelopes.py``) against ``sagecal_tpu.rime.envelopes`` in float64, at rtol
1e-12 (atol 1e-12 of the largest magnitude): the gaussian with and
without projection, ring and disk on arguments straddling the |x| = 8
branch of the Bessel approximations, the Hermite basis and the shapelet
at n0max 1..6, the shapelet sign tables exactly, and ``apply_envelopes``
on a mixed [B, S] grid with padded lanes (eX = eY = 0, zero modes)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import skymodel
from sagecal_tpu.rime import envelopes as env
from sagecal_tpu_torch.rime import envelopes as tenv

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _grid(B=29, S=7, seed=0):
    """uvw in wavelengths [B, 1] and per-source frames [1, S] (numpy)."""
    rng = np.random.default_rng(seed)
    u, v = (rng.normal(0, 400, (B, 1)) for _ in range(2))
    w = rng.normal(0, 40, (B, 1))
    xi = rng.uniform(-np.pi, np.pi, (1, S))
    phi = rng.uniform(0, 0.2, (1, S))
    frame = dict(cxi=np.cos(xi), sxi=np.sin(-xi), cphi=np.cos(phi),
                 sphi=np.sin(-phi))
    return u, v, w, frame, rng


def _both(fn_j, fn_t, *args, **kw):
    """(port, JAX) results of the same call on numpy arguments."""
    conv = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
            for a in args]
    got = fn_t(*conv, **kw)
    want = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in args], **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("project", [False, True])
def test_gaussian_matches(project):
    u, v, w, fr, rng = _grid()
    S = fr["cxi"].shape[1]
    eX, eY = rng.uniform(1e-4, 4e-3, (2, 1, S))
    eP = rng.uniform(0, np.pi, (1, S))
    proj = np.full((1, S), project)
    _close(*_both(env.gaussian, tenv.gaussian, u, v, w, eX, eY, eP,
                  fr["cxi"], fr["sxi"], fr["cphi"], fr["sphi"], proj))


@pytest.mark.parametrize("kind", ["ring", "disk"])
def test_ring_disk_straddle_branch(kind):
    """eX spread so that 2 pi |uv| eX runs from ~0 to ~20 (both branches
    of the rational approximations, and the switch at |x| = 8)."""
    u, v, w, fr, rng = _grid(B=101)
    S = fr["cxi"].shape[1]
    eX = np.geomspace(1e-6, 8e-3, S)[None, :]
    args = (u, v, w, eX, fr["cxi"], fr["sxi"], fr["cphi"], fr["sphi"])
    x = tenv._ring_disk_arg(*(torch.as_tensor(a) for a in args)).numpy()
    assert x.min() < 1.0 and (x < 8.0).sum() > 50 and (x > 8.0).sum() > 50
    fj, ft = getattr(env, kind), getattr(tenv, kind)
    _close(*_both(fj, ft, *args))


@pytest.mark.parametrize("fn", ["_bessel_j0", "_bessel_j1"])
def test_bessel_on_both_sides_of_eight(fn):
    x = np.concatenate([np.linspace(-20, 20, 401), [0.0, 8.0 - 1e-12, 8.0,
                                                    -8.0, 1e-40]])
    _close(*_both(getattr(env, fn), getattr(tenv, fn), x))


@pytest.mark.parametrize("n0max", range(1, 7))
def test_hermite_basis_matches(n0max):
    x = np.random.default_rng(n0max).normal(0, 2.0, (13, 5))
    _close(*_both(lambda a, n: env._hermite_basis(a, n),
                  lambda a, n: tenv._hermite_basis(a, n), x, n0max))


@pytest.mark.parametrize("n0max", range(1, 7))
def test_shapelet_sign_tables_exact(n0max):
    for got, want in zip(tenv.shapelet_sign_tables(n0max),
                         env.shapelet_sign_tables(n0max)):
        np.testing.assert_array_equal(got, want)


def _shapelet_args(n0max, project, seed=3):
    u, v, w, fr, rng = _grid(seed=seed)
    S = fr["cxi"].shape[1]
    eX, eY = rng.uniform(0.5, 1.5, (2, 1, S))
    eP = rng.uniform(0, np.pi, (1, S))
    beta = rng.uniform(2e-3, 2e-2, (1, S))
    n0 = rng.integers(1, n0max + 1, (1, S))
    modes = np.zeros((1, S, n0max, n0max))
    for s in range(S):
        modes[0, s, :n0[0, s], :n0[0, s]] = rng.normal(
            0, 1, (n0[0, s], n0[0, s]))
    proj = np.full((1, S), project)
    return (u, v, w, eX, eY, eP, beta, modes.reshape(1, S, -1), n0, n0max,
            fr["cxi"], fr["sxi"], fr["cphi"], fr["sphi"], proj)


@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("n0max", range(1, 7))
def test_shapelet_matches(n0max, project):
    _close(*_both(env.shapelet, tenv.shapelet,
                  *_shapelet_args(n0max, project)))


@pytest.mark.parametrize("with_shapelets", [False, True])
def test_apply_envelopes_mixed_grid_with_padding(with_shapelets):
    """Every morphology on one [B, S] grid; the last two lanes are padded
    (point type, eX = eY = 0, zero modes) as the split's rest pads."""
    n0max = 4
    (u, v, w, eX, eY, eP, beta, modes, n0, _, cxi, sxi, cphi, sphi,
     _) = _shapelet_args(n0max, True, seed=7)
    S = eX.shape[1]
    stype = np.array([[skymodel.STYPE_POINT, skymodel.STYPE_GAUSSIAN,
                       skymodel.STYPE_DISK, skymodel.STYPE_RING,
                       skymodel.STYPE_SHAPELET, skymodel.STYPE_POINT,
                       skymodel.STYPE_POINT]], np.int32)
    assert stype.shape[1] == S
    eX[0, 2:4] = [3e-3, 5e-3]
    eX[0, 5:], eY[0, 5:], beta[0, 5:] = 0.0, 0.0, 0.0
    modes[0, 5:] = 0.0
    rng = np.random.default_rng(11)
    phase = rng.uniform(0, 2 * np.pi, (u.shape[0], S))
    phasor = np.exp(1j * phase)
    proj = np.array([[True, False, True, True, False, False, True]])
    args = (phasor, stype, u, v, w, eX, eY, eP, cxi, sxi, cphi, sphi, proj,
            beta, modes, n0, n0max, with_shapelets)
    got, want = _both(env.apply_envelopes, tenv.apply_envelopes, *args)
    _close(got, want)
