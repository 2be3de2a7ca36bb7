"""Port residual write-back path (sagecal_tpu_torch/rime/residual.py and
the uv cut of rime/predict.py) against the JAX reference in float64:
the same per-channel model subtraction, the MMSE-regularized ``-k``
correction and the ``-x/-y`` flagging (rtol 1e-10: the same maths in
another summation order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import skymodel
from sagecal_tpu.rime import predict as rp
from sagecal_tpu.rime import residual as rr
from sagecal_tpu_torch import convert
from sagecal_tpu_torch.rime import predict as trp
from sagecal_tpu_torch.rime import residual as trr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sky():
    rng = np.random.default_rng(4)
    srcs, clusters = {}, []
    for m in range(3):
        names = []
        for s in range(3):
            nm = f"{'G' if s == 0 else 'P'}{m}_{s}"
            ll, mm = rng.normal(0, 0.02, 2)
            srcs[nm] = skymodel.Source(
                name=nm, ra=0, dec=0, ll=ll, mm=mm,
                nn=np.sqrt(1 - ll * ll - mm * mm) - 1,
                sI=float(rng.uniform(0.5, 3)), sQ=0.1, sU=0.05, sV=0.0,
                sI0=2.0, sQ0=0.1, sU0=0.05, sV0=0.0, spec_idx=-0.7,
                spec_idx1=0.1, spec_idx2=0.0, f0=150e6,
                stype=skymodel.STYPE_GAUSSIAN if s == 0
                else skymodel.STYPE_POINT,
                eX=4e-3 if s == 0 else 0.0, eY=2e-3 if s == 0 else 0.0,
                eP=0.3)
            names.append(nm)
        clusters.append((m if m < 2 else -1, 1 + m, names))
    return skymodel.build_cluster_sky(srcs, clusters)


def _problem(seed=0, N=5, T=4, F=3):
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    B = T * len(p)
    sky = _sky()
    K = int(sky.nchunk.max())
    cidx = np.stack([np.minimum((np.arange(B) // len(p)) // -(-T // k),
                                k - 1) for k in sky.nchunk])
    J = (rng.normal(size=(3, K, N, 2, 2))
         + 1j * rng.normal(size=(3, K, N, 2, 2))) * 0.2 + np.eye(2)
    x = (rng.normal(size=(B, F, 2, 2)) + 1j * rng.normal(size=(B, F, 2, 2)))
    uvw = rng.normal(0, 2e-6, (3, B))
    freqs = np.array([145e6, 150e6, 155e6])[:F]
    return sky, J, x, uvw, freqs, np.tile(p, T), np.tile(q, T), cidx


@pytest.mark.parametrize("correct", [None, 1])
def test_residuals_match_reference(correct):
    sky, J, x, uvw, freqs, s1, s2, cidx = _problem()
    dsky = rp.sky_to_device(sky, jnp.float64)
    want = np.asarray(rr.calculate_residuals_multifreq(
        dsky, jnp.asarray(J), jnp.asarray(x), *map(jnp.asarray, uvw),
        jnp.asarray(freqs), 0.06e6, jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(cidx), jnp.asarray(sky.subtract_mask()),
        correct_idx=correct, rho=1e-9))
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    t = lambda a: torch.as_tensor(np.array(a))
    got = trr.calculate_residuals_multifreq(
        tsky, t(J), t(x), *map(t, uvw), t(freqs), 0.06e6, t(s1).long(),
        t(s2).long(), t(cidx).long(), sky.subtract_mask(),
        correct_idx=correct, rho=1e-9).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())
    # the negative-id cluster is solved for but never subtracted
    assert not sky.subtract_mask()[2]


def test_mmse_inverse_matches_reference():
    rng = np.random.default_rng(1)
    J = rng.normal(size=(4, 6, 2, 2)) + 1j * rng.normal(size=(4, 6, 2, 2))
    J[0, 0] = [[1e-12, 0], [0, 1e-12]]          # nearly singular: det nudge
    want = np.asarray(rr.mmse_inverse(jnp.asarray(J), 1e-3))
    got = trr.mmse_inverse(torch.as_tensor(J), 1e-3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_uvcut_flags_match_reference():
    rng = np.random.default_rng(2)
    u, v = rng.normal(0, 3e-6, (2, 50))
    flags = rng.integers(0, 2, 50).astype(np.int32)
    freqs = np.array([140e6, 160e6])
    want = np.asarray(rp.uvcut_flags(jnp.asarray(flags), jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(freqs),
                                     200.0, 700.0))
    got = trp.uvcut_flags(torch.as_tensor(flags), torch.as_tensor(u),
                          torch.as_tensor(v), torch.as_tensor(freqs),
                          200.0, 700.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 2).any() and (got == 0).any()
