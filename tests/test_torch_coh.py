"""Port coherency kernel module (sagecal_tpu_torch/ops/coh.py) against
the JAX reference: its plain PyTorch version must match the Pallas
kernel in interpret mode (float32, the tolerance of
tests/test_pallas.py) and the XLA predict path in float64 (rtol 1e-10:
the same maths summed in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import skymodel
from sagecal_tpu.ops import coh_pallas
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import convert
from sagecal_tpu_torch.ops import coh as tcoh
from sagecal_tpu_torch.rime import predict as trp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def point_sky(n_clusters=2, n_src=3, seed=0):
    """The tests/test_pallas.py point-source model."""
    rng = np.random.default_rng(seed)
    srcs, clusters = {}, []
    for m in range(n_clusters):
        names = []
        for s in range(n_src):
            nm = f"P{m}_{s}"
            ll, mm = rng.normal(0, 0.02, 2)
            nn = np.sqrt(1 - ll * ll - mm * mm)
            srcs[nm] = skymodel.Source(
                name=nm, ra=0, dec=0, ll=ll, mm=mm, nn=nn - 1,
                sI=float(rng.uniform(0.5, 3)), sQ=0.2, sU=0.1, sV=-0.05,
                sI0=2.0, sQ0=0.2, sU0=0.1, sV0=-0.05,
                spec_idx=-0.7, spec_idx1=0.0, spec_idx2=0.0, f0=150e6)
            names.append(nm)
        clusters.append((m, 1, names))
    return skymodel.build_cluster_sky(srcs, clusters)


def gaussian_sky(seed=3, project=True):
    """The tests/test_pallas.py mixed point + gaussian model."""
    sky = point_sky(seed=seed)
    rng = np.random.default_rng(seed)
    for m in range(sky.stype.shape[0]):
        sky.stype[m, 0] = skymodel.STYPE_GAUSSIAN
        sky.eX[m, 0] = 2 * 0.002
        sky.eY[m, 0] = 2 * 0.001
        sky.eP[m, 0] = float(rng.random())
        if project:
            xi = float(rng.random())
            phi = float(rng.random())
            sky.cxi[m, 0], sky.sxi[m, 0] = np.cos(xi), np.sin(xi)
            sky.cphi[m, 0], sky.sphi[m, 0] = np.cos(phi), np.sin(phi)
            sky.use_projection[m, 0] = True
    return sky


SKIES = {"point": lambda: point_sky(),
         "gauss_noproj": lambda: gaussian_sky(project=False),
         "gauss_proj": lambda: gaussian_sky(project=True)}


def _inputs(dtype, seed=1, B=37):
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 2e-6, B)
    v = rng.normal(0, 2e-6, B)
    w = rng.normal(0, 2e-7, B)
    freqs = np.array([140e6, 150e6, 160e6])
    return [np.asarray(a, dtype) for a in (u, v, w, freqs)]


def _port(sky, arrs, fdelta, per_channel, dtype):
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields},
        real_dtype=dtype)
    u, v, w, f = (torch.as_tensor(a).to(dtype) for a in arrs)
    return trp.coherencies(tsky, u, v, w, f, fdelta,
                           per_channel_flux=per_channel).numpy()


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("kind", sorted(SKIES))
def test_plain_matches_pallas_interpret_f32(kind, per_channel):
    sky = SKIES[kind]()
    arrs = _inputs(np.float32)
    want = np.asarray(coh_pallas.coherencies(
        rp.sky_to_device(sky, jnp.float32),
        *[jnp.asarray(a) for a in arrs], 0.18e6,
        per_channel_flux=per_channel, block_b=16, interpret=True))
    got = _port(sky, arrs, 0.18e6, per_channel, torch.float32)
    assert got.shape == want.shape == (2, 37, 3, 2, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("kind", sorted(SKIES))
def test_plain_matches_xla_predict_f64(kind, per_channel):
    sky = SKIES[kind]()
    arrs = _inputs(np.float64)
    want = np.asarray(rp.coherencies(
        rp.sky_to_device(sky, jnp.float64),
        *[jnp.asarray(a) for a in arrs], 0.18e6,
        per_channel_flux=per_channel))
    got = _port(sky, arrs, 0.18e6, per_channel, torch.float64)
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_supported_matches_reference():
    sky = point_sky()
    assert tcoh.supported(sky) == coh_pallas.supported(sky)
    sky.stype[0, 1] = skymodel.STYPE_SHAPELET
    assert not tcoh.supported(sky)
    assert tcoh.supported(sky) == coh_pallas.supported(sky)


def test_extended_sources_raise():
    sky = point_sky()
    sky.stype[0, 1] = skymodel.STYPE_DISK
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    z = torch.zeros(5, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trp.coherencies(tsky, z, z, z, torch.tensor([150e6]), 0.18e6)


def test_gauss_coeffs_and_weights_match():
    sky = gaussian_sky()
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    np.testing.assert_allclose(tcoh.gauss_coeffs(tsky).numpy(),
                               np.asarray(coh_pallas.gauss_coeffs(dsky)),
                               rtol=1e-14, atol=1e-16)
    f = np.array([140e6, 160e6])
    np.testing.assert_allclose(
        tcoh.stokes_weights(tsky, torch.as_tensor(f), True).numpy(),
        np.asarray(coh_pallas.stokes_weights(dsky, jnp.asarray(f), True)),
        rtol=1e-13)

