"""``-W 1`` whitening (sagecal_tpu_torch/solvers/robust.py ``ncp_weight``,
``whiten_data``) against the JAX package in float64, rtol 1e-12, on u, v
whose uv distances at freq0 straddle the flat edge at 400 wavelengths,
for the real [B, 8] solve input and complex [B, F, 2, 2] rows."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import robust as rb
from sagecal_tpu_torch.solvers import robust as trb

FREQ0 = 150e6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uv(B=400, seed=0):
    """u, v in seconds: uv distances 0-800 wavelengths at FREQ0, with
    rows exactly at and next to 400."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 800.0, B)
    d[:4] = [400.0, np.nextafter(400.0, 0), np.nextafter(400.0, 1e3), 0.0]
    th = rng.uniform(0, 2 * np.pi, B)
    return d * np.cos(th) / FREQ0, d * np.sin(th) / FREQ0


def test_ncp_weight_matches_reference():
    d = np.concatenate([np.linspace(0, 800, 801),
                        [np.nextafter(400.0, 0), np.nextafter(400.0, 1e3)]])
    want = np.asarray(rb.ncp_weight(jnp.asarray(d)))
    got = trb.ncp_weight(torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.all(got[d > 400] == 1.0) and np.all(got[d <= 400] < 1.0)


@pytest.mark.parametrize("shape", [(8,), (3, 2, 2)], ids=["x8", "vis"])
def test_whiten_data_matches_reference(shape):
    u, v = _uv()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(len(u),) + shape)
    if len(shape) > 1:
        x = x + 1j * rng.normal(size=x.shape)
    want = np.asarray(rb.whiten_data(jnp.asarray(x), jnp.asarray(u),
                                     jnp.asarray(v), FREQ0))
    got = trb.whiten_data(torch.as_tensor(x), torch.as_tensor(u),
                          torch.as_tensor(v), FREQ0).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-12)
    uvd = np.hypot(u, v) * FREQ0
    far = uvd > 400.0
    np.testing.assert_array_equal(got[far], x[far])
    assert np.all(np.abs(got[~far]) <= np.abs(x[~far]))
