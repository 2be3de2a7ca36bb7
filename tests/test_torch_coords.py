"""The port's coordinate transforms (sagecal_tpu_torch/coords.py) against
the JAX package's (sagecal_tpu/coords.py), float64, on inputs drawn with
numpy from a seed: every function to 1e-12 (absolute on angles, relative
on heights)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import coords as jc
from sagecal_tpu_torch import coords as tc

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(14)
RA = RNG.uniform(0, 2 * np.pi, 17)
DEC = RNG.uniform(-1.2, 1.4, 17)
LON = RNG.uniform(-0.5, 0.5, 17)
LAT = RNG.uniform(0.5, 1.1, 17)
JD = 2451545.0 + RNG.uniform(-4000, 9000, 17)
T = torch.as_tensor


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def test_xyz2llh():
    xyz = np.array([[3826577.1, 461022.9, 5064892.7],
                    [3826896.2, 460979.1, 5064658.2],
                    [-2.0e6, 5.0e6, -3.0e6]])
    got = tc.xyz2llh(*(T(xyz[:, i]) for i in range(3)))
    ref = jc.xyz2llh(*(jnp.asarray(xyz[:, i]) for i in range(3)))
    for g, r in zip(got[:2], ref[:2]):
        _close(g, r)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(ref[2]),
                               rtol=TOL, atol=1e-6)


def test_jd2gmst_and_host_version():
    _close(tc.jd2gmst(T(JD)), jc.jd2gmst(jnp.asarray(JD)))
    _close(tc.jd2gmst_np(JD), jc.jd2gmst_np(JD), 0.0)
    # before J2000 too: the sign carried through the modulus
    early = np.array([2400000.5, 2415020.0, 2451544.0])
    _close(tc.jd2gmst(T(early)), jc.jd2gmst(jnp.asarray(early)))


@pytest.mark.parametrize("fn", ["radec2azel_gmst", "radec2azel"])
def test_radec2azel(fn):
    last = jc.jd2gmst_np(JD) if fn == "radec2azel_gmst" else JD
    got = getattr(tc, fn)(T(RA), T(DEC), T(LON), T(LAT), T(last))
    ref = getattr(jc, fn)(*(jnp.asarray(a) for a in (RA, DEC, LON, LAT,
                                                     last)))
    for g, r in zip(got, ref):
        _close(g, r)


def test_precession_matrix():
    for jd in (2451545.0, 2459000.5, 2440000.25):
        _close(tc.precession_matrix(jd), jc.precession_matrix(jd))


@pytest.mark.parametrize("fn", ["precess_radec_std", "precess_radec"])
def test_precess(fn):
    pm = 2459000.5
    got = getattr(tc, fn)(T(RA), T(DEC), tc.precession_matrix(pm))
    ref = getattr(jc, fn)(jnp.asarray(RA), jnp.asarray(DEC),
                          jc.precession_matrix(pm))
    for g, r in zip(got, ref):
        _close(g, r)


def test_radec_to_lmn():
    got = tc.radec_to_lmn(T(RA[:8]), T(DEC[:8] * 0.1 + 0.7), 0.3, 0.7)
    ref = jc.radec_to_lmn(jnp.asarray(RA[:8]), jnp.asarray(DEC[:8] * 0.1
                                                           + 0.7), 0.3, 0.7)
    for g, r in zip(got, ref):
        _close(g, r)
