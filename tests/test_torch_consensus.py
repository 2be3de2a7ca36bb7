"""The port's consensus functions against the JAX package in float64 on
the same seeded inputs: the polynomial basis (types 0-3), the per-cluster
pseudo-inverse (with the federated alpha), the Z update, B Z, the soft
threshold and the Barzilai-Borwein rho (``consensus/poly.py``); the 2x2
polar factor, the Procrustes projection and the manifold average
(``consensus/manifold.py``); the MDL/AIC order scan (``consensus/
mdl.py``); the spherical-harmonic basis, the padded Phi, the FISTA prox
and the Z block reshapes (``consensus/spatial.py``). Within 1e-10
relative to each output's largest magnitude (the basis exactly), the BB
decisions equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.consensus import manifold as mf
from sagecal_tpu.consensus import mdl
from sagecal_tpu.consensus import poly as cpoly
from sagecal_tpu.consensus import spatial as sp
from sagecal_tpu_torch.consensus import manifold as tmf
from sagecal_tpu_torch.consensus import mdl as tmdl
from sagecal_tpu_torch.consensus import poly as tpoly
from sagecal_tpu_torch.consensus import spatial as tsp

TOL = 1e-10


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


FREQS = 150e6 * (1 + 0.03 * np.arange(5))


@pytest.mark.parametrize("ptype", [0, 1, 2, 3])
@pytest.mark.parametrize("npoly", [1, 3, 4])
def test_setup_polynomials_matches_reference(ptype, npoly):
    np.testing.assert_array_equal(
        tpoly.setup_polynomials(FREQS, FREQS.mean(), npoly, ptype),
        cpoly.setup_polynomials(FREQS, FREQS.mean(), npoly, ptype))


@pytest.mark.parametrize("alpha", [False, True])
def test_find_prod_inverse_and_z_update(alpha):
    rng = np.random.default_rng(1)
    B = cpoly.setup_polynomials(FREQS, FREQS.mean(), 3, 2)
    rho = rng.uniform(1.0, 4.0, size=(4, len(FREQS)))
    al = rng.uniform(0.1, 1.0, size=4) if alpha else None
    want = cpoly.find_prod_inverse(jnp.asarray(B), jnp.asarray(rho),
                                   None if al is None else jnp.asarray(al))
    got = tpoly.find_prod_inverse(torch.as_tensor(B), torch.as_tensor(rho),
                                  None if al is None else torch.as_tensor(al))
    _close(got, want)
    zsum = rng.normal(size=(4, 3, 2, 5, 8))
    _close(tpoly.z_from_contributions(torch.as_tensor(zsum), got),
           cpoly.z_from_contributions(jnp.asarray(zsum), want))
    Z = rng.normal(size=(4, 3, 2, 5, 8))
    _close(tpoly.bz(torch.as_tensor(Z), torch.as_tensor(B[2])),
           cpoly.bz(jnp.asarray(Z), B[2]))
    _close(tpoly.soft_threshold(torch.as_tensor(Z), 0.3),
           cpoly.soft_threshold(jnp.asarray(Z), 0.3))


def test_find_prod_inverse_singular():
    """A rank-deficient sum (one frequency, two terms): the pseudo-inverse
    drops the null direction as the reference does."""
    B = cpoly.setup_polynomials(FREQS[:1], FREQS[0], 2, 0)
    rho = np.full((2, 1), 2.0)
    _close(tpoly.find_prod_inverse(torch.as_tensor(B), torch.as_tensor(rho)),
           cpoly.find_prod_inverse(jnp.asarray(B), jnp.asarray(rho)))


def test_update_rho_bb_matches_reference():
    """Correlated, anti-correlated and tiny steps: each cluster's decision
    (update or keep) and value as in the JAX package."""
    rng = np.random.default_rng(2)
    M = 6
    dJ = rng.normal(size=(M, 2, 3, 8))
    dY = 2.5 * dJ + 0.3 * rng.normal(size=dJ.shape)
    dY[1] = -dY[1]                       # anti-correlated: keep
    dY[2] *= 1e-9                        # tiny alphahat: keep
    dY[3] = 40.0 * dJ[3]                 # above rho_upper: keep
    rho = np.full(M, 2.0)
    upper = np.full(M, 20.0)
    want = cpoly.update_rho_bb(jnp.asarray(rho), jnp.asarray(upper),
                               jnp.asarray(dY), jnp.asarray(dJ), (1, 2, 3))
    got = tpoly.update_rho_bb(torch.as_tensor(rho), torch.as_tensor(upper),
                              torch.as_tensor(dY), torch.as_tensor(dJ),
                              (1, 2, 3))
    np.testing.assert_array_equal(got.numpy() == 2.0, np.asarray(want) == 2.0)
    _close(got, want)


def test_polar_and_procrustes_match_reference():
    rng = np.random.default_rng(3)
    A = _cplx(rng, (7, 2, 2))
    _close(tmf.polar_unitary_2x2(torch.as_tensor(A)),
           mf.polar_unitary_2x2(jnp.asarray(A)))
    X, Y = _cplx(rng, (3, 10, 2)), _cplx(rng, (3, 10, 2))
    _close(tmf.procrustes_project(torch.as_tensor(X), torch.as_tensor(Y)),
           mf.procrustes_project(jnp.asarray(X), jnp.asarray(Y)))
    H = np.einsum("kji,kjl->kil", A.conj(), A)
    _close(tmf._herm_invsqrt_2x2(torch.as_tensor(H)),
           mf._herm_invsqrt_2x2(jnp.asarray(H)))


def test_manifold_average_matches_reference():
    """Random unitary rotations of one base per frequency: the port's
    average equals the JAX package's, and the subbands agree after it."""
    rng = np.random.default_rng(4)
    nf, M, N = 4, 3, 5
    base = _cplx(rng, (M, N, 2, 2))
    J = np.stack([base @ np.asarray(mf.polar_unitary_2x2(
        jnp.asarray(_cplx(rng, (M, 1, 2, 2))))) for _ in range(nf)])
    J = J + 0.01 * _cplx(rng, J.shape)
    want = mf.manifold_average(jnp.asarray(J), niter=5)
    got = tmf.manifold_average(torch.as_tensor(J), niter=5)
    _close(got, want)
    out = got.numpy()
    assert np.abs(out - out.mean(axis=0)).max() < 0.1


@pytest.mark.parametrize("polytype", [1, 2, 3])
def test_mdl_matches_reference(polytype):
    rng = np.random.default_rng(5)
    F, M = len(FREQS), 3
    J = rng.normal(size=(F, M, 2, 4, 8))
    rho = np.array([1.0, 2.0, 4.0])
    w = rng.uniform(0.5, 1.0, size=F)
    want = mdl.minimum_description_length(J, rho, FREQS, FREQS.mean(),
                                          weight=w, polytype=polytype,
                                          kstart=1, kfinish=4)
    got = tmdl.minimum_description_length(J, rho, FREQS, FREQS.mean(),
                                          weight=w, polytype=polytype,
                                          kstart=1, kfinish=4)
    assert got["orders"] == want["orders"]
    assert (got["best_aic"], got["best_mdl"]) == (want["best_aic"],
                                                  want["best_mdl"])
    _close(got["aic"], want["aic"])
    _close(got["mdl"], want["mdl"])
    lines = []
    tmdl.report(got, log=lines.append)
    assert lines[0].startswith("Finding best fitting polynomials: MDL")


class _Sky:
    """The fields of a ClusterSky that cluster_polar_coords reads."""

    def __init__(self, rng, M=3, S=4):
        self.n_clusters = M
        self.sI = rng.uniform(0.5, 2.0, (M, S))
        self.sQ = self.sU = self.sV = np.zeros((M, S))
        self.smask = np.ones((M, S), bool)
        self.smask[2, 3] = False
        self.ll = rng.normal(0, 0.05, (M, S))
        self.mm = rng.normal(0, 0.05, (M, S))
        self.nchunk = np.array([1, 2, 1])


def test_spatial_basis_and_fista_match_reference():
    rng = np.random.default_rng(6)
    sky = _Sky(rng)
    rr, tt = sp.cluster_polar_coords(sky)
    trr, ttt = tsp.cluster_polar_coords(sky)
    np.testing.assert_array_equal(trr, rr)
    np.testing.assert_array_equal(ttt, tt)
    _close(tsp.sharmonic_basis(3, rr, tt), sp.sharmonic_basis(3, rr, tt))
    cmask = np.arange(2)[None, :] < sky.nchunk[:, None]
    Phi, Phikk = sp.phi_padded(cmask, rr, tt, 3, 0.1)
    tPhi, tPhikk = tsp.phi_padded(cmask, rr, tt, 3, 0.1)
    _close(tPhi, Phi)
    _close(tPhikk, Phikk)
    Zbar = _cplx(rng, (Phi.shape[0], 12, 2))
    want = sp.fista_spatialreg(jnp.asarray(Zbar), jnp.asarray(Phikk),
                               jnp.asarray(Phi), 0.05, 20)
    got = tsp.fista_spatialreg(torch.as_tensor(Zbar),
                               torch.as_tensor(Phikk), torch.as_tensor(Phi),
                               0.05, 20)
    _close(got, want)
    _close(tsp.spatial_predict(got, torch.as_tensor(Phi)),
           sp.spatial_predict(want, jnp.asarray(Phi)))


def test_z_block_reshapes_match_reference():
    rng = np.random.default_rng(7)
    Z = rng.normal(size=(3, 2, 2, 5, 8))
    want = sp.z_r8_to_blocks(jnp.asarray(Z))
    got = tsp.z_r8_to_blocks(torch.as_tensor(Z))
    _close(got, want)
    np.testing.assert_array_equal(
        tsp.blocks_to_z_r8(got, 3, 2, 2, 5).numpy(), Z)
