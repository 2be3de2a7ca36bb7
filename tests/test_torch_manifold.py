"""The phase-only correction (``-J 1``): sagecal_tpu_torch/consensus/
manifold.py ``extract_phases`` against the JAX package's (per chunk, as
its vmap) at atol 1e-10, on random J, identity J (the 3x3 form is then
exactly 0 and the result rests on the eigensolver's basis for it), diagonal
J and J with an all-zero station; the Givens pair against JAX's; and
``rime/residual.correct_by_cluster(phase_only=True)`` against JAX at
1e-10 of max|res|. The card's eigensolver is held against the CPU on
identity and random J by chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.consensus import manifold as mf
from sagecal_tpu.rime import residual as rr
from sagecal_tpu_torch.consensus import manifold as tmf
from sagecal_tpu_torch.rime import residual as trr

N = 9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jones(kind, K=3, seed=0):
    rng = np.random.default_rng(seed)
    rand = rng.normal(size=(K, N, 2, 2)) + 1j * rng.normal(size=(K, N, 2, 2))
    if kind == "random":
        return rand
    if kind == "identity":
        return np.tile(np.eye(2, dtype=complex), (K, N, 1, 1))
    if kind == "diagonal":
        return rand * np.eye(2)
    if kind == "zero_station":
        rand[:, 4] = 0.0
        return rand
    raise ValueError(kind)


KINDS = ["random", "identity", "diagonal", "zero_station"]


@pytest.mark.parametrize("kind", KINDS)
def test_extract_phases_matches_reference(kind):
    J = _jones(kind)
    want = np.asarray(jax.vmap(mf.extract_phases)(jnp.asarray(J)))
    got = tmf.extract_phases(torch.as_tensor(J)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    # unit-modulus diagonals (0 at a station whose J is 0), zero
    # off-diagonals
    live = np.abs(J).sum(axis=(-2, -1)) > 0
    np.testing.assert_allclose(np.abs(got[..., [0, 1], [0, 1]])[live], 1.0,
                               atol=1e-12)
    assert not got[~live].any()
    assert not got[..., 0, 1].any() and not got[..., 1, 0].any()


def test_identity_phases_are_not_trivial():
    """The form of identity J is exactly 0: the eigensolver's e3 gives
    a non-trivial first rotation, so the result is not the identity, in
    both packages alike (the case chip_smoke holds the card to)."""
    got = tmf.extract_phases(torch.as_tensor(_jones("identity"))).numpy()
    assert not np.allclose(got, np.eye(2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_givens_from_eigvec_matches_reference(seed):
    Z = np.random.default_rng(seed).normal(size=(5, 3))
    Z /= np.linalg.norm(Z, axis=-1, keepdims=True)
    Z[0, 0] = 0.0
    Z[1, 0] = -0.0
    c, s = tmf._givens_from_eigvec(torch.as_tensor(Z))
    for i, z in enumerate(Z):
        cw, sw = mf._givens_from_eigvec(jnp.asarray(z))
        np.testing.assert_allclose(complex(c[i]), complex(cw), atol=1e-15)
        np.testing.assert_allclose(complex(s[i]), complex(sw), atol=1e-15)


@pytest.mark.parametrize("kind", KINDS)
def test_phase_only_correction_matches_reference(kind):
    rng = np.random.default_rng(5)
    T = 3
    p, q = np.triu_indices(N, k=1)
    B = T * len(p)
    K = 3
    res = rng.normal(size=(B, 2, 2, 2)) + 1j * rng.normal(size=(B, 2, 2, 2))
    J = _jones(kind, K)
    cidx = np.minimum(np.arange(B) // len(p), K - 1)
    s1, s2 = np.tile(p, T), np.tile(q, T)
    want = np.asarray(rr.correct_by_cluster(
        jnp.asarray(res), jnp.asarray(J), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(cidx), 1e-9, phase_only=True))
    got = trr.correct_by_cluster(
        torch.as_tensor(res), torch.as_tensor(J), torch.as_tensor(s1),
        torch.as_tensor(s2), torch.as_tensor(cidx), 1e-9,
        phase_only=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(res).max())
    # the phases alone correct otherwise than the full solutions
    full = trr.correct_by_cluster(
        torch.as_tensor(res), torch.as_tensor(J), torch.as_tensor(s1),
        torch.as_tensor(s2), torch.as_tensor(cidx), 1e-9).numpy()
    assert not np.allclose(got, full)
