"""The port's CUDA kernels on the card (marker ``cuda``; skipped on a
machine without a CUDA device). This file imports neither jax nor the
JAX package, so it runs on a card machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

Each kernel is held against its plain PyTorch version in float32 at
max|diff| <= 1e-4 max|ref| (the chip_smoke.py gate), and a CUDA tensor
must launch the kernel or raise — never fall back."""

import numpy as np
import pytest
import torch

from sagecal_tpu_torch.ops import coh as tcoh
from sagecal_tpu_torch.ops import sweep as tswp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, ref):
    return float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_coh_kernel_matches_plain(card):
    rng = np.random.default_rng(0)
    M, S, B, F = 3, 20, 1000, 4
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=card)
    uvw3 = f32(rng.normal(0, 1e-5, (3, B)))
    geom = f32(np.stack([rng.normal(0, 0.03, (M, S)),
                         rng.normal(0, 0.03, (M, S)),
                         -rng.random((M, S)) * 1e-3], axis=1))
    flux = f32(rng.random((M, F, 4, S)))
    gauss = f32(rng.normal(0, 1e-3, (M, 11, S)))
    gauss[:, 10] = f32(rng.random((M, S)) > 0.5)
    freqs = f32(150e6 + 1e6 * np.arange(F))
    n0 = tcoh.LAUNCHES
    got = tcoh.coherencies_points(uvw3, geom, flux, gauss, freqs, 0.18e6)
    assert tcoh.LAUNCHES == n0 + 1
    ref = tcoh.coherencies_points_plain(uvw3, geom, flux, gauss, freqs,
                                        0.18e6)
    assert got.shape == (M, B, F, 8) and _close(got, ref)


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


def test_sweep_kernel_refuses_float64(card):
    x8 = torch.zeros((6, 8), dtype=torch.float64, device=card)
    J = torch.zeros((1, 4, 2, 2), dtype=torch.complex128, device=card)
    coh = torch.zeros((6, 2, 2), dtype=torch.complex128, device=card)
    s = torch.zeros(6, dtype=torch.long, device=card)
    with pytest.raises(TypeError):
        tswp.sweep_blocks(x8, J, coh, s, s, s, x8, x8, 6, 1)
