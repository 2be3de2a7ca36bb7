"""Manifold tools on Jones solutions (port of
``sagecal_tpu/consensus/manifold.py``).

So far the phase extraction of the phase-only correction (``-J 1``):
:func:`extract_phases` (``manifold.py:92``) with its Givens step
:func:`_givens_from_eigvec` (``:83``). The manifold average and the
Procrustes projections come with consensus calibration (ROADMAP queue A
item 9), which extends this file.
"""

from __future__ import annotations

import torch


def _givens_from_eigvec(Z):
    """Unit eigenvectors [..., 3] of the 3x3 rotation objective -> the
    Givens pair (c, s) (manifold_average.c:497-506): the eigenvector's
    sign is flipped by the sign of its first entry, exactly as the JAX
    package does (``Z[0] >= 0`` keeps it)."""
    Zs = torch.where((Z[..., 0] >= 0.0)[..., None], Z, -Z)
    cdt = torch.complex128 if Z.dtype == torch.float64 else torch.complex64
    c = torch.sqrt(0.5 + 0.5 * Zs[..., 0]).to(cdt)
    s = 0.5 * torch.complex(Zs[..., 1], -Zs[..., 2]) / c
    return c, s


def _top_eigvec(H):
    """The eigenvector [..., 3] of the largest eigenvalue of each
    symmetric 3x3 H [..., 3, 3]."""
    return torch.linalg.eigh(H)[1][..., -1]


def _h_vec(J, flip: bool):
    a00, a01 = J[..., 0, 0], J[..., 0, 1]
    a10, a11 = J[..., 1, 0], J[..., 1, 1]
    if not flip:
        h = torch.stack([a00 - a11, a01 + a10, 1j * (a10 - a01)], -1)
    else:
        h = torch.stack([a11 - a00, a10 + a01, 1j * (a01 - a10)], -1)
    return h.conj()                                   # [..., N, 3]


def _sweep(J, flip: bool):
    """One Givens rotation of all stations' blocks: J <- J G^H, G =
    [[c, conj(s)], [-s, conj(c)]] from the top eigenvector of the
    accumulated form H = Re(sum_n h_n h_n^H)."""
    h = _h_vec(J, flip)
    H = torch.einsum("...ni,...nj->...ij", h, h.conj()).real
    c, s = _givens_from_eigvec(_top_eigvec(H))
    G = torch.stack([torch.stack([c, s.conj()], -1),
                     torch.stack([-s, c.conj()], -1)], -2).to(J.dtype)
    return torch.einsum("...nij,...kj->...nik", J, G.conj())


def extract_phases(J, niter: int = 10):
    """Phase-only diagonal Jones by joint diagonalization
    (``extract_phases``, manifold_average.c:400): ``niter`` times, rotate
    all stations' 2x2 blocks by a common Givens unitary chosen from the
    top eigenvector of the accumulated 3x3 form (one sweep targets
    element (1,2), the next (2,1)); then keep the unit-modulus diagonal
    entries. J [..., N, 2, 2] complex (leading axes, such as the chunks
    of a cluster, are independent problems, as the JAX package's vmap
    over chunks) -> the same shape, diag(e^{i th0}, e^{i th1})."""
    Jr = J
    for _ in range(niter):
        Jr = _sweep(Jr, False)
        Jr = _sweep(Jr, True)
    d0, d1 = Jr[..., 0, 0], Jr[..., 1, 1]
    d0 = d0 / torch.clamp(d0.abs(), min=1e-30)
    d1 = d1 / torch.clamp(d1.abs(), min=1e-30)
    zero = torch.zeros_like(d0)
    return torch.stack([torch.stack([d0, zero], -1),
                        torch.stack([zero, d1], -1)], -2)
