"""Manifold tools on Jones solutions (port of
``sagecal_tpu/consensus/manifold.py``; reference
``manifold_average.c``).

- the phase extraction of the phase-only correction (``-J 1``):
  :func:`extract_phases` (``manifold.py:92``) with its Givens step
  :func:`_givens_from_eigvec` (``:83``);
- the manifold average of consensus calibration (``:25-168``): each
  frequency's 2N x 2 solution block is defined up to a right 2x2
  unitary; :func:`manifold_average` rotates every block onto a reference
  (Procrustes, :func:`procrustes_project`, the polar factor of a 2x2 in
  closed form: :func:`polar_unitary_2x2`), iterates {mean -> project},
  then applies ONE unitary to each original block
  (calculate_manifold_average, :204; the subband-axis average of the
  ADMM runner's iteration 0).
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


def _herm_invsqrt_2x2(H, eps=1e-12):
    """Inverse square root of 2x2 Hermitian PSD matrices [..., 2, 2], in
    closed form: sqrt(H) = (H + sqrt(det) I) / sqrt(trace + 2 sqrt(det)),
    inverted by its adjugate (a determinant below ``eps`` in modulus is
    replaced by ``eps``)."""
    t = H[..., 0, 0] + H[..., 1, 1]
    d = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    sd = torch.sqrt(torch.clamp(d.real, min=0.0)).to(H.dtype)
    denom = torch.sqrt(torch.clamp((t + 2 * sd).real, min=eps)).to(H.dtype)
    eye = torch.eye(2, dtype=H.dtype, device=H.device)
    sq = (H + sd[..., None, None] * eye) / denom[..., None, None]
    det_sq = sq[..., 0, 0] * sq[..., 1, 1] - sq[..., 0, 1] * sq[..., 1, 0]
    det_sq = torch.where(det_sq.abs() < eps,
                         torch.full_like(det_sq, eps), det_sq)
    adj = torch.stack([torch.stack([sq[..., 1, 1], -sq[..., 0, 1]], -1),
                       torch.stack([-sq[..., 1, 0], sq[..., 0, 0]], -1)], -2)
    return adj / det_sq[..., None, None]


def polar_unitary_2x2(A):
    """U V^H of the SVD of 2x2 complex A [..., 2, 2], its polar unitary
    factor A (A^H A)^(-1/2)."""
    AH_A = torch.einsum("...ji,...jk->...ik", A.conj(), A)
    return A @ _herm_invsqrt_2x2(AH_A)


def procrustes_project(X, Y):
    """Rotate Y onto X: Y U with U = argmin ||X - Y U||_F over unitaries,
    U = polar(Y^H X); X, Y [..., 2N, 2] complex (broadcast)
    (project_procrustes_block, manifold_average.c:346)."""
    A = torch.einsum("...ji,...jk->...ik", Y.conj(), X)
    return Y @ polar_unitary_2x2(A)


def jones_to_blocks(J):
    """[..., N, 2, 2] Jones -> [..., 2N, 2] stacked blocks [J_1; J_2; ...]:
    the gauge J_p -> J_p U of every station is a right multiplication."""
    return J.reshape(J.shape[:-3] + (2 * J.shape[-3], 2))


def blocks_to_jones(X):
    """Inverse of :func:`jones_to_blocks`."""
    return X.reshape(X.shape[:-2] + (X.shape[-2] // 2, 2, 2))


def manifold_average(J, niter: int = 3, ref_index: int = 0, nf=None,
                     group=None, real=None):
    """Frequency-average solutions up to their unitary ambiguity.

    J [Nf, M, N, 2, 2] complex (any leading direction axes after Nf).
    Every block is first rotated onto frequency ``ref_index``'s, then
    ``niter`` times onto the mean over frequency; finally ONE unitary is
    applied to each original block, toward the last mean. ``nf`` divides
    the sum over the leading axis (Nf by default: the JAX package's mean;
    the ADMM runner passes its count of real subbands). Returns J with
    the same shape.

    With a process ``group`` (``distributed.Group``; the JAX package's
    ``manifold_average_mesh``, ``consensus/admm.py:109-140``) J holds this
    rank's slots of the subband axis, ``real`` [Nf] bool marks the real
    ones (not padded), and the reference is the globally first subband,
    rank 0's slot 0, broadcast: each mean is the sum over every rank's
    real slots (all-reduced) over ``nf``."""
    from sagecal_tpu_torch import distributed as dist
    X0 = jones_to_blocks(J)
    den = X0.shape[0] if nf is None else nf
    if group is None:
        ref = X0[ref_index]

        def total(X):
            return X.sum(dim=0, keepdim=True)
    else:
        ref = dist.broadcast_from(X0[0], group)
        keep = torch.as_tensor(real, device=X0.device)

        def total(X):
            return dist.all_reduce_sum(X[keep].sum(dim=0, keepdim=True),
                                       group)
    X = procrustes_project(ref[None], X0)
    for _ in range(niter):
        X = procrustes_project(total(X) / den, X)
    Xout = procrustes_project(total(X) / den, X0)
    return blocks_to_jones(Xout)
