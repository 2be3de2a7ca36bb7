"""Frequency-polynomial consensus: basis, Z update, adaptive rho (port of
``sagecal_tpu/consensus/poly.py``; reference ``consensus_poly.c``).

- :func:`setup_polynomials` (:39): type 0/1 monomials in (f - f0)/f0
  (type 1 column-normalised), type 2 Bernstein on [fmin, fmax], type 3
  alternating (f - f0)/f0 and (f0/f - 1) powers; host numpy;
- :func:`find_prod_inverse` (:460, :560): per-cluster pseudo-inverse of
  sum_f rho[k, f] B_f B_f^T (+ alpha_k I) by SVD;
- :func:`z_from_contributions` (``update_global_z_multi``, :773),
  :func:`bz`, :func:`soft_threshold` (:1039);
- :func:`update_rho_bb` (:923): the Barzilai-Borwein spectral rho with
  the correlation and step heuristics of Xu et al.

The sums over subbands are local sums: the port runs every subband on
one card.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch


def setup_polynomials(freqs, freq0, npoly: int, ptype: int = 2) -> np.ndarray:
    """[Nf, Npoly] real basis matrix B (host numpy, float64)."""
    freqs = np.asarray(freqs, np.float64)
    nf = len(freqs)
    B = np.zeros((nf, npoly))
    if ptype in (0, 1):
        frat = (freqs - freq0) / freq0
        B[:, 0] = 1.0
        for p in range(1, npoly):
            B[:, p] = B[:, p - 1] * frat
        if ptype == 1:
            nrm = np.sqrt((B ** 2).sum(axis=0))
            B = B / np.where(nrm > 0, nrm, 1.0)
    elif ptype == 2:
        fmax, fmin = freqs.max(), freqs.min()
        x = (freqs - fmin) / max(fmax - fmin, 1e-30)
        for p in range(npoly):
            B[:, p] = comb(npoly - 1, p) * x ** p * (1 - x) ** (npoly - 1 - p)
    elif ptype == 3:
        B[:, 0] = 1.0
        frat = (freqs - freq0) / freq0
        last = frat.copy()
        for p in range(1, npoly, 2):
            B[:, p] = last
            last = last * frat
        grat = freq0 / freqs - 1.0
        last = grat.copy()
        for p in range(2, npoly, 2):
            B[:, p] = last
            last = last * grat
    else:
        raise ValueError(f"undefined polynomial type {ptype}")
    return B


def find_prod_inverse(B, rho, alpha=None):
    """Per-cluster pinv(sum_f rho[k, f] B_f B_f^T [+ alpha_k I]) -> [M, P,
    P]: B [Nf, P], rho [M, Nf] tensors of one dtype, alpha an optional
    [M] (the federated prior, find_prod_inverse_full_fed). Singular
    values below 1e-12 of the largest are dropped (sum_inv_threadfn,
    consensus_poly.c:301)."""
    outer = torch.einsum("fp,fq->fpq", B, B)
    S = torch.einsum("mf,fpq->mpq", rho, outer)
    if alpha is not None:
        S = S + alpha[:, None, None] * torch.eye(B.shape[1], dtype=B.dtype,
                                                 device=B.device)
    U, s, Vt = torch.linalg.svd(S)
    keep = s > 1e-12 * s.amax(dim=-1, keepdim=True)
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    return torch.einsum("mqp,mq,mrq->mpr", Vt, sinv, U)


def z_from_contributions(zsum, Bi):
    """Z[k] = Bi[k] @ zsum[k]: zsum [M, P, ...] = sum_f B[f, p] (Y_f + rho_f
    J_f), Bi [M, P, P] -> Z [M, P, ...]."""
    flat = zsum.reshape(zsum.shape[0], zsum.shape[1], -1)
    return torch.einsum("mpq,mqx->mpx", Bi, flat).reshape(zsum.shape)


def bz(Z, Brow):
    """The consensus polynomial at one frequency, sum_p B[f, p] Z_p: Z [M,
    P, ...], Brow [P] -> [M, ...]."""
    return torch.tensordot(Brow, Z, dims=([0], [1]))


def soft_threshold(Z, lam):
    """Elementwise soft threshold (consensus_poly.c:1039)."""
    return torch.sign(Z) * torch.clamp(Z.abs() - lam, min=0.0)


def update_rho_bb(rho, rho_upper, dY, dJ, dims):
    """Barzilai-Borwein spectral rho (consensus_poly.c:923, Xu et al.):
    rho, rho_upper [M]; dY = Yhat - Yhat_old and dJ = J - J_old with the
    cluster on axis 0, reduced over ``dims``. The update is taken only
    where the correlation exceeds 0.2 and 0.001 < alphahat < rho_upper;
    alphahat = alphaMG if 2 alphaMG > alphaSD, else alphaSD - alphaMG / 2.
    """
    ip12 = (dY * dJ).sum(dim=dims)
    ip11 = (dY * dY).sum(dim=dims)
    ip22 = (dJ * dJ).sum(dim=dims)
    eps = 1e-12
    corr = ip12 / torch.sqrt(torch.clamp(ip11 * ip22, min=eps))
    alpha_sd = ip11 / torch.clamp(ip12, min=eps)
    alpha_mg = ip12 / torch.clamp(ip22, min=eps)
    alphahat = torch.where(2.0 * alpha_mg > alpha_sd, alpha_mg,
                           alpha_sd - 0.5 * alpha_mg)
    ok = ((ip12 > eps) & (ip11 > eps) & (ip22 > eps) & (corr > 0.2)
          & (alphahat > 0.001) & (alphahat < rho_upper))
    return torch.where(ok, alphahat, rho)
