"""Spatial regularization of the consensus solution across directions
(port of ``sagecal_tpu/consensus/spatial.py``; the reference's ``-X
l2,l1,order,fista_iters,cadence``, README.md:160-166).

- :func:`sharmonic_basis`: complex spherical harmonics Y_lm at the
  clusters' polar coordinates (``sharmonic_modes``, elementbeam.c:278),
  host numpy;
- :func:`cluster_polar_coords`: flux-weighted cluster centroids as (r,
  theta) = (|lm| pi/2, atan2(m, l)), one per hybrid chunk
  (sagecal_master.cpp:323-356);
- :func:`build_phi` and :func:`phi_padded`: Phi_k = I_2 (x) phi_k and
  Phikk = sum_k Phi_k Phi_k^H + lambda I (master :371-397), the padded
  (cluster, chunk) grid's slots zero blocks;
- :func:`fista_spatialreg`: the elastic-net proximal solve by FISTA
  (fista.c:36, with the prox threshold mu / L of Beck & Teboulle; the
  JAX package's deliberate deviation from fista.c:78);
- :func:`spatial_predict` and the Z <-> block reshapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sagecal_tpu_torch import utils
from sagecal_tpu_torch.consensus import manifold as mf


def _assoc_legendre(l: int, m: int, x):
    """Associated Legendre P_l^m(x) for small l, m >= 0 by the standard
    recursion (elementbeam.c:238-268), numpy."""
    pmm = np.ones_like(x)
    if m > 0:
        somx2 = np.sqrt(np.maximum((1.0 - x) * (1.0 + x), 0.0))
        fact = 1.0
        for _ in range(m):
            pmm = pmm * (-fact) * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2.0 * m + 1.0) * pmm
    if l == m + 1:
        return pmmp1
    pll = pmmp1
    for i in range(m + 2, l + 1):
        pll = ((2.0 * i - 1.0) * x * pmmp1 - (i + m - 1.0) * pmm) / (i - m)
        pmm, pmmp1 = pmmp1, pll
    return pll


def sharmonic_basis(n0: int, theta, phi):
    """Complex spherical harmonics Y_lm(theta, phi) for l < n0, m = -l..l
    -> [..., n0^2] (negative m by conjugation with (-1)^m), numpy."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    ct = np.cos(theta)
    cols = []
    for l in range(n0):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am)
                             / math.factorial(l + am))
            y = norm * _assoc_legendre(l, am, ct) * np.exp(1j * am * phi)
            if m < 0:
                y = np.conj(y) * ((-1.0) ** am)
            cols.append(y)
    return np.stack(cols, axis=-1)


def cluster_polar_coords(sky) -> tuple[np.ndarray, np.ndarray]:
    """Flux-weighted centroid of each cluster in polar (r, theta),
    repeated per hybrid chunk -> [Mt] each (master :323-356)."""
    rr, tt = [], []
    P = (np.abs(sky.sI) + np.abs(sky.sQ) + np.abs(sky.sU)
         + np.abs(sky.sV)) * sky.smask
    for ci in range(sky.n_clusters):
        w = P[ci]
        sw = w.sum()
        if sw > 0:
            lmean = float((w * sky.ll[ci]).sum() / sw)
            mmean = float((w * sky.mm[ci]).sum() / sw)
        else:
            lmean = mmean = 0.0
        r = math.sqrt(lmean * lmean + mmean * mmean) * math.pi / 2
        t = math.atan2(mmean, lmean)
        for _ in range(int(sky.nchunk[ci])):
            rr.append(r)
            tt.append(t)
    return np.asarray(rr), np.asarray(tt)


def build_phi(n0: int, r, theta, sh_lambda: float):
    """Per-cluster basis blocks Phi [Mt, 2G, 2] = I_2 (x) phi_k and Phikk
    = sum_k Phi_k Phi_k^H + lambda I (master :371-397), numpy."""
    phi = sharmonic_basis(n0, r, theta)                    # [Mt, G]
    Mt, G = phi.shape
    Phi = np.zeros((Mt, 2 * G, 2), complex)
    Phi[:, :G, 0] = phi
    Phi[:, G:, 1] = phi
    Phikk = np.einsum("kgi,khi->gh", Phi, Phi.conj())
    return Phi, Phikk + sh_lambda * np.eye(2 * G)


def phi_padded(sky_cmask, rr, tt, n0: int, sh_lambda: float):
    """Phi and Phikk on the padded (cluster, chunk) grid: live slots take
    their centroid's basis rows, padded slots zero blocks, and Phikk is
    summed after the masking (a padded slot's row at (0, 0) would add
    spurious Phi_k Phi_k^H terms). Numpy, shared by the ADMM runner and
    the spatial-model writer."""
    cm = np.asarray(sky_cmask)
    M, K = cm.shape
    r_pad = np.zeros((M, K))
    t_pad = np.zeros((M, K))
    idx = 0
    for m in range(M):
        for k in range(K):
            if cm[m, k]:
                r_pad[m, k] = rr[idx]
                t_pad[m, k] = tt[idx]
                idx += 1
    Phi, _ = build_phi(int(n0), r_pad.ravel(), t_pad.ravel(),
                       float(sh_lambda))
    Phi = Phi * cm.reshape(-1)[:, None, None]
    Phikk = np.einsum("kgi,khi->gh", Phi, Phi.conj())
    return Phi, Phikk + float(sh_lambda) * np.eye(Phikk.shape[0])


def _soft(x, thr):
    return torch.sign(x) * torch.clamp(x.abs() - thr, min=0.0)


def fista_spatialreg(Zbar, Phikk, Phi, mu: float, maxiter: int):
    """FISTA elastic-net solve for the spatial coefficients: Zbar [Mt, D,
    2] complex (D = 2 Npoly N), Phikk [2G, 2G], Phi [Mt, 2G, 2] complex
    tensors -> Zspat [D, 2G] (fista.c:36; L = ||Phikk||_F^2, the
    threshold mu / L applied to the real and imaginary parts apart)."""
    D = Zbar.shape[1]
    G2 = Phikk.shape[0]
    L = (Phikk.abs() ** 2).sum()
    rhs = torch.einsum("kdi,kgi->dg", Zbar, Phi.conj())
    Z = torch.zeros((D, G2), dtype=Zbar.dtype, device=Zbar.device)
    Y = Z
    t = torch.ones((), dtype=L.dtype, device=L.device)
    for _ in range(maxiter):
        Yn = Y - (Y @ Phikk - rhs) / L
        Zn = torch.complex(_soft(Yn.real, mu / L), _soft(Yn.imag, mu / L))
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        sc = (tn - 1.0) / t
        Y = (1.0 + sc) * Zn - sc * Z
        Z, t = Zn, tn
    return Z


def spatial_predict(Zspat, Phi):
    """Zbar_k = Zspat Phi_k -> [Mt, D, 2] (master :796-798)."""
    return torch.einsum("dg,kgi->kdi", Zspat, Phi)


def z_r8_to_blocks(Z_r8):
    """Consensus Z [M, P, K, N, 8] reals -> [M K, 2 P N, 2] complex blocks
    (the reference's 2 Npoly N x 2 per effective cluster; Phi acts on the
    right)."""
    J = utils.jones_r2c(Z_r8)                # [M, P, K, N, 2, 2]
    M, P, K, N = J.shape[:4]
    J = J.transpose(1, 2)                    # [M, K, P, N, 2, 2]
    return mf.jones_to_blocks(J.reshape(M * K, P * N, 2, 2))


def blocks_to_z_r8(X, M: int, P: int, K: int, N: int):
    """Inverse of :func:`z_r8_to_blocks`."""
    J = mf.blocks_to_jones(X).reshape(M, K, P, N, 2, 2)
    return utils.jones_c2r(J.transpose(1, 2).contiguous())
