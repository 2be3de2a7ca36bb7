"""Extended-source visibility envelopes (port of
``sagecal_tpu/rime/envelopes.py``).

Gaussian, ring, disk and shapelet envelopes as masked tensor ops over a
[..., S] source grid, one morphology selected per lane by ``stype``:
the same closed forms, guards and rational approximations as the JAX
package, term for term, so that a padded lane (eX = eY = 0) stays finite
and is masked by zero flux downstream.

All inputs are in wavelengths (callers pass u_sec * freq).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sagecal_tpu_torch.skymodel import (
    STYPE_DISK, STYPE_GAUSSIAN, STYPE_RING, STYPE_SHAPELET,
)

#: shapelet mode-grid elements ([rows, S, n0max, n0max]) evaluated at once;
#: longer row counts go in blocks, so the grid stays ~0.5 GB in float64
SHAPELET_BLOCK_ELEMS = 1 << 26


def _project_uv(u, v, w, cxi, sxi, cphi, sphi, use_projection, negate):
    """Rotate (u, v, w) into the source-local tangent frame; the shapelet
    variant (``negate``) negates the projected frame only, the
    unprojected branch stays (u, v)."""
    up = u * cxi - v * cphi * sxi + w * sphi * sxi
    vp = u * sxi + v * cphi * cxi - w * sphi * cxi
    if negate:
        up, vp = -up, -vp
    up = torch.where(use_projection, up, u)
    vp = torch.where(use_projection, vp, v)
    return up, vp


def gaussian(u, v, w, eX, eY, eP, cxi, sxi, cphi, sphi, use_projection):
    """pi/2 exp(-(ut^2 + vt^2)), axes pre-doubled at parse."""
    up, vp = _project_uv(u, v, w, cxi, sxi, cphi, sphi, use_projection,
                         negate=False)
    sinph, cosph = torch.sin(eP), torch.cos(eP)
    ut = eX * (cosph * up - sinph * vp)
    vt = eY * (sinph * up + cosph * vp)
    return (math.pi / 2.0) * torch.exp(-(ut * ut + vt * vt))


def _bessel_j0(x):
    """Abramowitz & Stegun 9.4.1/9.4.3 rational approximations; both
    branches evaluated, then selected at |x| = 8."""
    ax = torch.abs(x)
    y = x * x
    p_small = (57568490574.0 + y * (-13362590354.0 + y * (651619640.7
               + y * (-11214424.18 + y * (77392.33017 + y * (-184.9052456))))))
    q_small = (57568490411.0 + y * (1029532985.0 + y * (9494680.718
               + y * (59272.64853 + y * (267.8532712 + y)))))
    small = p_small / q_small
    z = 8.0 / torch.clamp(ax, min=1e-30)
    y2 = z * z
    xx = ax - 0.785398164
    p1 = (1.0 + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4
          + y2 * (-0.2073370639e-5 + y2 * 0.2093887211e-6))))
    p2 = (-0.1562499995e-1 + y2 * (0.1430488765e-3 + y2 * (-0.6911147651e-5
          + y2 * (0.7621095161e-6 + y2 * (-0.934935152e-7)))))
    large = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * (
        torch.cos(xx) * p1 - z * torch.sin(xx) * p2)
    return torch.where(ax < 8.0, small, large)


def _bessel_j1(x):
    """Abramowitz & Stegun 9.4.4/9.4.6 rational approximations."""
    ax = torch.abs(x)
    y = x * x
    p_small = x * (72362614232.0 + y * (-7895059235.0 + y * (242396853.1
              + y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606))))))
    q_small = (144725228442.0 + y * (2300535178.0 + y * (18583304.74
              + y * (99447.43394 + y * (376.9991397 + y)))))
    small = p_small / q_small
    z = 8.0 / torch.clamp(ax, min=1e-30)
    y2 = z * z
    xx = ax - 2.356194491
    p1 = (1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4
          + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6)))))
    p2 = (0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5
          + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6))))
    large = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * (
        torch.cos(xx) * p1 - z * torch.sin(xx) * p2) * torch.sign(x)
    return torch.where(ax < 8.0, small, large)


def _ring_disk_arg(u, v, w, eX, cxi, sxi, cphi, sphi):
    """2 pi |uv projected| eX; ring and disk always project."""
    up = u * cxi - v * cphi * sxi + w * sphi * sxi
    vp = u * sxi + v * cphi * cxi - w * sphi * cxi
    return torch.sqrt(up * up + vp * vp) * eX * 2.0 * math.pi


def ring(u, v, w, eX, cxi, sxi, cphi, sphi):
    """J0(2 pi |uv_projected| eX)."""
    return _bessel_j0(_ring_disk_arg(u, v, w, eX, cxi, sxi, cphi, sphi))


def disk(u, v, w, eX, cxi, sxi, cphi, sphi):
    """J1(2 pi |uv_projected| eX)."""
    return _bessel_j1(_ring_disk_arg(u, v, w, eX, cxi, sxi, cphi, sphi))


def _hermite_basis(x, n0max: int):
    """Shapelet 1-D basis B_n(x) = H_n(x) exp(-x^2/2) / sqrt(2^(n+1) n!)
    as [..., n0max]: the physicists' Hermite recursion unrolled over the
    host's ``n0max``."""
    hs = [torch.ones_like(x)]
    if n0max > 1:
        hs.append(2.0 * x)
    for n in range(2, n0max):
        hs.append(2.0 * x * hs[n - 1] - 2.0 * (n - 1) * hs[n - 2])
    fact = 1.0
    norms = []
    for n in range(n0max):
        if n > 0:
            fact *= n
        norms.append(1.0 / np.sqrt(float(2 ** (n + 1)) * fact))
    expv = torch.exp(-0.5 * x * x)
    return torch.stack([h * (expv * float(nrm)) for h, nrm in zip(hs, norms)],
                       dim=-1)


def shapelet_sign_tables(n0max: int):
    """(sign, is_imag) [n0max, n0max] numpy tables for mode (n1, n2): the
    parity i^(n1 + n2) folded into a real/imag split with a sign."""
    n1 = np.arange(n0max)[:, None]
    n2 = np.arange(n0max)[None, :]
    tot = n1 + n2
    is_imag = (tot % 2).astype(np.float64)
    sign = np.where(is_imag == 0,
                    np.where(((tot // 2) % 2) == 0, 1.0, -1.0),
                    np.where((((tot - 1) // 2) % 2) == 0, 1.0, -1.0))
    return sign, is_imag


def _shapelet_sums(ut, vt, beta, m, n0max: int, sign_t, imag_t):
    """(real, imag) mode sums of the grid sign[n1, n2] bu[n1] bv[n2] against
    ``m`` [..., n2, n1]."""
    bu = _hermite_basis(-ut * beta, n0max)          # [..., n0max] (n1)
    bv = _hermite_basis(vt * beta, n0max)           # [..., n0max] (n2)
    grid = bu[..., None, :] * bv[..., :, None]      # [..., n2, n1]
    grid = grid * sign_t
    contrib = m * grid
    realsum = torch.sum(contrib * (1.0 - imag_t), dim=(-1, -2))
    imagsum = torch.sum(contrib * imag_t, dim=(-1, -2))
    return realsum, imagsum


def shapelet(u, v, w, eX, eY, eP, beta, modes, n0, n0max: int,
             cxi, sxi, cphi, sphi, use_projection):
    """Complex envelope 2 pi (Re + i Im) a b of a shapelet source.

    ``modes`` [..., n0max^2] is zero-padded beyond each source's n0^2
    (``n0`` is then not needed as a mask). The Fourier-domain Hermite
    basis is evaluated at (-ut beta, vt beta), as the reference does. A
    grid of more than :data:`SHAPELET_BLOCK_ELEMS` elements is summed in
    blocks of the leading (row) axis, each block exactly the one-shot
    computation on its rows."""
    up, vp = _project_uv(u, v, w, cxi, sxi, cphi, sphi, use_projection,
                         negate=True)
    a = 1.0 / torch.where(eX != 0, eX, torch.ones_like(eX))
    b = 1.0 / torch.where(eY != 0, eY, torch.ones_like(eY))
    sinph, cosph = torch.sin(eP), torch.cos(eP)
    ut = a * (cosph * up - sinph * vp)
    vt = b * (sinph * up + cosph * vp)
    sign, is_imag = shapelet_sign_tables(n0max)
    sign_t = torch.as_tensor(sign.T, dtype=ut.dtype, device=ut.device)
    imag_t = torch.as_tensor(is_imag.T, dtype=ut.dtype, device=ut.device)
    m = modes.reshape(modes.shape[:-1] + (n0max, n0max))     # [..., n2, n1]
    shape = torch.broadcast_shapes(ut.shape, vt.shape, beta.shape,
                                   m.shape[:-2])
    ut, vt = ut.expand(shape), vt.expand(shape)
    beta = beta.expand(shape)
    m = m.expand(shape + (n0max, n0max))
    per_row = max(1, int(np.prod(shape[1:], dtype=np.int64))) * n0max ** 2
    rows = shape[0] if len(shape) else 1
    blk = max(1, SHAPELET_BLOCK_ELEMS // per_row)
    if len(shape) == 0 or rows <= blk:
        re, im = _shapelet_sums(ut, vt, beta, m, n0max, sign_t, imag_t)
    else:
        parts = [_shapelet_sums(ut[i:i + blk], vt[i:i + blk],
                                beta[i:i + blk], m[i:i + blk], n0max,
                                sign_t, imag_t)
                 for i in range(0, rows, blk)]
        re = torch.cat([p[0] for p in parts])
        im = torch.cat([p[1] for p in parts])
    return 2.0 * math.pi * torch.complex(re, im) * a * b


def apply_envelopes(phasor, stype, u, v, w, eX, eY, eP, cxi, sxi, cphi, sphi,
                    use_projection, sh_beta, sh_modes, sh_n0, n0max: int,
                    with_shapelets: bool = True):
    """Multiply a per-source phasor by its morphology envelope.

    ``phasor`` and the source parameters broadcast to a common [..., S]
    shape; u, v, w are in wavelengths. ``with_shapelets``, decided on the
    host from the sky, leaves out the shapelet basis when the model has
    no shapelet."""
    env = torch.ones_like(phasor)
    env = torch.where(stype == STYPE_GAUSSIAN,
                      gaussian(u, v, w, eX, eY, eP, cxi, sxi, cphi, sphi,
                               use_projection).to(env.dtype), env)
    env = torch.where(stype == STYPE_RING,
                      ring(u, v, w, eX, cxi, sxi, cphi, sphi).to(env.dtype),
                      env)
    env = torch.where(stype == STYPE_DISK,
                      disk(u, v, w, eX, cxi, sxi, cphi, sphi).to(env.dtype),
                      env)
    out = phasor * env
    if with_shapelets:
        sh = shapelet(u, v, w, eX, eY, eP, sh_beta, sh_modes, sh_n0, n0max,
                      cxi, sxi, cphi, sphi, use_projection)
        out = torch.where(stype == STYPE_SHAPELET, phasor * sh.to(out.dtype),
                          out)
    return out
