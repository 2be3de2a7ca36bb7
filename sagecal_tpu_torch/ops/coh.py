"""Point/gaussian coherencies: kernel 1 of the port (counterpart of
``sagecal_tpu/ops/coh_pallas.py``).

``coherencies_points`` replaces the Pallas kernel ``_coh_kernel``
(``coh_pallas.py:49``, launched by ``coherencies_points`` ``:108``). On a
CUDA tensor it launches the hand-written kernel in ``csrc/coh.cu``
(float32 only) or raises; on a CPU tensor it runs the plain PyTorch
version :func:`coherencies_points_plain`, the [S, B] broadcast of the
same maths, in the tensors' own dtype (float64 in the tests).

What bounds the kernel on the card is arithmetic: ~40 float32
operations per (cluster, channel, row, source) term, ~65 for a gaussian,
with a sincos, a sin, a division and an exp on the slow transcendental
path (:data:`COH_OPS_PER_TERM`); the design notes are in ``csrc/coh.cu``.

The spectral scaling (:func:`stokes_weights`) and the gaussian
coefficients (:func:`gauss_coeffs`) stay PyTorch ops outside the kernel,
as they stay XLA in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sagecal_tpu_torch import skymodel
from sagecal_tpu_torch.ops import cuda_lib

TWO_PI = 2.0 * math.pi

#: float32 operations per (cluster, channel, row, source) term, counted
#: from the kernel body: phase geometry 7, phase 1, smearing argument 1,
#: |sin(x)/x| 3, sincos 2, weighting 2, the eight Stokes-weighted sums 24
COH_OPS_PER_TERM = 40
#: extra operations of a gaussian term (projection 10, shape 8, envelope
#: exponent 3, exp 1, scale 2, product 1)
COH_OPS_PER_GAUSS = 25

#: kernel launches since the last reset (the plain version never counts)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def stokes_weights(sky, freqs, per_channel_flux: bool):
    """[M, F, 4, S] (I+Q, I-Q, U, V) channel flux weights; padded
    sources get zero weight."""
    from sagecal_tpu_torch.rime import predict as rp
    freqs = torch.atleast_1d(freqs)
    z = sky.smask.to(sky.ll.dtype)
    out = []
    for fi in range(freqs.shape[0]):
        if per_channel_flux:
            args = (sky.spec_idx, sky.spec_idx1, sky.spec_idx2, sky.f0,
                    freqs[fi])
            sI = rp._spectral_flux(sky.sI0, *args)
            sQ = rp._spectral_flux(sky.sQ0, *args)
            sU = rp._spectral_flux(sky.sU0, *args)
            sV = rp._spectral_flux(sky.sV0, *args)
        else:
            sI, sQ, sU, sV = sky.sI, sky.sQ, sky.sU, sky.sV
        out.append(torch.stack([(sI + sQ) * z, (sI - sQ) * z, sU * z,
                                sV * z], dim=1))          # [M, 4, S]
    return torch.stack(out, dim=1)                        # [M, F, 4, S]


def gauss_coeffs(sky):
    """[M, 11, S] per-source gaussian-envelope coefficients: rows 0-5
    the tangent-frame projection (identity without projection), rows
    6-9 the shape rotation/scaling, row 10 the is-gaussian mask."""
    proj = sky.use_projection
    one = torch.ones_like(sky.cxi)
    zero = torch.zeros_like(sky.cxi)
    pu1 = torch.where(proj, sky.cxi, one)
    pu2 = torch.where(proj, -sky.cphi * sky.sxi, zero)
    pu3 = torch.where(proj, sky.sphi * sky.sxi, zero)
    pv1 = torch.where(proj, sky.sxi, zero)
    pv2 = torch.where(proj, sky.cphi * sky.cxi, one)
    pv3 = torch.where(proj, -sky.sphi * sky.cxi, zero)
    sinph, cosph = torch.sin(sky.eP), torch.cos(sky.eP)
    g1, g2 = sky.eX * cosph, -sky.eX * sinph
    g3, g4 = sky.eY * sinph, sky.eY * cosph
    isg = torch.where(sky.stype == skymodel.STYPE_GAUSSIAN, one, zero)
    return torch.stack([pu1, pu2, pu3, pv1, pv2, pv3, g1, g2, g3, g4, isg],
                       dim=1)


def supported(sky) -> bool:
    """True when every live source is a point or gaussian (host-side)."""
    stype = np.asarray(sky.stype.cpu() if torch.is_tensor(sky.stype)
                       else sky.stype)
    smask = np.asarray(sky.smask.cpu() if torch.is_tensor(sky.smask)
                       else sky.smask)
    live = stype[smask]
    return bool(np.all((live == skymodel.STYPE_POINT)
                       | (live == skymodel.STYPE_GAUSSIAN)))


def coherencies_points_plain(uvw3, geom, flux, gauss, freqs, fdelta):
    """Plain PyTorch version of the kernel: [M, B, F, 8] reals (XX re,
    XX im, XY re, XY im, YX re, YX im, YY re, YY im), computed as the
    [S, B] broadcast of ``_coh_kernel``'s maths per (cluster, channel)."""
    M, _, S = geom.shape
    F = freqs.shape[0]
    B = uvw3.shape[1]
    u, v, w = uvw3[0], uvw3[1], uvw3[2]
    out = uvw3.new_empty((M, B, F, 8))
    for m in range(M):
        ll, mm, nn = geom[m, 0][:, None], geom[m, 1][:, None], \
            geom[m, 2][:, None]
        G = TWO_PI * (ll * u[None] + mm * v[None] + nn * w[None])  # [S, B]
        g = gauss[m][:, :, None]                                   # [11, S, 1]
        up = g[0] * u + g[1] * v + g[2] * w
        vp = g[3] * u + g[4] * v + g[5] * w
        for f in range(F):
            freq = freqs[f]
            phase = G * freq
            smfac = G * (fdelta * 0.5)
            safe = torch.where(smfac.abs() > 1e-30, smfac,
                               torch.ones_like(smfac))
            smear = torch.where(smfac.abs() > 1e-30,
                                torch.abs(torch.sin(safe) / safe),
                                torch.ones_like(smfac))
            ut = freq * (g[6] * up + g[7] * vp)
            vt = freq * (g[8] * up + g[9] * vp)
            env = torch.where(g[10] > 0,
                              (math.pi / 2.0) * torch.exp(-(ut * ut + vt * vt)),
                              torch.ones_like(ut))
            smear = smear * env
            C = torch.cos(phase) * smear
            Sn = torch.sin(phase) * smear
            wIpQ, wImQ, wU, wV = (flux[m, f, c][:, None] for c in range(4))
            out[m, :, f] = torch.stack([
                (wIpQ * C).sum(0), (wIpQ * Sn).sum(0),
                (wU * C - wV * Sn).sum(0), (wU * Sn + wV * C).sum(0),
                (wU * C + wV * Sn).sum(0), (wU * Sn - wV * C).sum(0),
                (wImQ * C).sum(0), (wImQ * Sn).sum(0)], dim=-1)
    return out


def coherencies_points(uvw3, geom, flux, gauss, freqs, fdelta):
    """All-cluster point/gaussian coherencies as [M, B, F, 8] reals.

    uvw3 [3, B] seconds; geom [M, 3, S]; flux [M, F, 4, S]; gauss
    [M, 11, S]; freqs [F]; fdelta the per-channel smearing bandwidth.
    A CUDA tensor launches the kernel (float32 only); a CPU tensor runs
    the plain version."""
    if uvw3.device.type != "cuda":
        return coherencies_points_plain(uvw3, geom, flux, gauss, freqs,
                                        fdelta)
    global LAUNCHES
    args = [uvw3, geom, flux, gauss, freqs]
    for a in args:
        if a.dtype != torch.float32 or a.device != uvw3.device:
            raise TypeError("coh kernel: every input must be a float32 "
                            f"tensor on {uvw3.device} (got {a.dtype} on "
                            f"{a.device})")
    uvw3, geom, flux, gauss, freqs = (a.contiguous() for a in args)
    M, _, S = geom.shape
    F = freqs.shape[0]
    B = uvw3.shape[1]
    if flux.shape != (M, F, 4, S) or gauss.shape != (M, 11, S):
        raise ValueError(f"coh kernel: shape mismatch geom {geom.shape}, "
                         f"flux {flux.shape}, gauss {gauss.shape}")
    out = torch.empty((M, B, F, 8), dtype=torch.float32, device=uvw3.device)
    lib = cuda_lib.load("coh")
    rc = lib.coh_points_launch(
        uvw3.data_ptr(), geom.data_ptr(), flux.data_ptr(), gauss.data_ptr(),
        freqs.data_ptr(), float(fdelta), out.data_ptr(), M, F, B, S,
        cuda_lib.stream_ptr(uvw3.device))
    cuda_lib.check(rc, "coh_points_kernel")
    LAUNCHES += 1
    return out


def coherencies(sky, u, v, w, freqs, fdelta, per_channel_flux: bool = False):
    """Drop-in for ``rime.predict.coherencies`` on point/gaussian
    models: [M, B, F, 2, 2] complex."""
    uvw3 = torch.stack([u, v, w], dim=0)
    geom = torch.stack([sky.ll, sky.mm, sky.nn], dim=1)     # [M, 3, S]
    freqs = torch.atleast_1d(freqs)
    flux = stokes_weights(sky, freqs, per_channel_flux)
    out = coherencies_points(uvw3, geom, flux, gauss_coeffs(sky), freqs,
                             fdelta)
    M, B, F = out.shape[:3]
    return torch.view_as_complex(out.view(M, B, F, 4, 2)).view(
        M, B, F, 2, 2)
