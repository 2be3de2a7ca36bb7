"""Point/gaussian coherencies: kernel 1 of the port (counterpart of
``sagecal_tpu/ops/coh_pallas.py``).

``coherencies_points`` replaces the Pallas kernel ``_coh_kernel``
(``coh_pallas.py:49``, launched by ``coherencies_points`` ``:108``). On a
CUDA tensor it launches the hand-written kernel in ``csrc/coh.cu``
(float32 only) or raises; on a CPU tensor it runs the plain PyTorch
version :func:`coherencies_points_plain`, the [S, B] broadcast of the
same maths, in the tensors' own dtype (float64 in the tests).

What bounds the kernel on the card is instruction issue; the function's
own operation count, the yardstick of its bound, splits into work per
(cluster, row, source) and work per (cluster, channel, row, source)
(:data:`COH_OPS_PER_SOURCE_ROW`, :data:`COH_OPS_PER_TERM`). The kernel
does the first once per row and source and the second per channel of a
tile (:func:`coh_geometry`); where the channels are evenly spaced
(:func:`channel_step`, decided on the host) each next channel's phasor
is a rotation of the last. The design notes are in ``csrc/coh.cu``.

The spectral scaling (:func:`stokes_weights`) and the gaussian
coefficients (:func:`gauss_coeffs`) stay PyTorch ops outside the kernel,
as they stay XLA in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import skymodel
from sagecal_tpu_torch.ops import cuda_lib

TWO_PI = 2.0 * math.pi

# The function's operations, counted from ``_coh_kernel``'s maths (not
# from either CUDA kernel), each transcendental (sin, cos, exp) and the
# division charged 1:
#: per (cluster, row, source), whatever the channel count: geometry
#: l u + m v + n w 5, times 2 pi 1, smearing argument 1, |sin(x)/x| 3
COH_OPS_PER_SOURCE_ROW = 10
#: per (cluster, channel, row, source): phase 1, sincos 2, smearing times
#: cos and sin 2, the eight Stokes-weighted sums 24
COH_OPS_PER_TERM = 29
#: extra per (cluster, row, gaussian source): projection up, vp 10, shape
#: rotation 6, q = ut^2 + vt^2 (without f) 3
COH_OPS_PER_GAUSS_ROW = 19
#: extra per (cluster, channel, row, gaussian source): f^2 q 1, negation
#: 1, exp 1, times pi/2 1, times the smearing 1
COH_OPS_PER_GAUSS_TERM = 5

#: the kernel's channel capacities (template instances of csrc/coh.cu):
#: one channel (the solve), else tiles of up to 8 (the residual)
COH_FT = (1, 8)
#: rows per block (csrc/coh.cu COH_THREADS): one thread per row
COH_ROWS = 256

#: kernel launches since the last reset (the plain version never counts),
#: and the same launches by their channel count F
LAUNCHES = 0
F_LAUNCHES: dict = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    F_LAUNCHES.clear()


def op_count(M: int, F: int, B: int, S: int, n_gauss: int) -> int:
    """The function's operations for M clusters of S sources (``n_gauss``
    gaussians over all clusters), F channels and B rows: the yardstick of
    the kernel's operation bound."""
    return B * (M * S * (COH_OPS_PER_SOURCE_ROW + F * COH_OPS_PER_TERM)
                + n_gauss * (COH_OPS_PER_GAUSS_ROW
                             + F * COH_OPS_PER_GAUSS_TERM))


class CohGeometry(NamedTuple):
    """The coherency kernel's launch: ``ft`` its channel capacity (a
    template instance), ``tile`` channels per tile, grid (``row_blocks``,
    ``n_tiles``, M) of ``COH_ROWS`` threads, one per row."""
    ft: int
    tile: int
    n_tiles: int
    row_blocks: int


def coh_geometry(F: int, B: int) -> CohGeometry:
    """Channel tiles of at most 8 channels, as even as the count allows
    (17 -> 6, 6, 5), and one thread per row; a tile of 2..7 channels runs
    the 8-channel instance with its last slots idle."""
    n_tiles = -(-F // COH_FT[-1])
    tile = -(-F // n_tiles)
    ft = next(c for c in COH_FT if c >= tile)
    return CohGeometry(ft, tile, n_tiles, -(-B // COH_ROWS))


def channel_step(freqs) -> float | None:
    """The channel spacing of a host channel list when it is even (to
    1e-8 of the highest channel, far below a float32 ulp), else None (a
    single channel is None too). The kernel then rotates each channel's
    phasor from the last instead of taking a sincos; the decision is made
    here, from the list the pipeline holds, never by reading the
    device."""
    f = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    if f.size < 2:
        return None
    step = (f[-1] - f[0]) / (f.size - 1)
    even = f[0] + step * np.arange(f.size)
    if step == 0 or np.max(np.abs(f - even)) > 1e-8 * np.max(np.abs(f)):
        return None
    return float(step)


def stokes_weights(sky, freqs, per_channel_flux: bool):
    """[M, F, 4, S] (I+Q, I-Q, U, V) channel flux weights; padded
    sources get zero weight. One broadcast over the channels (the JAX
    version's ``vmap``)."""
    from sagecal_tpu_torch.rime import predict as rp
    freqs = torch.atleast_1d(freqs)
    z = sky.smask.to(sky.ll.dtype)[:, None]                # [M, 1, S]
    if per_channel_flux:
        args = (sky.spec_idx[:, None], sky.spec_idx1[:, None],
                sky.spec_idx2[:, None], sky.f0[:, None], freqs[:, None])
        sI, sQ, sU, sV = (rp._spectral_flux(s0[:, None], *args)
                          for s0 in (sky.sI0, sky.sQ0, sky.sU0, sky.sV0))
    else:
        sI, sQ, sU, sV = (s[:, None] for s in (sky.sI, sky.sQ, sky.sU,
                                               sky.sV))
    F = freqs.shape[0]
    return torch.stack([((sI + sQ) * z).expand(-1, F, -1),
                        ((sI - sQ) * z).expand(-1, F, -1),
                        (sU * z).expand(-1, F, -1),
                        (sV * z).expand(-1, F, -1)], dim=2)  # [M, F, 4, S]


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


def _live_pg(sky):
    """[live sources] bools: the source is a point or a gaussian (host)."""
    stype = np.asarray(sky.stype.cpu() if torch.is_tensor(sky.stype)
                       else sky.stype)
    smask = np.asarray(sky.smask.cpu() if torch.is_tensor(sky.smask)
                       else sky.smask)
    live = stype[smask]
    return (live == skymodel.STYPE_POINT) | (live == skymodel.STYPE_GAUSSIAN)


def supported(sky) -> bool:
    """True when every live source is a point or gaussian (host-side)."""
    return bool(np.all(_live_pg(sky)))


def any_supported(sky) -> bool:
    """True when at least one live source is a point or gaussian
    (host-side): only then does the predict split the sky and launch the
    kernel on its point/gaussian half (``rime/predict.py:split_sky``)."""
    return bool(np.any(_live_pg(sky)))


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


def coherencies_points(uvw3, geom, flux, gauss, freqs, fdelta,
                       step: float | None = None):
    """All-cluster point/gaussian coherencies as [M, B, F, 8] reals.

    uvw3 [3, B] seconds; geom [M, 3, S]; flux [M, F, 4, S]; gauss
    [M, 11, S]; freqs [F]; fdelta the per-channel smearing bandwidth.
    ``step`` is :func:`channel_step` of the host list ``freqs`` was
    uploaded from (None for per-channel phasors): the kernel then takes
    each next channel's phasor from the step and not from ``freqs``, so
    the two must come from one list, as :func:`coherencies` makes them.
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
    geo = coh_geometry(F, B)
    recur = step is not None and F > 1
    lib = cuda_lib.load("coh")
    rc = lib.coh_points_launch(
        uvw3.data_ptr(), geom.data_ptr(), flux.data_ptr(), gauss.data_ptr(),
        freqs.data_ptr(), float(fdelta), float(step) if recur else 0.0,
        out.data_ptr(), M, F, B, S, geo.ft, geo.tile, geo.n_tiles,
        geo.row_blocks, int(recur), cuda_lib.stream_ptr(uvw3.device))
    cuda_lib.check(rc, "coh_points_kernel")
    LAUNCHES += 1
    F_LAUNCHES[F] = F_LAUNCHES.get(F, 0) + 1
    return out


def coherencies(sky, u, v, w, freqs, fdelta, per_channel_flux: bool = False):
    """Drop-in for ``rime.predict.coherencies`` on point/gaussian
    models: [M, B, F, 2, 2] complex.

    ``freqs`` is the host's channel list (a numpy array, a sequence or a
    CPU tensor): it is uploaded to ``u``'s device here, and the channel
    step the kernel rotates phasors by is decided from the same list
    (:func:`channel_step`), never by reading the device."""
    if torch.is_tensor(freqs):
        if freqs.device.type != "cpu":
            raise TypeError("coherencies: the channel list must be on the "
                            f"host, not on {freqs.device}")
        freqs = freqs.numpy()
    fl = np.atleast_1d(np.asarray(freqs))
    freqs = torch.as_tensor(fl, dtype=u.dtype, device=u.device)
    uvw3 = torch.stack([u, v, w], dim=0)
    geom = torch.stack([sky.ll, sky.mm, sky.nn], dim=1)     # [M, 3, S]
    flux = stokes_weights(sky, freqs, per_channel_flux)
    out = coherencies_points(uvw3, geom, flux, gauss_coeffs(sky), freqs,
                             fdelta, step=channel_step(fl))
    M, B, F = out.shape[:3]
    return torch.view_as_complex(out.view(M, B, F, 4, 2)).view(
        M, B, F, 2, 2)
