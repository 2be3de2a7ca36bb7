"""Visibility prediction, the RIME (port of ``sagecal_tpu/rime/predict.py``).

Conventions are the JAX package's: u, v, w in seconds; fringe phase
2 pi (u l + v m + w n) f with n carrying the -1; channel smearing
|sinc(G fdelta/2)|; Stokes -> correlations [[I+Q, U+iV], [U-iV, I-Q]].

This slice predicts point and gaussian sources through the coherency
kernel (``ops/coh.py``). A sky with shapelet, disk or ring sources
raises ``NotImplementedError``; those envelopes and the hybrid split
come with ROADMAP queue A item 2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import utils
from sagecal_tpu_torch.ops import coh as coh_ops


class SkyArrays(NamedTuple):
    """Device-resident padded sky model ([M, Smax] tensors)."""

    ll: torch.Tensor
    mm: torch.Tensor
    nn: torch.Tensor
    ra: torch.Tensor
    dec: torch.Tensor
    sI: torch.Tensor
    sQ: torch.Tensor
    sU: torch.Tensor
    sV: torch.Tensor
    sI0: torch.Tensor
    sQ0: torch.Tensor
    sU0: torch.Tensor
    sV0: torch.Tensor
    spec_idx: torch.Tensor
    spec_idx1: torch.Tensor
    spec_idx2: torch.Tensor
    f0: torch.Tensor
    stype: torch.Tensor
    eX: torch.Tensor
    eY: torch.Tensor
    eP: torch.Tensor
    cxi: torch.Tensor
    sxi: torch.Tensor
    cphi: torch.Tensor
    sphi: torch.Tensor
    use_projection: torch.Tensor
    sh_n0: torch.Tensor
    sh_beta: torch.Tensor
    sh_modes: torch.Tensor
    smask: torch.Tensor


_INT_FIELDS = {"stype": torch.int32, "sh_n0": torch.int32,
               "use_projection": torch.bool, "smask": torch.bool}


def sky_to_device(sky, real_dtype=torch.float32, device="cpu") -> SkyArrays:
    """ClusterSky (numpy) -> SkyArrays on ``device``."""
    fields = {}
    for name in SkyArrays._fields:
        dt = _INT_FIELDS.get(name, real_dtype)
        fields[name] = torch.as_tensor(np.asarray(getattr(sky, name)),
                                       device=device).to(dt)
    return SkyArrays(**fields)


def _spectral_flux(s0, spec_idx, spec_idx1, spec_idx2, f0, freq):
    """Catalog flux -> flux at ``freq``: scaling applies only where
    spec_idx != 0; the sign passes through."""
    fr = torch.log(freq / f0)
    tempfr = spec_idx * fr + spec_idx1 * fr * fr + spec_idx2 * fr ** 3
    mag = torch.exp(torch.log(torch.clamp(torch.abs(s0), min=1e-300))
                    + tempfr)
    scaled = torch.where(s0 == 0.0, torch.zeros_like(s0),
                         torch.sign(s0) * mag)
    return torch.where(spec_idx != 0.0, scaled, s0)


def coherencies(sky: SkyArrays, u, v, w, freqs, fdelta,
                per_channel_flux: bool = False):
    """All-cluster coherencies [M, B, F, 2, 2] complex (no Jones).

    ``freqs`` is the host's channel list (``ops/coh.py:coherencies``
    uploads it); ``fdelta`` is the smearing bandwidth per channel. Point
    and gaussian sources only (the coherency kernel's scope)."""
    if not coh_ops.supported(sky):
        raise NotImplementedError(
            "shapelet/disk/ring sources are not ported yet (ROADMAP queue "
            "A item 2: rime/envelopes.py and the hybrid split)")
    return coh_ops.coherencies(sky, u, v, w, freqs, fdelta,
                               per_channel_flux=per_channel_flux)


def uvcut_flags(flags, u, v, freqs, uvmin, uvmax):
    """Mark baselines outside the uv range with flag 2: still
    subtracted, excluded from the solve."""
    freqs = torch.atleast_1d(freqs)
    uvdist = torch.sqrt(u * u + v * v) * freqs[0]
    out = (uvdist < uvmin) | (uvdist * freqs[-1] > uvmax * freqs[0])
    return torch.where((flags == 0) & out, torch.full_like(flags, 2), flags)


def apply_uvcut(rowflags, tile, uvmin: float, uvmax: float) -> np.ndarray:
    """Host-side uv window on a copy of a tile's row flags: int8 [nrows],
    the input unchanged under the full window. The cut is solve-scoped:
    never write the result back into the tile."""
    if not (uvmin > 0.0 or uvmax < 1e9):
        return np.asarray(rowflags)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    flags = uvcut_flags(torch.as_tensor(np.asarray(rowflags, np.int32)),
                        t(tile.u), t(tile.v), t(tile.freqs), uvmin, uvmax)
    return flags.numpy().astype(np.int8)


def chunk_indices(tilesz: int, nbase: int, nchunk) -> np.ndarray:
    """[M, B] map from data row to hybrid time chunk per cluster; rows
    are [tilesz, nbase]; chunk ck covers timeslots from
    ck * ceil(tilesz / nchunk)."""
    t = np.arange(tilesz * nbase) // nbase
    out = np.zeros((len(nchunk), tilesz * nbase), np.int32)
    for m, K in enumerate(np.asarray(nchunk)):
        tilechunk = (tilesz + K - 1) // K
        out[m] = np.minimum(t // tilechunk, K - 1)
    return out


def model8(coh_m, J_m, sta1, sta2, chunk_idx_m):
    """One cluster's corrupted model J_p C J_q^H as [B, 8] reals
    ((Re, Im) of XX, XY, YX, YY)."""
    Jp = utils.gather_jones(J_m, chunk_idx_m, sta1)
    Jq = utils.gather_jones(J_m, chunk_idx_m, sta2)
    V = utils.mul22(utils.mul22(Jp, coh_m), Jq, conj_b=True)
    return torch.view_as_real(V.reshape(-1, 4)).reshape(-1, 8)


def apply_jones(coh_m, J_m, sta1, sta2, chunk_idx_m):
    """J_p C J_q^H per row and channel: coh_m [B, F, 2, 2], J_m
    [Kmax, N, 2, 2], chunk_idx_m [B] -> [B, F, 2, 2]."""
    Jp = utils.gather_jones(J_m, chunk_idx_m, sta1)[:, None]   # [B, 1, 2, 2]
    Jq = utils.gather_jones(J_m, chunk_idx_m, sta2)[:, None]
    return utils.mul22(utils.mul22(Jp, coh_m), Jq, conj_b=True)


def predict_model(coh, J, sta1, sta2, chunk_idx, cluster_mask=None):
    """Sum over clusters of J_p C_m J_q^H -> [B, F, 2, 2]; clusters with
    ``cluster_mask`` False are left out."""
    M = coh.shape[0]
    out = torch.zeros(coh.shape[1:], dtype=coh.dtype, device=coh.device)
    for m in range(M):
        if cluster_mask is not None and not bool(cluster_mask[m]):
            continue
        out += apply_jones(coh[m], J[m], sta1, sta2, chunk_idx[m])
    return out
