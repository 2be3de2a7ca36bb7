"""Visibility prediction, the RIME (port of ``sagecal_tpu/rime/predict.py``).

Conventions are the JAX package's: u, v, w in seconds; fringe phase
2 pi (u l + v m + w n) f with n carrying the -1; channel smearing
|sinc(G fdelta/2)|; Stokes -> correlations [[I+Q, U+iV], [U-iV, I-Q]].

Every source morphology is predicted. Point and gaussian sources go
through the coherency kernel (``ops/coh.py``); shapelet, disk and ring
sources through the generic eager predict (:func:`coherencies_generic`,
envelopes in ``rime/envelopes.py``) on a compact repack of the rest
(``skymodel.split_for_kernel``), and the two halves add elementwise
(:func:`coherencies_split`). The split is made on the host, once per sky
(:func:`split_sky`), on the card and on the CPU alike: on the CPU the
kernel half runs through the kernel's plain version.

With the station beam (``beam``, a ``rime.beam.BeamArrays``, and
``dobeam`` 1, 2 or 3) every source goes through the generic predict with
the beam tables (``rime.beam.cluster_beam``), never the coherency
kernel, as the JAX package turns its Pallas kernel off under ``-B``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import device as devmod
from sagecal_tpu_torch import dtypes, skymodel, utils
from sagecal_tpu_torch.ops import coh as coh_ops
from sagecal_tpu_torch.rime import envelopes


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


class SplitSky(NamedTuple):
    """A sky split for the predict (``pipeline._pallas_skies`` of the JAX
    package): ``pg`` the point/gaussian half for the coherency kernel
    (None when the sky has no live point or gaussian), ``rest`` the
    compact repack of the other sources for the generic predict (None
    when there are none), ``with_shapelets`` whether ``rest`` holds a
    shapelet. Both halves keep the clusters in order."""

    pg: SkyArrays | None
    rest: SkyArrays | None
    with_shapelets: bool


def split_sky(sky, real_dtype=torch.float32, device="cpu") -> SplitSky:
    """Host ClusterSky -> :class:`SplitSky` on ``device``: a sky with no
    live point or gaussian is all rest (no kernel launch); otherwise
    ``skymodel.split_for_kernel``."""
    if not coh_ops.any_supported(sky):
        pg, rest = None, sky
    else:
        pg, rest = skymodel.split_for_kernel(sky)
    return SplitSky(
        None if pg is None else sky_to_device(pg, real_dtype, device),
        None if rest is None else sky_to_device(rest, real_dtype, device),
        rest is not None and bool(np.any(np.asarray(rest.sh_n0) > 0)))


def split_arrays(sky: SkyArrays) -> SplitSky:
    """:func:`split_sky` of a device sky (one host read of its [M, S]
    fields), for callers that hold no host sky."""
    host = {k: getattr(sky, k).cpu().numpy() for k in SkyArrays._fields}
    M = host["ll"].shape[0]
    csky = skymodel.ClusterSky(cluster_ids=np.arange(M, dtype=np.int32),
                               nchunk=np.ones(M, np.int32),
                               names=[[] for _ in range(M)], **host)
    return split_sky(csky, sky.ll.dtype, sky.ll.device)


def _cluster_coherency(csky: SkyArrays, u, v, w, freqs, fdelta,
                       per_channel_flux: bool, n0max: int,
                       with_shapelets: bool, af=None, E=None, tslot=None,
                       sta1=None, sta2=None):
    """Coherencies of one cluster, [B, F, 2, 2] complex: ``csky`` a
    SkyArrays row ([S] tensors), u, v, w [B] seconds, ``freqs`` the host
    channel list. One channel at a time (the JAX package's ``vmap``), so
    the peak is one channel's [B, S] grid (the shapelet's [B, S, n0max,
    n0max] in row blocks, ``envelopes.shapelet``).

    The beam (predict_withbeam.c:139-187): ``af`` [F, S, T, N] scales
    each source by af_p af_q, ``E`` [S, T, N, 2, 2] sandwiches its
    brightness as E_p B E_q^H; ``tslot``, ``sta1``, ``sta2`` [B] map the
    rows to (time, antennas)."""
    cdtype = devmod.complex_dtype(u.dtype)
    if E is not None:
        Et = E.permute(1, 2, 0, 3, 4)                   # [T, N, S, 2, 2]
        E1, E2 = Et[tslot, sta1], Et[tslot, sta2]       # [B, S, 2, 2]
    # G [B, S]: the frequency-independent phase term (seconds)
    G = 2.0 * np.pi * (u[:, None] * csky.ll[None, :]
                       + v[:, None] * csky.mm[None, :]
                       + w[:, None] * csky.nn[None, :])
    smfac = G * (fdelta * 0.5)
    smear = torch.where(torch.abs(G) > 0,
                        torch.abs(torch.sinc(smfac / np.pi)),
                        torch.ones_like(G)).to(cdtype)
    live = csky.smask[None, :]
    b00 = (csky.sI + csky.sQ).to(cdtype)
    b01 = torch.complex(csky.sU, csky.sV)
    b10 = torch.complex(csky.sU, -csky.sV)
    b11 = (csky.sI - csky.sQ).to(cdtype)
    src = {k: getattr(csky, k)[None, :] for k in (
        "stype", "eX", "eY", "eP", "cxi", "sxi", "cphi", "sphi",
        "use_projection", "sh_beta", "sh_n0")}
    out = []
    for fi, freq in enumerate(np.atleast_1d(np.asarray(freqs, np.float64))):
        freq = float(freq)
        phase = G * freq
        phasor = torch.complex(torch.cos(phase), torch.sin(phase)) * smear
        ul, vl, wl = u[:, None] * freq, v[:, None] * freq, w[:, None] * freq
        phasor = envelopes.apply_envelopes(
            phasor, src["stype"], ul, vl, wl, src["eX"], src["eY"],
            src["eP"], src["cxi"], src["sxi"], src["cphi"], src["sphi"],
            src["use_projection"], src["sh_beta"], csky.sh_modes[None],
            src["sh_n0"], n0max, with_shapelets)
        if af is not None:
            aft = af[fi].permute(1, 2, 0)               # [T, N, S]
            phasor = phasor * (aft[tslot, sta1] * aft[tslot, sta2]).to(
                cdtype)
        if per_channel_flux:
            f = torch.as_tensor(freq, dtype=u.dtype, device=u.device)
            args = (csky.spec_idx, csky.spec_idx1, csky.spec_idx2, csky.f0,
                    f)
            sI, sQ, sU, sV = (_spectral_flux(s0, *args) for s0 in (
                csky.sI0, csky.sQ0, csky.sU0, csky.sV0))
            c00, c01 = (sI + sQ).to(cdtype), torch.complex(sU, sV)
            c10, c11 = torch.complex(sU, -sV), (sI - sQ).to(cdtype)
        else:
            c00, c01, c10, c11 = b00, b01, b10, b11
        phasor = torch.where(live, phasor, torch.zeros_like(phasor))
        if E is not None:
            # the element beam: a 2x2 sandwich a source, then the sum
            Bm = torch.stack([torch.stack([c00, c01], -1),
                              torch.stack([c10, c11], -1)], -2)
            Bm = phasor[..., None, None] * Bm[None]     # [B, S, 2, 2]
            out.append(utils.mul22(utils.mul22(E1, Bm), E2,
                                   conj_b=True).sum(dim=1))
            continue
        xx = torch.sum(phasor * c00[None, :], dim=1)
        xy = torch.sum(phasor * c01[None, :], dim=1)
        yx = torch.sum(phasor * c10[None, :], dim=1)
        yy = torch.sum(phasor * c11[None, :], dim=1)
        out.append(torch.stack([torch.stack([xx, xy], -1),
                                torch.stack([yx, yy], -1)], -2))
    return torch.stack(out, dim=1)                          # [B, F, 2, 2]


def coherencies_generic(sky: SkyArrays, u, v, w, freqs, fdelta,
                        per_channel_flux: bool = False,
                        with_shapelets: bool | None = None, beam=None,
                        dobeam: int = 0, tslot=None, sta1=None, sta2=None):
    """All-cluster coherencies [M, B, F, 2, 2] of any sky, eagerly (the
    JAX package's generic ``coherencies``). One cluster at a time (its
    ``lax.map``); ``n0max`` comes from the mode grid's width and
    ``with_shapelets``, when not given, from one host read of ``sh_n0``.
    With ``beam`` and ``dobeam``, each cluster's beam tables
    (``rime.beam.cluster_beam``) enter its source sum, gathered by
    ``tslot``, ``sta1`` and ``sta2`` [B]."""
    from sagecal_tpu_torch.rime import beam as beam_mod
    if with_shapelets is None:
        with_shapelets = bool((sky.sh_n0 > 0).any())
    n0max = int(round(np.sqrt(sky.sh_modes.shape[-1])))
    out = []
    for m in range(sky.ll.shape[0]):
        csky = SkyArrays(*(f[m] for f in sky))
        bkw = {}
        if beam is not None and dobeam:
            af, E = beam_mod.cluster_beam(beam, csky.ra, csky.dec, freqs,
                                          dobeam)
            bkw = dict(af=af, E=E, tslot=tslot, sta1=sta1, sta2=sta2)
        out.append(_cluster_coherency(csky, u, v, w, freqs, fdelta,
                                      per_channel_flux, n0max,
                                      with_shapelets, **bkw))
    return torch.stack(out)


def coherencies_split(sky_pg, sky_rest, u, v, w, freqs, fdelta,
                      per_channel_flux: bool = False,
                      with_shapelets: bool | None = None):
    """Hybrid coherencies: the coherency kernel (``ops/coh.py``) on the
    point/gaussian half plus :func:`coherencies_generic` on the compact
    rest; either half may be None. The halves keep the clusters in
    order, so their coherencies add elementwise."""
    out = None
    if sky_pg is not None:
        out = coh_ops.coherencies(sky_pg, u, v, w, freqs, fdelta,
                                  per_channel_flux=per_channel_flux)
    if sky_rest is not None:
        rest = coherencies_generic(sky_rest, u, v, w, freqs, fdelta,
                                   per_channel_flux=per_channel_flux,
                                   with_shapelets=with_shapelets)
        out = rest if out is None else out + rest
    return out


def coherencies(sky, u, v, w, freqs, fdelta, per_channel_flux: bool = False,
                beam=None, dobeam: int = 0, tslot=None, sta1=None,
                sta2=None):
    """All-cluster coherencies [M, B, F, 2, 2] complex (no Jones), through
    the split (:func:`coherencies_split`).

    ``sky`` is a :class:`SplitSky` (the pipeline splits once) or a
    SkyArrays, which is split here (:func:`split_arrays`). ``freqs`` is
    the host's channel list (``ops/coh.py:coherencies`` uploads it);
    ``fdelta`` the smearing bandwidth per channel.

    With ``beam`` and ``dobeam`` (``coherencies(beam=...)`` of the JAX
    package, predict_withbeam.c:522/:690) the whole sky takes the
    generic route with the beam tables (:func:`coherencies_generic`;
    both halves of a SplitSky, added), and no coherency kernel runs."""
    if beam is not None and dobeam:
        halves = [sky] if isinstance(sky, SkyArrays) else \
            [h for h in (sky.pg, sky.rest) if h is not None]
        out = None
        for h in halves:
            c = coherencies_generic(h, u, v, w, freqs, fdelta,
                                    per_channel_flux=per_channel_flux,
                                    beam=beam, dobeam=dobeam, tslot=tslot,
                                    sta1=sta1, sta2=sta2)
            out = c if out is None else out + c
        return out
    if not isinstance(sky, SplitSky):
        sky = split_arrays(sky)
    return coherencies_split(sky.pg, sky.rest, u, v, w, freqs, fdelta,
                             per_channel_flux=per_channel_flux,
                             with_shapelets=sky.with_shapelets)


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


def model8(coh_m, J_m, sta1, sta2, chunk_idx_m, out_dtype=None):
    """One cluster's corrupted model J_p C J_q^H as [B, 8] reals
    ((Re, Im) of XX, XY, YX, YY). The model is evaluated in the complex
    dtype of its operands and emitted in ``out_dtype``, the storage dtype
    of the residual stream it joins (``dtypes.to_storage``: the identity
    unless bf16/f16)."""
    Jp = utils.gather_jones(J_m, chunk_idx_m, sta1)
    Jq = utils.gather_jones(J_m, chunk_idx_m, sta2)
    V = utils.mul22(utils.mul22(Jp, coh_m), Jq, conj_b=True)
    out = torch.view_as_real(V.reshape(-1, 4)).reshape(-1, 8)
    return out if out_dtype is None else dtypes.to_storage(out, out_dtype)


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


def predict_visibilities(sky, u, v, w, freqs, fdelta,
                         per_channel_flux: bool = True, cluster_mask=None,
                         beam=None, dobeam: int = 0, tslot=None, sta1=None,
                         sta2=None):
    """Uncorrupted model visibilities summed over clusters [B, F, 2, 2]
    (predict.c:417; with the beam predict_withbeam.c:1155);
    ``cluster_mask`` [M] True keeps a cluster."""
    coh = coherencies(sky, u, v, w, freqs, fdelta,
                      per_channel_flux=per_channel_flux, beam=beam,
                      dobeam=dobeam, tslot=tslot, sta1=sta1, sta2=sta2)
    if cluster_mask is not None:
        keep = torch.as_tensor(np.asarray(cluster_mask), device=coh.device)
        coh = torch.where(keep[:, None, None, None, None], coh,
                          torch.zeros_like(coh))
    return coh.sum(dim=0)
