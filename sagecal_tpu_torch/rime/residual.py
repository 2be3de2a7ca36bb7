"""Residual computation, subtraction and correction (port of
``sagecal_tpu/rime/residual.py``).

The full-batch write-back path: per-channel model with catalog spectra,
subtraction of J_p C J_q^H for subtractable clusters, and the optional
MMSE-regularized correction by one cluster's solutions (``-k``), with
``-J 1`` by their phases alone (``consensus/manifold.extract_phases`` per
chunk), or by an older set of solutions (:func:`calculate_residuals_
interp`); and the simulation modes ``-a 1/2/3`` (replace, add, subtract the
model, optionally corrupted by solutions, without the clusters of a
``-z`` ignore list). The coherencies come from ``rime.predict.coherencies``
(the coherency kernel on the point/gaussian half of the sky on the card;
with the station beam, ``beam`` and ``dobeam``, the generic predict with
the beam tables).
"""

from __future__ import annotations

import torch

from sagecal_tpu_torch import dtypes, utils
from sagecal_tpu_torch.consensus import manifold as mf
from sagecal_tpu_torch.rime import predict as rp


def residual_writeback(res, out_dtype=None):
    """[..., 2, 2] complex residual -> stacked real pairs [..., 2] in the
    storage dtype ``out_dtype`` of the policy: rounded to bf16/f16 under a
    reduced one, unchanged at float32/float64."""
    out = utils.c2r(res)
    return out if out_dtype is None else dtypes.to_storage(out, out_dtype)


def mmse_inverse(J, rho):
    """Regularized 2x2 inverse inv(J + rho I), det nudged by rho when
    nearly singular (reference residual.c mat_invert)."""
    eye = torch.eye(2, dtype=J.dtype, device=J.device)
    a = J + rho * eye
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = torch.where(torch.sqrt(torch.abs(det)) <= rho, det + rho, det)
    inv = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1),
    ], -2)
    return inv / det[..., None, None]


def correct_by_cluster(res, J_m, sta1, sta2, chunk_idx_m, rho,
                       phase_only: bool = False):
    """inv(J_p) res inv(J_q)^H with cluster m's solutions J_m [K, N, 2,
    2]; res [B, F, 2, 2]. With ``phase_only`` (``-J 1``) each chunk's
    solutions are first reduced to unit-modulus diagonal phases
    (:func:`consensus.manifold.extract_phases`)."""
    if phase_only:
        J_m = mf.extract_phases(J_m)
    Jinv = mmse_inverse(J_m, rho)
    Gp = utils.gather_jones(Jinv, chunk_idx_m, sta1)[:, None]
    Gq = utils.gather_jones(Jinv, chunk_idx_m, sta2)[:, None]
    return utils.mul22(utils.mul22(Gp, res), Gq, conj_b=True)


def residual_from_coherencies(coh, J, x, sta1, sta2, chunk_idx,
                              subtract_mask, correct_idx=None,
                              rho: float = 1e-9, phase_only: bool = False):
    """x - sum_m J_p C_m J_q^H over subtractable clusters, corrected by
    cluster ``correct_idx``: the residual of :func:`calculate_residuals_
    multifreq` from coherencies coh [M, B, F, 2, 2] already predicted (the
    ``-b 1`` path slices one call's channels)."""
    res = x - rp.predict_model(coh, J, sta1, sta2, chunk_idx,
                               cluster_mask=subtract_mask)
    if correct_idx is not None:
        res = correct_by_cluster(res, J[correct_idx], sta1, sta2,
                                 chunk_idx[correct_idx], rho,
                                 phase_only=phase_only)
    return res


def calculate_residuals_multifreq(sky, J, x, u, v, w, freqs,
                                  fdelta_chan, sta1, sta2, chunk_idx,
                                  subtract_mask, correct_idx=None,
                                  rho: float = 1e-9,
                                  phase_only: bool = False, beam=None,
                                  dobeam: int = 0, tslot=None):
    """Residual x - sum_m J_p C_m(f) J_q^H over subtractable clusters.

    x [B, F, 2, 2]; J [M, Kmax, N, 2, 2]; chunk_idx [M, B];
    subtract_mask [M] bool; ``correct_idx`` the padded index of the
    cluster whose solutions correct the residual (by their phases alone
    with ``phase_only``); ``sky`` a ``rime.predict.SplitSky`` (or a
    SkyArrays, split per call) and ``freqs`` the host's channel list
    (``rime.predict.coherencies``). With ``beam``/``dobeam`` and the
    rows' timeslots ``tslot`` this is
    calculate_residuals_multifreq_withbeam (predict_withbeam.c:1895)."""
    coh = rp.coherencies(sky, u, v, w, freqs, fdelta_chan,
                         per_channel_flux=True, beam=beam, dobeam=dobeam,
                         tslot=tslot, sta1=sta1, sta2=sta2)
    return residual_from_coherencies(coh, J, x, sta1, sta2, chunk_idx,
                                     subtract_mask, correct_idx, rho,
                                     phase_only)


def calculate_residuals_interp(sky, J_old, J_new, x, u, v, w, freqs,
                               fdelta_chan, sta1, sta2, chunk_idx,
                               subtract_mask, correct_idx=None,
                               rho: float = 1e-9):
    """Residuals with old-solution correction (``calculate_residuals_
    interp`` of the JAX package, ``rime/residual.py:97``; reference
    residual.c:201): the model corrupted by the NEW solutions J_new is
    subtracted, and the residual is corrected by the inverse of the OLD
    solutions J_old of cluster ``correct_idx``. The reference's time
    interpolation between the two is disabled upstream (residual.c:288),
    so, as in the JAX package, there is none. Arguments as
    :func:`calculate_residuals_multifreq`'s (no beam)."""
    coh = rp.coherencies(sky, u, v, w, freqs, fdelta_chan,
                         per_channel_flux=True, sta1=sta1, sta2=sta2)
    res = x - rp.predict_model(coh, J_new, sta1, sta2, chunk_idx,
                               cluster_mask=subtract_mask)
    if correct_idx is not None:
        res = correct_by_cluster(res, J_old[correct_idx], sta1, sta2,
                                 chunk_idx[correct_idx], rho)
    return res


def simulate_visibilities(sky, x, u, v, w, freqs, fdelta_chan, sta1, sta2,
                          mode: int, J=None, chunk_idx=None,
                          ignore_mask=None, beam=None, dobeam: int = 0,
                          tslot=None):
    """Simulation modes ``-a 1/2/3`` (``residual.simulate_visibilities``;
    residual.c:1242, :1601): the model replaces (1), is added to (2) or
    subtracted from (3) x [B, F, 2, 2].

    ``J`` [M, Kmax, N, 2, 2] (optional) corrupts the model with the
    chunk map ``chunk_idx`` [M, B]; ``ignore_mask`` [M] True keeps a
    cluster in the model (the ``-z`` list names clusters to leave out).
    The JAX function's ``correct_idx`` is left out: its pipeline never
    passes it. ``beam``/``dobeam``/``tslot``: the model through the
    station beam (Radio.h:400-446)."""
    coh = rp.coherencies(sky, u, v, w, freqs, fdelta_chan,
                         per_channel_flux=True, beam=beam, dobeam=dobeam,
                         tslot=tslot, sta1=sta1, sta2=sta2)
    M = coh.shape[0]
    mask = [True] * M if ignore_mask is None else \
        [bool(k) for k in ignore_mask]
    if J is not None:
        model = rp.predict_model(coh, J, sta1, sta2, chunk_idx,
                                 cluster_mask=mask)
    else:
        model = torch.zeros(coh.shape[1:], dtype=coh.dtype,
                            device=coh.device)
        for m in range(M):
            if mask[m]:
                model += coh[m]
    del coh
    if mode == 2:       # SIMUL_ADD
        return x + model
    if mode == 3:       # SIMUL_SUB
        return x - model
    return model        # SIMUL_ONLY
