"""Residual computation, subtraction and correction (port of
``sagecal_tpu/rime/residual.py``).

The full-batch write-back path: per-channel model with catalog spectra,
subtraction of J_p C J_q^H for subtractable clusters, and the optional
MMSE-regularized correction by one cluster's solutions (``-k``). The
phase-only correction (``-J``) and the simulation modes come later.
"""

from __future__ import annotations

import torch

from sagecal_tpu_torch import dtypes, utils
from sagecal_tpu_torch.rime import predict as rp


def residual_writeback(res, out_dtype=None):
    """[..., 2, 2] complex residual -> stacked real pairs [..., 2] in the
    storage dtype (the identity for the ported float32/float64)."""
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


def correct_by_cluster(res, J_m, sta1, sta2, chunk_idx_m, rho):
    """inv(J_p) res inv(J_q)^H with cluster m's solutions; res
    [B, F, 2, 2]."""
    Jinv = mmse_inverse(J_m, rho)
    Gp = utils.gather_jones(Jinv, chunk_idx_m, sta1)[:, None]
    Gq = utils.gather_jones(Jinv, chunk_idx_m, sta2)[:, None]
    return utils.mul22(utils.mul22(Gp, res), Gq, conj_b=True)


def calculate_residuals_multifreq(sky, J, x, u, v, w, freqs,
                                  fdelta_chan, sta1, sta2, chunk_idx,
                                  subtract_mask, correct_idx=None,
                                  rho: float = 1e-9):
    """Residual x - sum_m J_p C_m(f) J_q^H over subtractable clusters.

    x [B, F, 2, 2]; J [M, Kmax, N, 2, 2]; chunk_idx [M, B];
    subtract_mask [M] bool; ``correct_idx`` the padded index of the
    cluster whose solutions correct the residual; ``sky`` a
    ``rime.predict.SplitSky`` (or a SkyArrays, split per call) and
    ``freqs`` the host's channel list (``rime.predict.coherencies``)."""
    coh = rp.coherencies(sky, u, v, w, freqs, fdelta_chan,
                         per_channel_flux=True)
    model = rp.predict_model(coh, J, sta1, sta2, chunk_idx,
                             cluster_mask=subtract_mask)
    del coh
    res = x - model
    if correct_idx is not None:
        res = correct_by_cluster(res, J[correct_idx], sta1, sta2,
                                 chunk_idx[correct_idx], rho)
    return res
