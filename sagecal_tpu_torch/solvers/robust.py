"""Robust (Student's t) machinery: IRLS weights, nu estimation, robust LM
(port of ``sagecal_tpu/solvers/robust.py``).

The weight E-step w = (nu + 1) / (nu + e^2) is one elementwise op; the
nu updates evaluate all grid candidates at once with
``torch.special.digamma`` and pick the root by an argmin on the device
(no host read). ``robust_lm_solve`` runs the reference's wt_itmax = 3
IRLS rounds of {weighted LM -> weight E-step -> ML nu update}, with the
ordered-subsets inner LM when ``os`` is given. ``whiten_data`` is the
uv-density whitening of ``-W 1``.

Under a reduced storage policy (residuals in bf16/f16) the weights and nu
are float32 and the reweighted sqrt-weights return to the storage dtype
(``robust.py:101`` of the JAX package); the nu grid stays float64.

Over row ranks (``rows``, a ``parallel.RowGroup``) the nu updates' means
divide a sum over every rank's live residuals by their count, both
summed in one collective, so every rank picks the same grid nu.
"""

from __future__ import annotations

import torch

from sagecal_tpu_torch import dtypes
from sagecal_tpu_torch.parallel import row_sums
from sagecal_tpu_torch.solvers import lm as lm_mod
from sagecal_tpu_torch.solvers import normal_eq as ne


def update_weights(e, nu):
    """E-step weights w = (nu + 1) / (nu + e^2) per residual component,
    in the accumulator dtype (e^2 of a storage residual rounded to the
    storage dtype, as the JAX package's promotion leaves it)."""
    return (nu + 1.0) / (nu + dtypes.acc(e * e))


def nu_grid(nulow, nuhigh, nd: int = 30, device=None):
    """The nd candidate nu values, in float64, as the reference's compiled
    programs evaluate ``nulow + k (nuhigh - nulow) / nd`` with constant
    bounds: XLA turns the division into a multiply by 1/nd and folds it
    into the step, which moves some values by one ulp (and with them a
    robust run's nu)."""
    step = (nuhigh - nulow) * (1.0 / nd)
    return nulow + torch.arange(nd, dtype=torch.float64,
                                device=device) * step


def _pick(nus, q, like):
    """The grid nu of least |q|, in the dtype of ``like`` (first on a tie,
    as ``jnp.argmin``)."""
    return nus[torch.argmin(torch.abs(q))].to(torch.as_tensor(like).dtype)


def _live_mean(live, mask, rows):
    """sum(live) / max(1, count(mask)), both over the ranks of ``rows``
    (one collective)."""
    s, n = row_sums((live.sum(), mask.sum().to(live.dtype)), rows, "nu")
    return s / torch.clamp(n, min=1.0)


def update_nu_ml(w, mask, nu_old, nulow=2.0, nuhigh=30.0, nd: int = 30,
                 rows=None):
    """ML nu update from current weights (updatenu.c:137): the grid root
    of psi((nu+1)/2) - ln((nu+1)/2) - psi(nu/2) + ln(nu/2) + 1
    - mean(w - ln w) over the live residuals ``mask`` (of every rank of
    ``rows``)."""
    live = torch.where(mask, w - torch.log(torch.clamp(w, min=1e-30)),
                       torch.zeros_like(w))
    sumq = _live_mean(live, mask, rows)
    nus = nu_grid(nulow, nuhigh, nd, device=w.device)
    dg = torch.special.digamma
    q = (dg((nus + 1.0) * 0.5) - torch.log((nus + 1.0) * 0.5)
         - dg(nus * 0.5) + torch.log(nus * 0.5) - sumq.to(nus.dtype) + 1.0)
    return _pick(nus, q, nu_old)


def mean_logsumw(w, mask, rows=None):
    """1/N sum(ln w_i - w_i) over live residuals (updatenu.c:253-259; of
    every rank of ``rows``)."""
    live = torch.where(mask, torch.log(torch.clamp(w, min=1e-30)) - w,
                       torch.zeros_like(w))
    return _live_mean(live, mask, rows)


def update_nu_aecm(logsumw, nu_old, p: int = 8, nulow=2.0, nuhigh=30.0,
                   nd: int = 30):
    """AECM nu update for a p-variate t (updatenu.c:264); ``logsumw`` =
    :func:`mean_logsumw`. The robust RTR/NSD family calls it with p = 2."""
    nu64 = torch.as_tensor(nu_old).to(torch.float64)
    dg = torch.special.digamma
    dgm = dg((nu64 + p) * 0.5) - torch.log((nu64 + p) * 0.5)
    nus = nu_grid(nulow, nuhigh, nd, device=nu64.device)
    q = (-dg(nus * 0.5) + torch.log(nus * 0.5)
         - (-torch.as_tensor(logsumw).to(torch.float64) - dgm) + 1.0)
    return _pick(nus, q, nu_old)


def lane_nu(nu, w, mask, lanes, update):
    """A nu update per visit of a group: ``update(w_v, mask_v, nu_v)`` on
    each visit's rows of ``w`` (folded [V B, 8]) and ``mask`` (folded or
    shared); the serial call when ``lanes`` is None."""
    if lanes is None:
        return update(w, mask, nu)
    wv = lanes.visits(w)
    mv = lanes.visits(mask)
    return torch.stack([update(wv[v], mv if lanes.shared(mask) else mv[v],
                               nu[v]) for v in range(lanes.V)])


def robust_lm_solve(x8, coh, sta1, sta2, chunk_id, wt_base, J0,
                    n_stations: int, nu0=2.0, nulow=2.0, nuhigh=30.0,
                    chunk_mask=None, config=lm_mod.LMConfig(),
                    wt_rounds: int = 3, itmax_dynamic=None, os=None,
                    row_period: int = 0, lists=None, lanes=None, admm=None):
    """Student's-t IRLS-LM (rlevmar_der_single_nocuda, robustlm.c:2008);
    with ``os`` the ordered-subsets variant (robustlm.c:2607): the inner
    LM sees subsets while the weight and nu updates stay full-data.

    ``wt_base`` [B, 8] 0/1 row weights; the robust sqrt(w) multiplies it.
    Returns (J, nu, info); nu is one scalar tensor shared by all chunks.
    With ``lanes`` (``lm.lm_solve``) nu0 and nu are [V], one per visit,
    and ``os`` holds one setting per visit. ``admm`` (y, bz, rho) passes
    to every inner LM (the consensus augmentation, ``lm.lm_solve``)."""
    mask = wt_base > 0
    nu = torch.as_tensor(nu0, dtype=dtypes.acc_dtype(x8.dtype),
                         device=x8.device)
    J = J0
    # per-row views of a group's shared weights and per-visit nu
    wt_r = wt_base if lanes is None else lanes.rows(wt_base)

    def nu_rows(n):
        return n if lanes is None else lanes.per_row(n)

    infos = []
    for rs in range(wt_rounds):
        if rs == 0:
            wt = wt_base
        else:
            e = ne.residual8(x8, J, coh, sta1, sta2, chunk_id)
            wt = dtypes.to_storage(
                wt_r * torch.sqrt(update_weights(e, nu_rows(nu))),
                wt_base.dtype)
        # distinct subset draws per IRLS round
        if os is None:
            os_r = None
        elif lanes is None:
            os_r = os._replace(seed=lm_mod.fold_in(os.seed, 7919 + rs))
        else:
            os_r = [o._replace(seed=lm_mod.fold_in(o.seed, 7919 + rs))
                    for o in os]
        J, info = lm_mod.lm_solve(x8, coh, sta1, sta2, chunk_id, wt, J,
                                  n_stations, chunk_mask, config,
                                  itmax_dynamic=itmax_dynamic, os=os_r,
                                  row_period=row_period, lists=lists,
                                  lanes=lanes, admm=admm)
        e2 = ne.residual8(x8, J, coh, sta1, sta2, chunk_id)
        w2 = update_weights(e2, nu_rows(nu))
        nu = lane_nu(nu, w2, mask, lanes,
                     lambda w_, m_, n_: update_nu_ml(w_, m_, n_, nulow,
                                                     nuhigh,
                                                     rows=config.rows))
        infos.append(info)
    return J, nu, {"init_cost": infos[0]["init_cost"],
                   "final_cost": infos[-1]["final_cost"],
                   "iters": sum(i["iters"] for i in infos),
                   "cg_iters": sum(i["cg_iters"] for i in infos)}


def ncp_weight(uvdist):
    """Inverse uv-density taper 1/(1 + 1.8 exp(-0.05 d)), flat (1) for
    d > 400 wavelengths (``robust.ncp_weight``, updatenu.c:343-350)."""
    w = 1.0 / (1.0 + 1.8 * torch.exp(-0.05 * uvdist))
    return torch.where(uvdist > 400.0, torch.ones_like(w), w)


def whiten_data(x, u, v, freq0):
    """uv-density whitening of visibility rows (``-W 1``;
    ``robust.whiten_data``, updatenu.c:386): every entry of row b is
    scaled by ``ncp_weight(|uv_b|)``, |uv| in wavelengths at ``freq0``
    (u, v in seconds). x [B, ...] real or complex."""
    uu = u * freq0
    vv = v * freq0
    a = ncp_weight(torch.sqrt(uu * uu + vv * vv))
    rdt = x.real.dtype if x.is_complex() else x.dtype
    return x * a.reshape((-1,) + (1,) * (x.ndim - 1)).to(rdt)
