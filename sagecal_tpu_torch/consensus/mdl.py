"""Model-order selection for the consensus frequency polynomial (port of
``sagecal_tpu/consensus/mdl.py``; reference ``mdl.c``
``minimum_description_length``:42, the ``--mdl`` report of the MPI CLI).

Scan the polynomial orders K in [kstart, kfinish]; for each, estimate
the consensus Z from the per-subband (rho-weighted) solutions, take the
residual sum of squares of the polynomial fit across frequency, and
score AIC(K) = F log(RSS/F) + 2K and MDL(K) = F/2 log(RSS/F) + K/2
log(F) (mdl.c:231-262). Host-side float64 on numpy inputs; the small
pseudo-inverses go through :func:`poly.find_prod_inverse` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from sagecal_tpu_torch.consensus import poly as cpoly


def minimum_description_length(J, rho, freqs, freq0: float, weight=None,
                               polytype: int = 2, kstart: int = 1,
                               kfinish: int = 5):
    """Scan the consensus polynomial orders and score them.

    J [F, M, ...] per-subband rho-weighted solutions (any trailing shape
    is flattened); rho [M] per-cluster regularization; weight [F]
    per-subband weights (flag ratios), default 1. Returns a dict with
    ``orders``, ``aic``, ``mdl``, ``best_aic``, ``best_mdl``."""
    J = np.asarray(J, np.float64)
    F, M = J.shape[0], J.shape[1]
    rest = int(np.prod(J.shape[2:]))
    J = J.reshape(F, M, rest)
    rho = np.broadcast_to(np.asarray(rho, np.float64), (M,))
    weight = (np.ones(F) if weight is None
              else np.asarray(weight, np.float64))
    freqs = np.asarray(freqs, np.float64)

    inv_rho = np.where(rho > 0.0, 1.0 / np.maximum(rho, 1e-300), 0.0)
    orders = list(range(kstart, kfinish + 1))
    aic = np.zeros(len(orders))
    mdl = np.zeros(len(orders))
    for i, K in enumerate(orders):
        # the constant polynomial always takes type 1 (mdl.c:127)
        B = cpoly.setup_polynomials(freqs, freq0, K,
                                    1 if K == 1 else polytype)    # [F, K]
        rho_w = np.tile(weight[None, :], (M, 1))                  # [M, F]
        Bii = cpoly.find_prod_inverse(torch.as_tensor(B),
                                      torch.as_tensor(rho_w)).numpy()
        # z = sum_f B_f (J_f / rho)  (mdl.c:140-156)
        Jsc = J * inv_rho[None, :, None]
        zsum = np.einsum("fp,fmr->mpr", B, Jsc)
        Z = np.einsum("mpq,mqr->mpr", Bii, zsum)                  # [M, K, r]
        # the fit's residual E_f = J_f / (rho w_f) - B_f Z (mdl.c:176-229)
        BZ = np.einsum("fp,mpr->fmr", B, Z)
        inv_w = np.where(weight > 0.0, 1.0 / np.maximum(weight, 1e-300), 0.0)
        E = Jsc * inv_w[:, None, None] - BZ
        # RSS per data point: mdl.c:230 divides by the 8NM block size
        rss = float(np.sum(E * E)) / (M * rest)
        aic[i] = F * np.log(max(rss / F, 1e-300)) + 2.0 * K
        mdl[i] = 0.5 * F * np.log(max(rss / F, 1e-300)) \
            + 0.5 * K * np.log(F)
    return {
        "orders": orders, "aic": aic, "mdl": mdl,
        "best_aic": orders[int(np.argmin(aic))],
        "best_mdl": orders[int(np.argmin(mdl))],
    }


def report(result, log=print):
    """The mdl.c:265-266 summary line."""
    log(f"Finding best fitting polynomials: MDL "
        f"{result['mdl'].min():.6f} for polynomial terms="
        f"{result['best_mdl']}, AIC {result['aic'].min():.6f} "
        f"for polynomial terms={result['best_aic']}")
