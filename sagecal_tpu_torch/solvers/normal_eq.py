"""Residuals, costs and the PCG preconditioner of the per-direction
solve (port of the parts of ``sagecal_tpu/solvers/normal_eq.py`` the
fused-sweep route needs).

Real parametrization per station: 8 reals, (Re, Im) of J in row-major
order (00, 01, 10, 11); residual 8-vector per row likewise (Re, Im) of
(V00, V01, V10, V11). The XLA normal-equation assembly (``--kernel
xla``) is ROADMAP queue A item 3.
"""

from __future__ import annotations

import torch

from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.utils import jones_c2r, jones_r2c  # noqa: F401


def residual8(x8, J, coh, sta1, sta2, chunk_id):
    """Real residual r = x - vec(J_p C J_q^H): [B, 8].

    x8 [B, 8]; J [K, N, 2, 2] complex; coh [B, 2, 2]; chunk_id [B]."""
    return x8 - rp.model8(coh, J, sta1, sta2, chunk_id)


def weighted_cost(x8, J, coh, sta1, sta2, chunk_id, wt, kmax: int):
    """Weighted residual cost per chunk [K] (no Jacobians);
    ``index_add_`` sums the rows of each chunk."""
    r = residual8(x8, J, coh, sta1, sta2, chunk_id) * wt
    return r.new_zeros((kmax,)).index_add_(0, chunk_id.long(),
                                           (r * r).sum(dim=1))


def gn_precond_factor(D, shift):
    """Lower Cholesky factors [K, N, 2, md, md] of the station-block
    preconditioner D[k, n, a] + shift_k I: the exact station-diagonal
    blocks of (JTJ + shift I). ``shift`` [K] is > 0 on the solve path, so
    every block is positive definite (``cholesky_ex``: no host sync)."""
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    L, _ = torch.linalg.cholesky_ex(D + shift[:, None, None, None, None]
                                    * eye)
    return L


def gn_precond_apply(L, r, kmax: int, n_stations: int):
    """z = M^-1 r with the factored station-block preconditioner; r and
    z are [K, 2 md N]."""
    md = L.shape[-1]
    rr = r.reshape(kmax, n_stations, 2, md, 1)
    return torch.cholesky_solve(rr, L).reshape(kmax, 2 * md * n_stations)
