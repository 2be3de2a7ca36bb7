"""Residuals, costs, the XLA-route normal equations, the PCG
preconditioner and the constrained Jones modes of the per-direction solve
(port of ``sagecal_tpu/solvers/normal_eq.py``).

Real parametrization per station: 8 reals, (Re, Im) of J in row-major
order (00, 01, 10, 11); residual 8-vector per row likewise (Re, Im) of
(V00, V01, V10, V11).

The XLA-route assembly (``--kernel xla``, and the fallback when the fused
sweep does not fit: ``solvers/lm.py:use_sweep``) is eager PyTorch, as it
is XLA in the JAX package: :func:`normal_equations` (the dense (JTJ, JTe,
cost) of ``--inner chol``) and :func:`gn_factors` / :func:`gn_matvec` (the
matrix-free operator of ``--inner cg``), from the two [B, 2, 2, 4]
Wirtinger factors (:func:`_ma_factor`, :func:`_mb_factor`); the per-row
Jacobians are never formed. Each aggregates per station in one of two
ways: the baseline-major contraction over the time axis when every visit
solves one chunk and the rows are [T, nbase] (``row_period``), else the
generic ``index_add_`` scatter. ``_normal_equations_dense`` stays the
tests' oracle in the JAX package and is not ported.

Reduced storage (``--dtype-policy bf16|f16``: x8 and wt arrive in bf16 or
f16; ``dtypes``): the model emits the storage dtype where it joins the
residual stream, the Wirtinger factors MA/MB (FA/FB in the modes) and the
squared weights stay in it, and every contraction and sum runs in float32
on operands upcast exactly (``dtypes.pet``, the JAX package's
``preferred_element_type``), so D, JTe, the cost and the dense JTJ are
float32. :func:`normal_equations` with one chunk a visit and baseline-major
rows forms its weighted Gram operands in float32 from the storage arrays
(``_reduced_gram_baseline_major`` of the JAX package); the generic scatter
weights in the storage dtype first (``_normal_equations_reduced``). The
ordered-subsets body of the reduced policy assembles from the subset's
rows alone (:func:`os_subset_equations`, :func:`os_subset_equations_mode`).
Every cast is the identity at float32/float64, so the default policy runs
the code it ran before.

In-flight groups (``ops.sweep.Lanes``: rows [V B], chunk ids v K + k,
Jones [V K, N]) go through the same functions with ``visits`` = V: the
generic scatter serves the folded layout as it is, and the baseline-major
contraction runs per visit on the rows reshaped to [V, T, nbase] (one
chunk per visit: chunk v), as the JAX package's vmapped solve does.

Constrained Jones modes (``--jones diag|phase``, ``normal_eq.py:700-1049``
of the JAX package): the per-station parameter vector shrinks from 8 reals
to 4 (diag: Re/Im of j00 and j11) or 2 (phase: the angles theta of
J = diag(Jref) exp(i theta), amplitudes frozen at the entry Jones
``Jref``). The Gram structure stays: per station the blocks are
[2, md, md] with md = 4, 2, 1 (:func:`jones_mdim`), from the reduced
factors of :func:`_mode_factors`. :func:`normal_equations_mode`,
:func:`gn_factors_mode` and :func:`gn_matvec_mode` are the mode-aware XLA
assembly; in full mode each delegates to the full-Jones function, so the
full route is unchanged bit for bit.

One subband's rows over ranks (``rows``, a ``parallel.RowGroup``;
``--shard-baselines``): every assembly sums its per-rank contractions
over the ranks in one ``parallel.row_sums`` collective before anything
is formed from them (the dense expansion, a shift), and
:func:`gn_matvec` / :func:`gn_matvec_mode` sum each product, one
collective a PCG or tCG trip. Without a group nothing changes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sagecal_tpu_torch import dtypes
from sagecal_tpu_torch.parallel import row_sum, row_sums
from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.utils import jones_c2r, jones_r2c


def residual8(x8, J, coh, sta1, sta2, chunk_id):
    """Real residual r = x - vec(J_p C J_q^H): [B, 8], in the storage
    dtype of x8 (the model rounded to it first).

    x8 [B, 8]; J [K, N, 2, 2] complex; coh [B, 2, 2]; chunk_id [B]."""
    return x8 - rp.model8(coh, J, sta1, sta2, chunk_id, out_dtype=x8.dtype)


def weighted_cost(x8, J, coh, sta1, sta2, chunk_id, wt, kmax: int,
                  rows=None):
    """Weighted residual cost per chunk [K] (no Jacobians);
    ``index_add_`` sums the rows of each chunk in the accumulator dtype
    (then over the ranks of ``rows``)."""
    r = dtypes.acc(residual8(x8, J, coh, sta1, sta2, chunk_id) * wt)
    return row_sum(r.new_zeros((kmax,)).index_add_(0, chunk_id.long(),
                                                   (r * r).sum(dim=1)),
                   rows, "cost")


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


def _real_jac(D, conj_param: bool):
    """Complex derivative tensor [B, 2, 2, 2, 2] -> real Jacobian [B, 8, 8]:
    D[b, a, o, c, d] = dV_ao / dtheta_cd with theta the complex parameter
    (its conjugate when ``conj_param``); rows (Re, Im) of V, columns
    (Re, Im) of theta, both row-major."""
    B = D.shape[0]
    Dr, Di = D.real, D.imag
    J = torch.stack([
        torch.stack([Dr, Di if conj_param else -Di], dim=-1),    # ri = Re
        torch.stack([Di, -Dr if conj_param else Dr], dim=-1),    # ri = Im
    ], dim=3)  # [B, a, o, ri, c, d, ci]
    return J.reshape(B, 8, 8)


def baseline_jacobians(J, coh, sta1, sta2, chunk_id):
    """Per-baseline real Jacobian blocks (dV/dtheta_p, dV/dtheta_q):
    [B, 8, 8] each."""
    Jp = J[chunk_id, sta1]
    Jq = J[chunk_id, sta2]
    A = coh @ Jq.conj().transpose(-1, -2)
    Bm = Jp @ coh
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    Dp = torch.einsum("ac,bdo->baocd", eye, A)
    Dq = torch.einsum("oc,bad->baocd", eye, Bm)
    return _real_jac(Dp, conj_param=False), _real_jac(Dq, conj_param=True)


def _ma_factor(A):
    """[B, 2, 2] complex A (dV_ao/d(J_p)_ad = A_do) -> MA [B, 2, 2, 4] real,
    MA[b, o, ri, (d, ci)]: the 4x4 block every station-p Jacobian row
    block repeats."""
    Ar = A.real.transpose(-1, -2)                  # [B, o, d]
    Ai = A.imag.transpose(-1, -2)
    MA = torch.stack([torch.stack([Ar, -Ai], -1),  # ri = Re
                      torch.stack([Ai, Ar], -1)], 2)  # ri = Im
    return MA.reshape(A.shape[0], 2, 2, 4)


def _mb_factor(Bm):
    """[B, 2, 2] complex Bm (dV_ao/d(conj J_q)_od = Bm_ad) -> MB
    [B, 2, 2, 4] real, MB[b, a, ri, (d, ci)] (conjugate-linear: the
    Im-parameter column flips sign)."""
    Br, Bi = Bm.real, Bm.imag                      # [B, a, d]
    MB = torch.stack([torch.stack([Br, Bi], -1),   # ri = Re
                      torch.stack([Bi, -Br], -1)], 2)  # ri = Im
    return MB.reshape(Bm.shape[0], 2, 2, 4)


def _row_pass(x8, J, coh, sta1, sta2, chunk_id, wt, cost_wt):
    """The one [B] pass shared by the assemblies: (MA, MB, r w, the cost's
    weighted residual); the factors and r w in the storage dtype of x8,
    the cost's residual in its accumulator dtype."""
    st = x8.dtype
    Jp = J[chunk_id, sta1]                         # [B, 2, 2]
    Jq = J[chunk_id, sta2]
    A = coh @ Jq.conj().transpose(-1, -2)          # dV/dJp factor
    Bm = Jp @ coh                                  # dV/dconj(Jq) factor
    V = Jp @ A                                     # = Jp C Jq^H
    r = x8 - dtypes.to_storage(
        torch.view_as_real(V.reshape(-1, 4)).reshape(-1, 8), st)
    rw = r * wt
    rc = rw if cost_wt is None else r * cost_wt
    return (dtypes.to_storage(_ma_factor(A), st),
            dtypes.to_storage(_mb_factor(Bm), st), rw, dtypes.acc(rc))


def _baseline_major(kmax: int, row_period: int, B: int, visits: int):
    """True when the aggregation contracts the time axis per visit: one
    chunk per visit and [visits, T, nbase] rows."""
    return (kmax == visits and row_period > 0
            and B % (visits * row_period) == 0)


def _index(chunk_id, sta, N: int):
    return chunk_id * N + sta


def _aggregate(MA, MB, wt, rw, rc, sta1, sta2, chunk_id, N: int, kmax: int,
               row_period: int, visits: int, cross: bool):
    """The station aggregation of one [B] pass: (D [K, N, 2, 4, 4], the
    cross blocks O [K, N N, 2, 2, 4, 4] when ``cross`` else None, JTe
    [K, N, 2, 4], cost [K]). Per visit by the time-axis contraction onto
    [nbase] blocks when :func:`_baseline_major`, else the generic
    ``index_add_`` scatter with the weights folded into one [B, 2, 2, 2,
    4] product each (every contraction a plain batched product). Storage
    operands (bf16/f16) weight in their dtype and contract in float32
    (``dtypes.pet``); ``rc`` arrives in the accumulator dtype."""
    B = rw.shape[0]
    dt, dev = dtypes.acc_dtype(rw.dtype), rw.device
    pet = dtypes.pet
    O = None
    if _baseline_major(kmax, row_period, B, visits):
        nb = row_period
        T = B // (visits * nb)
        wv = wt.reshape(visits, T, nb, 2, 2, 2)    # [v, t, n, a, o, ri]
        WMAh = wv[..., None] * MA.reshape(visits, T, nb, 1, 2, 2, 4)
        WMBh = wv[..., None] * MB.reshape(visits, T, nb, 2, 1, 2, 4)
        WMAh, WMBh, rwv = pet(WMAh, WMBh, rw.reshape(visits, T, nb, 2, 2, 2))
        pp = torch.einsum("vtnaori,vtnaorj->vnaij", WMAh, WMAh)
        qq = torch.einsum("vtnaori,vtnaorj->vnoij", WMBh, WMBh)
        jtep = torch.einsum("vtnaori,vtnaor->vnai", WMAh, rwv)
        jteq = torch.einsum("vtnaori,vtnaor->vnoi", WMBh, rwv)
        s1b, s2b = sta1[:nb], sta2[:nb]
        D = torch.zeros((visits, N, 2, 4, 4), dtype=dt, device=dev)
        D.index_add_(1, s1b, pp).index_add_(1, s2b, qq)
        if cross:
            pq = torch.einsum("vtnaori,vtnaorj->vnaoij", WMAh, WMBh)
            O = torch.zeros((visits, N * N, 2, 2, 4, 4), dtype=dt,
                            device=dev)
            O.index_add_(1, s1b * N + s2b, pq)
        JTe = torch.zeros((visits, N, 2, 4), dtype=dt, device=dev)
        JTe.index_add_(1, s1b, jtep).index_add_(1, s2b, jteq)
        return D, O, JTe, (rc * rc).reshape(visits, -1).sum(dim=1)
    w2 = (wt * wt).reshape(B, 2, 2, 2)             # [B, a, o, ri]
    rw2 = (rw * wt).reshape(B, 2, 2, 2)            # w^2 r
    WMA = w2[..., None] * MA[:, None]              # [B, a, o, ri, 4]
    WMB = w2[..., None] * MB[:, :, None]
    WMA, WMB, rw2, MA, MB = pet(WMA, WMB, rw2, MA, MB)
    pp = torch.einsum("baori,borj->baij", WMA, MA)
    qq = torch.einsum("baorj,bari->boij", WMB, MB)
    jtep = torch.einsum("baor,bori->bai", rw2, MA)
    jteq = torch.einsum("baor,bari->boi", rw2, MB)
    i1, i2 = _index(chunk_id, sta1, N), _index(chunk_id, sta2, N)
    D = torch.zeros((kmax * N, 2, 4, 4), dtype=dt, device=dev)
    D.index_add_(0, i1, pp).index_add_(0, i2, qq)
    if cross:
        pq = torch.einsum("baori,barj->baoij", WMA, MB)
        O = torch.zeros((kmax * N * N, 2, 2, 4, 4), dtype=dt, device=dev)
        O.index_add_(0, i1 * N + sta2, pq)
    JTe = torch.zeros((kmax * N, 2, 4), dtype=dt, device=dev)
    JTe.index_add_(0, i1, jtep).index_add_(0, i2, jteq)
    cost = torch.zeros((kmax,), dtype=dt, device=dev).index_add_(
        0, chunk_id, (rc * rc).sum(dim=1))
    return D, O, JTe, cost


def normal_equations(x8, J, coh, sta1, sta2, chunk_id, wt, n_stations: int,
                     kmax: int, cost_wt=None, row_period: int = 0,
                     visits: int = 1, rows=None):
    """Weighted Gauss-Newton normal equations, batched over chunks: (JTJ
    [K, 8N, 8N], JTe [K, 8N], cost [K]) with cost = sum_b ||wt_b r_b||^2
    (``normal_eq.normal_equations``).

    ``wt`` [B, 8] are sqrt-weights (0 for flagged rows, sqrt(w) for IRLS);
    ``cost_wt`` an optional second set the cost uses instead (the OS
    body's full-data acceptance cost beside subset equations);
    ``row_period`` the rows' baseline period, which with one chunk per
    visit turns the station aggregation into a contraction over time
    (module docstring; ``visits`` the V of a folded group). The station-
    pair cross blocks are aggregated once and symmetrized densely.

    Under a reduced storage dtype the outputs are float32; with one chunk
    a visit and baseline-major rows the weighted Gram operands are formed
    in float32 from the storage arrays (``_reduced_gram_baseline_major``
    of the JAX package), elsewhere weighted in the storage dtype
    (``_normal_equations_reduced``). With ``rows`` the station blocks,
    JTe and the cost are summed over the ranks before the expansion."""
    N = n_stations
    MA, MB, rw, rc = _row_pass(x8, J, coh, sta1, sta2, chunk_id, wt,
                               cost_wt)
    if dtypes.is_reduced(x8.dtype) \
            and _baseline_major(kmax, row_period, x8.shape[0], visits):
        MA, MB, wt, rw = dtypes.pet(MA, MB, wt, rw)
    D, O, JTe, cost = row_sums(
        _aggregate(MA, MB, wt, rw, rc, sta1, sta2, chunk_id, N, kmax,
                   row_period, visits, cross=True), rows, "normal_eq")
    return _dense(D, O, kmax, N), JTe.reshape(kmax, 8 * N), cost


def _dense(D, O, kmax: int, N: int):
    """The dense [K, 8N, 8N] JTJ of the station blocks D and the cross
    blocks O of :func:`_aggregate`."""
    # dense expansion: off-diagonal station blocks [8, 8] from the pq
    # blocks at (row c, col c'), symmetrized; station-diagonal blocks the
    # block-diagonal embeddings of D
    Off = O.view(kmax, N, N, 2, 2, 4, 4).permute(0, 1, 2, 3, 5, 4, 6) \
        .reshape(kmax, N, N, 8, 8)
    JTJ = Off + Off.transpose(1, 2).transpose(-1, -2)
    eye2 = torch.eye(2, dtype=D.dtype, device=D.device)
    Dfull = torch.einsum("knaij,ab->knaibj", D.view(kmax, N, 2, 4, 4),
                         eye2).reshape(kmax, N, 8, 8)
    idx = torch.arange(N, device=D.device)
    JTJ[:, idx, idx] += Dfull
    return JTJ.permute(0, 1, 3, 2, 4).reshape(kmax, 8 * N, 8 * N)


def _os_subset_pass(x8, J, coh, sta1, sta2, wt, os_id, subset: int,
                    ntper: int, row_period: int, cost_wt):
    """The prelude of the reduced OS subset equations: one whole-[B] model
    pass (kmax == 1, J already constrained) for the acceptance cost over
    every row (``cost_wt``), and the subset's contiguous rows. Subset
    ``subset`` is the block of ``ntper`` timeslots at ``subset ntper
    row_period`` (clamped for the short tail block, whose rows of another
    subset the re-masked weights drop). Returns (sl, Jp, Jq, JqH, Bm, r,
    cost [1], wts), r the storage-dtype residual of every row and wts the
    subset's masked weights."""
    B = x8.shape[0]
    st = x8.dtype
    bs = ntper * row_period
    start = min(int(subset) * bs, B - bs)
    sl = slice(start, start + bs)
    Jp = J[0][sta1]                                # kmax == 1
    Jq = J[0][sta2]
    JqH = Jq.conj().transpose(-1, -2)
    Bm = Jp @ coh
    V = Bm @ JqH
    r = x8 - dtypes.to_storage(
        torch.view_as_real(V.reshape(-1, 4)).reshape(-1, 8), st)
    rca = dtypes.acc(r * cost_wt)
    cost = (rca * rca).sum().reshape(1)
    wts = wt[sl] * (os_id[sl] == subset).to(st)[:, None]
    return sl, Jp, Jq, JqH, Bm, r, cost, wts


def os_subset_equations(x8, J, coh, sta1, sta2, wt, os_id, subset: int,
                        ntper: int, row_period: int, n_stations: int,
                        cost_wt):
    """Ordered-subsets normal equations of the reduced storage policy
    from the subset's rows alone (``normal_eq.os_subset_equations``): one
    chunk, rows [tilesz, nbase]; the subset's rows and the acceptance
    cost of every row come from :func:`_os_subset_pass`, so its equations
    equal those of the masked full pass up to the order of the sums.
    Returns (JTJ [1, 8N, 8N], JTe [1, 8N], cost [1]), float32."""
    N = n_stations
    st = x8.dtype
    sl, Jp, Jq, JqH, Bm, r, cost, wts = _os_subset_pass(
        x8, J, coh, sta1, sta2, wt, os_id, subset, ntper, row_period,
        cost_wt)
    MA = dtypes.to_storage(_ma_factor(coh[sl] @ JqH[sl]), st)
    MB = dtypes.to_storage(_mb_factor(Bm[sl]), st)
    rws = r[sl] * wts
    zc = torch.zeros(wts.shape[0], dtype=torch.long, device=x8.device)
    MA, MB, wts, rws = dtypes.pet(MA, MB, wts, rws)
    D, O, JTe, _ = _aggregate(MA, MB, wts, rws, rws, sta1[sl], sta2[sl], zc,
                              N, 1, row_period, 1, cross=True)
    return _dense(D, O, 1, N), JTe.reshape(1, 8 * N), cost


class GNFactors(NamedTuple):
    """Per-iteration invariants of the matrix-free Gauss-Newton operator
    (``normal_eq.GNFactors``): MA/MB [B, 2, 2, 4] unweighted Wirtinger
    factors, w2 [B, 2, 2, 2] squared sqrt-weights (a, o, ri), D
    [K, N, 2, 4, 4] weight-folded station-diagonal Gram blocks (the
    preconditioner and the mu0 seed)."""

    MA: torch.Tensor
    MB: torch.Tensor
    w2: torch.Tensor
    D: torch.Tensor


def gn_factors(x8, J, coh, sta1, sta2, chunk_id, wt, n_stations: int,
               kmax: int, cost_wt=None, row_period: int = 0,
               visits: int = 1, rows=None):
    """Matrix-free analogue of :func:`normal_equations`: (GNFactors, JTe
    [K, 8N], cost [K]) from one [B] pass, without the cross blocks and
    the dense expansion (``normal_eq.gn_factors``); with ``rows`` D, JTe
    and the cost summed over the ranks (the factors stay the rank's)."""
    N = n_stations
    MA, MB, rw, rc = _row_pass(x8, J, coh, sta1, sta2, chunk_id, wt,
                               cost_wt)
    D, _, JTe, cost = _aggregate(MA, MB, wt, rw, rc, sta1, sta2, chunk_id,
                                 N, kmax, row_period, visits, cross=False)
    D, JTe, cost = row_sums((D, JTe, cost), rows, "gn_factors")
    w2 = (wt * wt).reshape(-1, 2, 2, 2)
    return GNFactors(MA=MA, MB=MB, w2=w2, D=D.view(kmax, N, 2, 4, 4)), \
        JTe.reshape(kmax, 8 * N), cost


def gn_matvec(fac: GNFactors, v, sta1, sta2, chunk_id, kmax: int,
              n_stations: int, shift=None, row_period: int = 0,
              visits: int = 1, rows=None):
    """(JTJ + shift I) @ v from the Wirtinger factors, one [B] pass
    (``normal_eq.gn_matvec``): u = J v through MA/MB, then y = J^T (w^2 u)
    back through the same factors. ``v`` [K, 8N]; ``shift`` [K], a scalar
    or None. Storage factors (bf16/f16) take v and w^2 u rounded to their
    dtype per product and contract in float32. With ``rows`` J^T w^2 J v
    is summed over the ranks before the shift: one collective a
    product."""
    N = n_stations
    B = fac.MA.shape[0]
    st = fac.MA.dtype
    pet = dtypes.pet
    vr = v.reshape(kmax, N, 2, 4)
    if _baseline_major(kmax, row_period, B, visits):
        Vn = visits
        nb = row_period
        T = B // (Vn * nb)
        s1b, s2b = sta1[:nb], sta2[:nb]
        MA_r = fac.MA.reshape(Vn, T, nb, 2, 2, 4)   # [v, t, n, o, ri, j]
        MB_r = fac.MB.reshape(Vn, T, nb, 2, 2, 4)   # [v, t, n, a, ri, j]
        vpn = dtypes.to_storage(vr[:, s1b], st)     # [v, n, a, j]
        vqn = dtypes.to_storage(vr[:, s2b], st)     # [v, n, o, j]
        MA_r, MB_r, vpn, vqn = pet(MA_r, MB_r, vpn, vqn)
        u = (torch.einsum("vtnorj,vnaj->vtnaor", MA_r, vpn)
             + torch.einsum("vtnarj,vnoj->vtnaor", MB_r, vqn))
        uw = dtypes.acc(dtypes.to_storage(
            u * fac.w2.reshape(Vn, T, nb, 2, 2, 2), st))
        ypn = torch.einsum("vtnaor,vtnorj->vnaj", uw, MA_r)
        yqn = torch.einsum("vtnaor,vtnarj->vnoj", uw, MB_r)
        y = torch.zeros((Vn, N, 2, 4), dtype=v.dtype, device=v.device)
        y.index_add_(1, s1b, ypn).index_add_(1, s2b, yqn)
    else:
        vp = dtypes.to_storage(vr[chunk_id, sta1], st)  # [B, a, j]
        vq = dtypes.to_storage(vr[chunk_id, sta2], st)  # [B, o, j]
        MA, MB, vp, vq = pet(fac.MA, fac.MB, vp, vq)
        u = (torch.einsum("borj,baj->baor", MA, vp)
             + torch.einsum("barj,boj->baor", MB, vq))
        uw = dtypes.acc(dtypes.to_storage(u * fac.w2, st))
        yp = torch.einsum("baor,borj->baj", uw, MA)
        yq = torch.einsum("baor,barj->boj", uw, MB)
        y = torch.zeros((kmax * N, 2, 4), dtype=v.dtype, device=v.device)
        y.index_add_(0, _index(chunk_id, sta1, N), yp)
        y.index_add_(0, _index(chunk_id, sta2, N), yq)
    y = row_sum(y.reshape(kmax, 8 * N), rows, "matvec")
    if shift is not None:
        y = y + torch.as_tensor(shift, dtype=y.dtype,
                                device=y.device)[..., None] * v
    return y


# ---------------------------------------------------------------------------
# constrained Jones modes (jones_mode in full, diag, phase)
# ---------------------------------------------------------------------------

#: valid ``--jones`` values
JONES_MODES = ("full", "diag", "phase")

#: positions of the diag-mode parameters in the full 8-real station vector
#: (``jones_c2r`` layout): (Re j00, Im j00, Re j11, Im j11)
_DIAG_IDX = (0, 1, 6, 7)


def jones_mdim(mode: str) -> int:
    """Per-(station, diagonal index) Gram block width of ``mode``; raises
    on a mode that is none of :data:`JONES_MODES`."""
    if mode not in JONES_MODES:
        raise ValueError(f"jones_mode={mode!r}: expected one of "
                         f"{JONES_MODES}")
    return {"full": 4, "diag": 2, "phase": 1}[mode]


def jones_npar(mode: str) -> int:
    """Real parameters per station of ``mode`` (2 md)."""
    return 2 * jones_mdim(mode)


def jones_constrain(J, mode: str):
    """J projected onto the mode's feasible set: the off-diagonal entries
    zeroed for diag and phase, J itself for full."""
    if mode == "full":
        return J
    return J * torch.eye(2, dtype=J.real.dtype, device=J.device)


def params_from_jones(J, mode: str):
    """[..., 2, 2] complex Jones -> [..., npar] reduced real parameters.
    Phase mode encodes the zero rotation (theta = 0): the caller keeps the
    constrained entry Jones as ``Jref`` for :func:`jones_from_params`."""
    if mode == "full":
        return jones_c2r(J)
    if mode == "diag":
        return jones_c2r(J)[..., list(_DIAG_IDX)]
    return torch.zeros(J.shape[:-2] + (2,), dtype=J.real.dtype,
                       device=J.device)


def mode_point(J, mode: str):
    """(parameters [..., npar], Jref) of a solve starting at J: in diag
    and phase mode Jref is J constrained to the mode (the reference point
    of :func:`jones_from_params`) and the parameters are its own; in full
    mode Jref is None."""
    Jref = None if mode == "full" else jones_constrain(J, mode)
    return params_from_jones(J if Jref is None else Jref, mode), Jref


def jones_from_params(p, mode: str, Jref=None):
    """[..., npar] reduced real parameters -> [..., 2, 2] complex Jones:
    diag the (Re, Im) of the diagonal entries, phase the retraction
    J = diag(Jref) exp(i theta), whose additive update of theta is the
    multiplicative phase update."""
    if mode == "full":
        return jones_r2c(p)
    if mode == "diag":
        d0 = torch.complex(p[..., 0], p[..., 1])
        d1 = torch.complex(p[..., 2], p[..., 3])
    else:
        rot = torch.complex(torch.cos(p), torch.sin(p))
        d0 = Jref[..., 0, 0] * rot[..., 0]
        d1 = Jref[..., 1, 1] * rot[..., 1]
    z = torch.zeros_like(d0)
    return torch.stack([torch.stack([d0, z], -1),
                        torch.stack([z, d1], -1)], -2)


def _mode_factors(A, Bm, Jp, Jq, mode: str):
    """Reduced Wirtinger factors (FA, FB), each [..., 2, 2, 2, md]:
    FA[..., c, o, ri, m] = d(V[c, o])_ri / d(p-parameter (c, m)),
    FB[..., c, a, ri, m] = d(V[a, c])_ri / d(q-parameter (c, m)), from
    A = C Jq^H (A[d, o]) and Bm = Jp C (Bm[a, d]) of a constrained J.
    Diag reads the d == c planes of the full factors; phase rotates them:
    u = i Jp_cc A[c, o] gives FA = (-Im u, Re u), w = conj(Jq_cc)
    Bm[a, c] gives FB = (Im w, -Re w)."""
    if mode == "diag":
        Ar, Ai = A.real, A.imag                           # [..., c, o]
        FA = torch.stack([torch.stack([Ar, -Ai], -1),     # ri = Re
                          torch.stack([Ai, Ar], -1)], -2)  # ri = Im
        Br = Bm.real.transpose(-1, -2)                    # [..., c, a]
        Bi = Bm.imag.transpose(-1, -2)
        FB = torch.stack([torch.stack([Br, Bi], -1),
                          torch.stack([Bi, -Br], -1)], -2)
        return FA, FB
    jpd = torch.stack([Jp[..., 0, 0], Jp[..., 1, 1]], -1)  # [..., c]
    jqd = torch.stack([Jq[..., 0, 0], Jq[..., 1, 1]], -1)
    u = jpd[..., None] * A                                 # [..., c, o]
    w = jqd.conj()[..., None] * Bm.transpose(-1, -2)       # [..., c, a]
    FA = torch.stack([-u.imag, u.real], -1)[..., None]
    FB = torch.stack([w.imag, -w.real], -1)[..., None]
    return FA, FB


def _mode_blocks(FA, FB, w2, rw2):
    """Per-row reduced Gram and gradient blocks from the mode factors:
    (pp [B, 2, md, md], qq, pq [B, 2, 2, md, md], jtep [B, 2, md], jteq),
    with ``w2`` / ``rw2`` [B, a, o, ri] the squared weights and w^2 r."""
    WFA = w2[..., None] * FA                        # [B, c, o, ri, md]
    w2q = w2.transpose(1, 2)                        # [B, o, a, ri]
    WFB = w2q[..., None] * FB                       # [B, c, a, ri, md]
    WFA, WFB, FA, FB, rw2 = dtypes.pet(WFA, WFB, FA, FB, rw2)
    pp = torch.einsum("bcorm,bcorn->bcmn", WFA, FA)
    qq = torch.einsum("bcarm,bcarn->bcmn", WFB, FB)
    # pq[(c, m), (c', n)] = sum_ri w2[c, c', ri] FA[c, c', ri, m]
    #                        FB[c', c, ri, n]
    pq = torch.einsum("bcorm,bcorn->bcomn", WFA, FB.transpose(1, 2))
    jtep = torch.einsum("bcor,bcorm->bcm", rw2, FA)
    jteq = torch.einsum("bcar,bcarm->bcm", rw2.transpose(1, 2), FB)
    return pp, qq, pq, jtep, jteq


def _mode_dense(pp, qq, pq, jtep, jteq, sta1, sta2, chunk_id, kmax: int,
                N: int):
    """The per-row reduced blocks scattered into the dense station-major
    normal equations: (JTJ [K, npar N, npar N], JTe [K, npar N])."""
    md = pp.shape[-1]
    npar = 2 * md
    dt, dev = pp.dtype, pp.device
    i1, i2 = _index(chunk_id, sta1, N), _index(chunk_id, sta2, N)
    D = torch.zeros((kmax * N, 2, md, md), dtype=dt, device=dev)
    D.index_add_(0, i1, pp).index_add_(0, i2, qq)
    O = torch.zeros((kmax * N * N, 2, 2, md, md), dtype=dt, device=dev)
    O.index_add_(0, i1 * N + sta2, pq)
    JTe = torch.zeros((kmax * N, 2, md), dtype=dt, device=dev)
    JTe.index_add_(0, i1, jtep).index_add_(0, i2, jteq)
    Off = O.view(kmax, N, N, 2, 2, md, md).permute(0, 1, 2, 3, 5, 4, 6) \
        .reshape(kmax, N, N, npar, npar)
    JTJ = Off + Off.transpose(1, 2).transpose(-1, -2)
    eye2 = torch.eye(2, dtype=dt, device=dev)
    Dfull = torch.einsum("knaij,ab->knaibj", D.view(kmax, N, 2, md, md),
                         eye2).reshape(kmax, N, npar, npar)
    idx = torch.arange(N, device=dev)
    JTJ[:, idx, idx] += Dfull
    JTJ = JTJ.permute(0, 1, 3, 2, 4).reshape(kmax, npar * N, npar * N)
    return JTJ, JTe.reshape(kmax, npar * N)


def _mode_pass(x8, J, coh, sta1, sta2, chunk_id, wt, cost_wt, mode: str):
    """The one [B] pass of the mode assemblies at the constrained J: (FA,
    FB, w2, w^2 r) in the storage dtype of x8, and the cost's weighted
    residual in its accumulator dtype."""
    st = x8.dtype
    J = jones_constrain(J, mode)
    Jp = J[chunk_id, sta1]
    Jq = J[chunk_id, sta2]
    A = coh @ Jq.conj().transpose(-1, -2)
    Bm = Jp @ coh
    V = Jp @ A
    r = x8 - dtypes.to_storage(
        torch.view_as_real(V.reshape(-1, 4)).reshape(-1, 8), st)
    rw = r * wt
    FA, FB = (dtypes.to_storage(f, st)
              for f in _mode_factors(A, Bm, Jp, Jq, mode))
    rc = rw if cost_wt is None else r * cost_wt
    B = x8.shape[0]
    return (FA, FB, (wt * wt).reshape(B, 2, 2, 2),
            (rw * wt).reshape(B, 2, 2, 2), dtypes.acc(rc))


def _mode_cost(rc, chunk_id, kmax: int):
    return torch.zeros((kmax,), dtype=rc.dtype, device=rc.device) \
        .index_add_(0, chunk_id, (rc * rc).sum(dim=1))


def normal_equations_mode(x8, J, coh, sta1, sta2, chunk_id, wt,
                          n_stations: int, kmax: int, mode: str = "full",
                          cost_wt=None, row_period: int = 0,
                          visits: int = 1, rows=None):
    """Mode-aware :func:`normal_equations` (``normal_eq.
    normal_equations_mode``): (JTJ [K, npar N, npar N], JTe, cost [K]) of
    the reduced parameters for diag and phase, J constrained at entry;
    full delegates to :func:`normal_equations` as it is. The mode path
    scatters generically (``row_period`` and ``visits`` serve full only),
    as the JAX package's does."""
    if mode == "full":
        return normal_equations(x8, J, coh, sta1, sta2, chunk_id, wt,
                                n_stations, kmax, cost_wt=cost_wt,
                                row_period=row_period, visits=visits,
                                rows=rows)
    FA, FB, w2, rw2, rc = _mode_pass(x8, J, coh, sta1, sta2, chunk_id, wt,
                                     cost_wt, mode)
    pp, qq, pq, jtep, jteq = _mode_blocks(FA, FB, w2, rw2)
    JTJ, JTe = _mode_dense(pp, qq, pq, jtep, jteq, sta1, sta2, chunk_id,
                           kmax, n_stations)
    return row_sums((JTJ, JTe, _mode_cost(rc, chunk_id, kmax)), rows,
                    "normal_eq")


def os_subset_equations_mode(x8, J, coh, sta1, sta2, wt, os_id,
                             subset: int, ntper: int, row_period: int,
                             n_stations: int, cost_wt, mode: str = "full"):
    """Mode-aware :func:`os_subset_equations` (``normal_eq.
    os_subset_equations_mode``): full delegates; diag and phase assemble
    the mode blocks from the subset's rows alone, beside the one
    whole-[B] model pass of the acceptance cost (:func:`_os_subset_pass`,
    J constrained first)."""
    if mode == "full":
        return os_subset_equations(x8, J, coh, sta1, sta2, wt, os_id,
                                   subset, ntper, row_period, n_stations,
                                   cost_wt)
    st = x8.dtype
    sl, Jp, Jq, JqH, Bm, r, cost, wts = _os_subset_pass(
        x8, jones_constrain(J, mode), coh, sta1, sta2, wt, os_id, subset,
        ntper, row_period, cost_wt)
    bs = wts.shape[0]
    FA, FB = (dtypes.to_storage(f, st) for f in _mode_factors(
        coh[sl] @ JqH[sl], Bm[sl], Jp[sl], Jq[sl], mode))
    rws = r[sl] * wts
    pp, qq, pq, jtep, jteq = _mode_blocks(
        FA, FB, (wts * wts).reshape(bs, 2, 2, 2),
        (rws * wts).reshape(bs, 2, 2, 2))
    zc = torch.zeros(bs, dtype=torch.long, device=x8.device)
    JTJ, JTe = _mode_dense(pp, qq, pq, jtep, jteq, sta1[sl], sta2[sl], zc,
                           1, n_stations)
    return JTJ, JTe, cost


class GNFactorsMode(NamedTuple):
    """Reduced-mode :class:`GNFactors` (diag, phase): FA/FB [B, 2, 2, 2,
    md] mode factors (:func:`_mode_factors`), w2 [B, 2, 2, 2] squared
    sqrt-weights (a, o, ri), D [K, N, 2, md, md] station-diagonal Gram
    blocks (the preconditioner and the mu0 seed)."""

    FA: torch.Tensor
    FB: torch.Tensor
    w2: torch.Tensor
    D: torch.Tensor


def gn_factors_mode(x8, J, coh, sta1, sta2, chunk_id, wt, n_stations: int,
                    kmax: int, mode: str = "full", cost_wt=None,
                    row_period: int = 0, visits: int = 1, rows=None):
    """Mode-aware :func:`gn_factors` (``normal_eq.gn_factors_mode``):
    (:class:`GNFactorsMode`, JTe [K, npar N], cost [K]) for diag and
    phase from one [B] pass; full delegates to :func:`gn_factors`."""
    if mode == "full":
        return gn_factors(x8, J, coh, sta1, sta2, chunk_id, wt, n_stations,
                          kmax, cost_wt=cost_wt, row_period=row_period,
                          visits=visits, rows=rows)
    N = n_stations
    FA, FB, w2, rw2, rc = _mode_pass(x8, J, coh, sta1, sta2, chunk_id, wt,
                                     cost_wt, mode)
    md = FA.shape[-1]
    WFA = w2[..., None] * FA
    WFB = w2.transpose(1, 2)[..., None] * FB
    WFA, WFB, FAa, FBa, rw2 = dtypes.pet(WFA, WFB, FA, FB, rw2)
    pp = torch.einsum("bcorm,bcorn->bcmn", WFA, FAa)
    qq = torch.einsum("bcarm,bcarn->bcmn", WFB, FBa)
    jtep = torch.einsum("bcor,bcorm->bcm", rw2, FAa)
    jteq = torch.einsum("bcar,bcarm->bcm", rw2.transpose(1, 2), FBa)
    i1, i2 = _index(chunk_id, sta1, N), _index(chunk_id, sta2, N)
    D = pp.new_zeros((kmax * N, 2, md, md))
    D.index_add_(0, i1, pp).index_add_(0, i2, qq)
    JTe = pp.new_zeros((kmax * N, 2, md))
    JTe.index_add_(0, i1, jtep).index_add_(0, i2, jteq)
    D, JTe, cost = row_sums((D, JTe, _mode_cost(rc, chunk_id, kmax)), rows,
                            "gn_factors")
    return GNFactorsMode(FA=FA, FB=FB, w2=w2,
                         D=D.view(kmax, N, 2, md, md)), \
        JTe.reshape(kmax, 2 * md * N), cost


def gn_matvec_mode(fac: GNFactorsMode, v, sta1, sta2, chunk_id, kmax: int,
                   n_stations: int, shift=None, rows=None):
    """(JTJ + shift I) @ v through the reduced factors, one [B] pass of
    md-wide products (``normal_eq.gn_matvec_mode``): the matrix-free
    operator of the PCG and tCG loops under diag and phase (summed over
    the ranks of ``rows`` before the shift)."""
    N = n_stations
    md = fac.FA.shape[-1]
    st = fac.FA.dtype
    vr = v.reshape(kmax, N, 2, md)
    vp = dtypes.to_storage(vr[chunk_id, sta1], st)   # [B, c, m]
    vq = dtypes.to_storage(vr[chunk_id, sta2], st)
    FA, FB, vp, vq = dtypes.pet(fac.FA, fac.FB, vp, vq)
    u = (torch.einsum("baorm,bam->baor", FA, vp)
         + torch.einsum("boarm,bom->baor", FB, vq))
    uw = dtypes.acc(dtypes.to_storage(u * fac.w2, st))
    yp = torch.einsum("baor,baorm->bam", uw, FA)
    yq = torch.einsum("baor,boarm->bom", uw, FB)
    y = torch.zeros((kmax * N, 2, md), dtype=v.dtype, device=v.device)
    y.index_add_(0, _index(chunk_id, sta1, N), yp)
    y.index_add_(0, _index(chunk_id, sta2, N), yq)
    y = row_sum(y.reshape(kmax, 2 * md * N), rows, "matvec")
    if shift is not None:
        y = y + torch.as_tensor(shift, dtype=y.dtype,
                                device=y.device)[..., None] * v
    return y
