"""Batched Levenberg-Marquardt on per-(cluster, time-chunk) Jones blocks
(port of ``sagecal_tpu/solvers/lm.py``).

Every hybrid time chunk of a cluster is an independent npar N-parameter
problem; all chunks solve together as one batched damped Gauss-Newton
iteration. Each damping iteration is ONE pass over the rows giving the
normal equations, gradient and acceptance cost at the trial point, by one
of two assemblies, chosen on the host from shapes (:func:`use_sweep`, as
``lm.py:396-403`` of the JAX package chooses):

- the fused sweep (``--kernel pallas`` where it fits: at most
  ``MAX_CHUNKS`` hybrid chunks and baseline-major rows): per-baseline Gram
  blocks from the sweep kernel (``ops/sweep.py``);
- the XLA assembly (``--kernel xla``, and the fallback for any other
  shape): eager ``normal_eq.normal_equations`` / ``gn_factors``, counted
  in :data:`XLA_SOLVES`.

The damped system is then solved by one of two inner solvers
(``LMConfig.inner``):

- ``"chol"``: on the sweep route the ``blocks_chol`` route
  (``lm.py:439``): assemble, factor and solve from the blocks; on the XLA
  route the dense (JTJ + shift I) Cholesky (:func:`_solve_damped`); both
  with one boosted-jitter retry. That retry is where the reference's
  QR and SVD fallbacks (``--linsolv 1/2``) went in the JAX package
  (``lm.py:14``, ``:207``), so ``--linsolv`` selects nothing there or
  here: it is carried in ``RunConfig`` and ``sage.SageConfig`` and
  every value gives the same result;
- ``"cg"``: matrix-free preconditioned CG (``_solve_damped_cg``): each
  trip is one blocks matvec (the matvec kernel on the card) or one
  ``normal_eq.gn_matvec`` [B] pass under the station-block
  preconditioner, stopped at the inexact-Newton forcing tolerance ||r||
  <= cg_tol ||JTe||; executed trips are counted.

Ordered subsets (``OSConfig``, clmfit.c:1074): each iteration's
equations come from one contiguous time subset while acceptance tests
the full-data cost; a rejected chunk keeps the same subset's equations,
and a subset with no usable rows of a chunk is never retried nor read as
convergence (the ``live`` carry).

Damping schedule (classic levmar): mu0 = tau * max(diag(JTJ)); accept
when the gain ratio rho > 0 with mu *= max(1/3, 1 - (2 rho - 1)^3);
reject -> mu *= nu, nu *= 2.

The loops are Python loops that read one [K]-bool back per iteration
(per PCG trip under ``inner="cg"``) to decide whether any chunk is still
live (the JAX ``while_loop`` conditions); everything else stays on the
device.

Constrained Jones modes (``LMConfig.jones_mode`` diag or phase,
``lm.py:369-391`` of the JAX package): the solve state p lives in the
reduced space (``normal_eq.params_from_jones`` of the constrained entry
Jones ``Jref``), J = ``normal_eq.jones_from_params(p, mode, Jref)``, and
each assembly takes the mode: the sweep with ``jones=mode`` (the md = 2
and 1 kernels on the card), the XLA route through
``normal_eq.normal_equations_mode`` / ``gn_factors_mode``.

Reduced storage (``LMConfig.dtype_policy`` bf16 or f16, ``lm.py:364-439``
of the JAX package): x8 and wt are rounded to the storage dtype at entry
and the solve state (p, mu, nu, costs, the assembled equations) is
float32. The damped solves take LU instead of Cholesky (:func:`_solve_damped`,
``ops.sweep.solve_damped_blocks``), and the ordered-subsets body of a
single-chunk cluster on baseline-major rows under ``inner="chol"`` takes
its equations from the subset's rows alone (``normal_eq.
os_subset_equations_mode``, dense on either route: the fast path).

Consensus ADMM (``admm=(y, bz, rho)``, ``lm.py:321-656`` of the JAX
package): the objective becomes 1/2 ||w r||^2 + y^T (p - bz) + rho/2
||p - bz||^2 per chunk; every route takes JTe -= y + rho (p - bz) and
the augmented cost, the dense route's matrix gains rho I, and the blocks
and PCG routes carry rho in their solve shift (and in diag_max for mu0).
Only the full Jones mode runs it; the small-cost stop is off (the
augmented cost is signed), and an ordered-subsets chunk keeps its dead
subset, as there.

Lanes (``lanes=``, an ``ops.sweep.Lanes``): one call solves an in-flight
group's V cluster visits, folded into rows [V B] and chunks [V K], where
the JAX package vmaps the solve. Per visit: its iteration cap, its OS
subset draws, and its executed iterations and PCG trips (a visit counts
the loop iterations in which one of its chunks was live). A chunk that
stops is frozen, so every visit's result is its own solve's.

One subband's rows over ranks (``LMConfig.rows``, a ``parallel.RowGroup``;
``--shard-baselines``): each rank passes its own rows, every assembly and
every XLA-route PCG product sums over the ranks (``ops/sweep.py:
gn_blocks``, ``normal_eq``), and so does the ordered-subsets liveness of a
chunk; every decision then reads summed values. The reduced policy's
ordered-subsets fast path slices the whole tile's rows by position, so a
sharded solve takes the masked full pass instead (the JAX sharded path
never takes that path either: it runs at ``nbase=0``). Consensus ADMM is
not run over row ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import dtypes
from sagecal_tpu_torch.ops import sweep as swp
from sagecal_tpu_torch.parallel import row_sum
from sagecal_tpu_torch.solvers import normal_eq as ne


#: executed-iteration counters a solver info dict may carry
TRIP_KEYS = ("solver_iters", "cg_iters", "lbfgs_iters", "rejected_groups")


def executed_trips(info) -> dict:
    """Host-side executed-trip totals: the sum of each
    :data:`TRIP_KEYS` entry present in a solver ``info`` dict."""
    if not isinstance(info, dict):
        return {}
    return {k: int(torch.as_tensor(info[k]).sum()) for k in TRIP_KEYS
            if k in info}


class LMConfig(NamedTuple):
    itmax: int = 10
    tau: float = 1e-3          # CLM_INIT_MU
    eps1: float = 1e-15        # ||JTe||_inf stop
    eps2: float = 1e-15        # ||dp||/||p|| stop
    eps3: float = 1e-15        # ||e||^2 stop
    jitter: float = 1e-9       # Cholesky regularization floor
    inner: str = "chol"        # "chol" (block Cholesky) or "cg" (PCG)
    cg_tol: float = 0.1        # forcing eta: stop at ||r|| <= eta ||JTe||
    cg_maxiter: int = 25       # PCG trip cap per damping iteration
    kernel: str = "pallas"     # "pallas" (fused sweep where it fits), "xla"
    jones_mode: str = "full"
    dtype_policy: str = "f32"  # storage dtype of the rows (dtypes.py)
    rows: object = None        # parallel.RowGroup of a sharded solve


#: solves (``lm_solve`` and ``rtr.rtr_solve`` calls) that took the XLA
#: assembly since the last reset; the pipeline reports it per tile
XLA_SOLVES = 0


def reset_xla_solves() -> None:
    global XLA_SOLVES
    XLA_SOLVES = 0


def fold_in(seed: int, data: int) -> int:
    """A new seed from (seed, data): the place of ``jax.random.fold_in``
    in the port's seeded draws."""
    return (int(seed) * 1000003 + int(data) + 7) % (2 ** 61 - 1)


class OSConfig(NamedTuple):
    """Ordered-subsets acceleration (``lm.OSConfig``): ``os_id`` [B]
    subset id per row (:func:`os_subset_ids`), ``n_subsets`` their
    count. With ``randomize`` each iteration draws its subset from a CPU
    ``torch.Generator`` seeded by (``seed``, iteration), the same draws
    on the card and the CPU (they differ from the JAX key stream); without
    it the subsets rotate k % n_subsets exactly as in the JAX package."""

    os_id: torch.Tensor
    n_subsets: int
    seed: int = 0
    randomize: bool = True

    def subset(self, k: int) -> int:
        if not self.randomize:
            return int(k) % int(self.n_subsets)
        g = torch.Generator().manual_seed(fold_in(self.seed, k))
        return int(torch.randint(int(self.n_subsets), (1,), generator=g))


def os_subset_ids(tilesz: int, nbase: int, n_subsets: int = 10):
    """[tilesz * nbase] contiguous-time subset ids and the subset count:
    min(10, tilesz) blocks of ceil(tilesz / Nsubsets) timeslots, the
    tail block short (clmfit.c:1311-1358). Rows are [tilesz, nbase]."""
    ns = min(n_subsets, tilesz)
    ntper = -(-tilesz // ns)
    tslot = np.arange(tilesz * nbase) // nbase
    os_id = (tslot // ntper).astype(np.int32)
    return os_id, int(os_id.max()) + 1


def use_sweep(kernel: str, kmax: int, row_period: int, B: int) -> bool:
    """The assembly route, chosen on the host from shapes before any
    launch (``lm.py:396-403`` of the JAX package): True for the fused
    sweep (``kernel == "pallas"`` and ``swp.supported``), False for the
    XLA assembly. ``kmax`` and ``B`` are one visit's chunk and row
    counts, so a group takes the route its members would alone."""
    return kernel == "pallas" and swp.supported(kmax, row_period, B)


def route_name(kernel: str, kmax: int, row_period: int, B: int) -> str:
    """A line for the ``-V`` log: the route :func:`use_sweep` picks and
    why."""
    if use_sweep(kernel, kmax, row_period, B):
        return "fused sweep (--kernel pallas)"
    if kernel == "xla":
        return "XLA assembly (--kernel xla)"
    return (f"XLA assembly (the fused sweep does not fit: kmax={kmax} > "
            f"{swp.MAX_CHUNKS} or rows not baseline-major)")


def solve_route(config, kmax: int, row_period: int, B: int) -> bool:
    """The route of one solve (:func:`use_sweep`) after raising for a
    configuration that is none of the solvers' (``config`` an LMConfig or
    an RTRConfig: inner, kernel, jones_mode); a solve on the XLA assembly
    counts in :data:`XLA_SOLVES`."""
    global XLA_SOLVES
    if config.inner not in ("chol", "cg"):
        raise ValueError(f"inner={config.inner!r}: expected chol or cg")
    if config.kernel not in ("pallas", "xla"):
        raise ValueError(f"kernel={config.kernel!r}: expected pallas or xla")
    ne.jones_mdim(config.jones_mode)
    sweep = use_sweep(config.kernel, kmax, row_period, B)
    XLA_SOLVES += not sweep
    return sweep


def live_lanes(mask, V: int) -> np.ndarray:
    """[V] host bools: visit v has a True among its chunks of the [V K]
    ``mask`` (one device read; V = 1 is a plain any())."""
    return np.asarray(mask.view(V, -1).any(dim=1).cpu())


def _lane_caps(itmax: int, itmax_dynamic, lanes):
    """(loop bound, stop threshold): the iteration cap of a solve, per
    chunk [V K] on a group (``itmax_dynamic`` one cap per visit)."""
    if lanes is None:
        cap = itmax if itmax_dynamic is None else \
            min(int(itmax_dynamic), itmax)
        return cap, cap
    caps = np.full(lanes.V, itmax) if itmax_dynamic is None else \
        np.minimum(np.asarray(itmax_dynamic, dtype=np.int64), itmax)
    return int(caps.max()), torch.as_tensor(
        np.repeat(caps, lanes.K), device=lanes.cid.device)


def _solve_damped(JTJ, JTe, mu, jitter, reduced: bool = False):
    """Solve (JTJ + (mu + jitter) I) dp = JTe on a dense matrix
    (``lm._solve_damped``): a batched Cholesky, or LU under a reduced
    storage policy (``swp.shifted_solve``), with ``swp.retry_damped``'s
    one retry, its boost read from diag(JTJ)."""
    eye = torch.eye(JTJ.shape[-1], dtype=JTJ.dtype, device=JTJ.device)
    diag_max = torch.diagonal(JTJ, dim1=-2, dim2=-1).abs().amax(dim=-1)
    return swp.retry_damped(
        lambda shift: swp.shifted_solve(JTJ + shift[:, None, None] * eye,
                                        JTe, reduced),
        mu + jitter, diag_max)


def _solve_damped_cg(fac, JTe, mu, jitter, rho, sta1, sta2,
                     n_stations: int, eta: float, maxiter: int,
                     active=None, lists=None, V: int = 1, chunk_id=None,
                     row_period: int = 0, rows=None):
    """Matrix-free PCG for (JTJ + (mu + jitter + rho) I) dp = JTe,
    batched over chunks; returns (dp, ok, trips).

    ``fac`` is the sweep route's Gram blocks (``swp.GNBlocks``: each trip
    is one blocks matvec, ``swp.matvec_apply`` on one plan of the blocks
    and the shift) or the XLA route's ``ne.GNFactors`` (each trip one
    ``ne.gn_matvec`` [B] pass over the Wirtinger factors, with
    ``chunk_id`` and ``row_period``) or ``ne.GNFactorsMode`` (one
    ``ne.gn_matvec_mode`` pass); either way one station-block
    preconditioner solve follows. A chunk stops at ||r||^2 <=
    (eta ||JTe||)^2 and freezes (masked updates) while the batch runs to
    the slowest live chunk; ``active`` [K] masks chunks out entirely
    (their rhs is zeroed, so they start converged); ``lists`` the tile's
    ``swp.station_lists`` for the kernel. ``trips`` [V] counts the
    executed loop iterations of each of the V visits whose chunks the K
    axis holds (one host read of the active mask each). ``rows`` sums
    each XLA-route product over the ranks; the blocks of the sweep route
    arrive summed, so their products run replicated."""
    shift = mu + jitter + rho
    L = ne.gn_precond_factor(fac.D, shift)
    kmax = JTe.shape[0]
    b = JTe if active is None else torch.where(active[:, None], JTe,
                                               torch.zeros_like(JTe))
    tol2 = (eta * eta) * (b * b).sum(dim=-1)
    tiny = 1e-30
    zero = torch.zeros_like(mu)
    x = torch.zeros_like(b)
    r = b
    p = ne.gn_precond_apply(L, b, kmax, n_stations)
    rz = (b * p).sum(dim=-1)
    act = (r * r).sum(dim=-1) > tol2
    k = 0
    trips = np.zeros(V, dtype=np.int64)
    if isinstance(fac, ne.GNFactors):
        def matvec(v):
            return ne.gn_matvec(fac, v, sta1, sta2, chunk_id, kmax,
                                n_stations, shift=shift,
                                row_period=row_period, visits=V, rows=rows)
    elif isinstance(fac, ne.GNFactorsMode):
        def matvec(v):
            return ne.gn_matvec_mode(fac, v, sta1, sta2, chunk_id, kmax,
                                     n_stations, shift=shift, rows=rows)
    else:
        plan = swp.matvec_plan(fac, sta1, sta2, n_stations, shift=shift,
                               lists=lists)

        def matvec(v):
            return swp.matvec_apply(plan, v)
    while k < maxiter:
        lv = live_lanes(act, V)
        if not lv.any():
            break
        trips += lv
        Ap = matvec(p)
        pAp = (p * Ap).sum(dim=-1)
        alpha = torch.where(act & (pAp > 0),
                            rz / torch.clamp(pAp, min=tiny), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = ne.gn_precond_apply(L, r, kmax, n_stations)
        rz_new = (r * z).sum(dim=-1)
        beta = torch.where(act, rz_new / torch.clamp(rz, min=tiny), zero)
        p = torch.where(act[:, None], z + beta[:, None] * p, p)
        rz = torch.where(act, rz_new, rz)
        k += 1
        act = (r * r).sum(dim=-1) > tol2
    ok = torch.isfinite(x).all(dim=-1)
    return torch.where(ok[:, None], x, torch.zeros_like(x)), ok, trips


def _no_admm(rows, admm) -> None:
    """Raise for consensus ADMM over row ranks (``rows``): not run."""
    if rows is not None and admm is not None:
        raise ValueError("consensus ADMM is not run over row ranks")


def admm_terms(admm, kmax: int, dtype, dev, mode: str = "full"):
    """The ADMM augmentation of a solve of ``kmax`` chunks: (y [K, 8N],
    bz [K, 8N], rho [K]) in the solve dtype, from ``admm = (y, bz, rho)``
    with y and bz any shape of K x 8N reals and rho a scalar or one value
    a chunk (a group's visits each bring their own); None without it.
    Raises for a constrained Jones mode: y and bz are full-Jones
    parameters."""
    if admm is None:
        return None
    if mode != "full":
        raise ValueError("consensus ADMM requires jones_mode='full': the "
                         f"y/bz vectors are full-Jones parameters (got "
                         f"{mode!r})")
    y, bz, rho = admm
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)
    return (y.reshape(kmax, -1).to(dtype), bz.reshape(kmax, -1).to(dtype),
            rho.expand(kmax) if rho.dim() == 0 else rho.reshape(kmax))


def lm_solve(x8, coh, sta1, sta2, chunk_id, wt, J0, n_stations: int,
             chunk_mask=None, config: LMConfig = LMConfig(),
             itmax_dynamic=None, os: OSConfig | None = None,
             row_period: int = 0, lists=None, lanes=None, admm=None):
    """Levenberg-Marquardt solve of all chunks of one cluster.

    x8 [B, 8] data (residual + this cluster's model); coh [B, 2, 2];
    sta1/sta2/chunk_id [B]; wt [B, 8] sqrt-weights; J0 [K, N, 2, 2];
    chunk_mask [K] bool; ``itmax_dynamic`` an optional iteration cap
    <= config.itmax; ``os`` the optional ordered-subsets setting;
    ``lists`` the tile's ``swp.station_lists`` for the PCG matvec. Returns
    (J [K, N, 2, 2], info) with init_cost / final_cost [K], iters
    (executed iterations) and cg_iters (executed PCG trips). Under
    ``config.jones_mode`` diag or phase J is constrained to the mode
    (zero off-diagonals), a masked chunk returning the constrained J0.

    With ``lanes`` the arrays are a group's folded layout (module
    docstring; ``wt`` [B, 8] when shared), ``itmax_dynamic`` and ``os``
    hold one entry per visit, and iters / cg_iters are [V] arrays.
    ``admm`` the optional consensus augmentation (y, bz, rho) of
    :func:`admm_terms` (module docstring). ``config.rows`` the row group
    of a sharded solve (module docstring)."""
    kmax = J0.shape[0]
    V = 1 if lanes is None else lanes.V
    rows = config.rows
    _no_admm(rows, admm)
    sweep = solve_route(config, kmax // V, row_period, x8.shape[0] // V)
    # the rows in the policy's storage dtype; the solve state in its
    # accumulator dtype
    st = dtypes.storage_dtype(config.dtype_policy, x8.dtype)
    x8 = dtypes.to_storage(x8, st)
    wt = dtypes.to_storage(wt, st)
    reduced = dtypes.is_reduced(x8.dtype)
    dev = x8.device
    dtype = dtypes.acc_dtype(x8.dtype)
    N = n_stations
    inner_cg = config.inner == "cg"
    Bv = x8.shape[0] // V
    # the reduced policy's OS fast path: each subset's equations from its
    # own contiguous rows, ntper timeslots a subset
    os_ntper = 0
    if (reduced and os is not None and kmax == V and row_period > 0
            and Bv % row_period == 0 and not inner_cg and rows is None):
        os_ntper = -(-(Bv // row_period) // int(
            (os if lanes is None else os[0]).n_subsets))
    # the dense (JTJ, JTe, cost) of the XLA route under "chol", and of the
    # OS fast path on either route
    dense = (not sweep and not inner_cg) or bool(os_ntper)
    # the solve state lives in the mode's reduced space; Jref holds the
    # constrained entry Jones (the phase retraction's amplitudes)
    mode = config.jones_mode
    npar = ne.jones_npar(mode)
    aug = admm_terms(admm, kmax, dtype, dev, mode)
    p, Jref = ne.mode_point(J0, mode)
    p = p.reshape(kmax, -1).to(dtype)
    if chunk_mask is None:
        chunk_mask = torch.ones((kmax,), dtype=torch.bool, device=dev)
    # a sharded sweep sums the records of chunk_mask's chunks only (the
    # others hold no row)
    live_chunks = None if rows is None or not sweep else \
        torch.nonzero(chunk_mask).flatten()
    # the blocks and PCG routes carry the ADMM rho in their solve shift
    rho_aug = 0.0 if aug is None else aug[2]

    def p_to_J(pv):
        return ne.jones_from_params(pv.reshape(kmax, N, npar), mode, Jref)

    def folded(w):
        return w if lanes is None or w is None else lanes.rows(w)

    def nrm_eq(pv, w=None, cw=None, k=None):
        return augment(pv, *plain_eq(pv, w, cw, k))

    def plain_eq(pv, w, cw, k):
        if os_ntper:
            return os_eq(pv, k, cw)
        w = wt if w is None else w
        if sweep:
            return swp.gn_blocks(x8, p_to_J(pv), coh, sta1, sta2, chunk_id,
                                 w, N, kmax, row_period, cost_wt=cw,
                                 jones=mode, lanes=lanes, rows=rows,
                                 live=live_chunks)
        assemble = ne.normal_equations_mode if dense else ne.gn_factors_mode
        return assemble(x8, p_to_J(pv), coh, sta1, sta2, chunk_id,
                        folded(w), N, kmax, mode=mode, cost_wt=folded(cw),
                        row_period=row_period, visits=V, rows=rows)

    def augment(pv, fac, JTe, cost):
        """The ADMM terms on one row pass's equations: JTe -= y + rho d,
        the augmented cost 2 y^T d + rho ||d||^2 (the un-halved data cost
        convention), and rho I on the dense matrix, d = p - bz."""
        if aug is None:
            return fac, JTe, cost
        y, bz, rho = aug
        d = pv - bz
        JTe = JTe - y - rho[:, None] * d
        if dense:
            eye = torch.eye(fac.shape[-1], dtype=fac.dtype, device=dev)
            fac = fac + rho[:, None, None] * eye
        cost = cost + 2.0 * (y * d).sum(dim=-1) \
            + rho * (d * d).sum(dim=-1)
        return fac, JTe, cost

    def os_eq(pv, k: int, cw):
        """The OS fast path's equations of iteration k's subset, visit by
        visit (each its own subset)."""
        Jv = p_to_J(pv)
        if lanes is None:
            return ne.os_subset_equations_mode(
                x8, Jv, coh, sta1, sta2, wt, os_id, os.subset(k), os_ntper,
                row_period, N, cw, mode=mode)
        xv, cv, wv, cwv = (lanes.visits(a) for a in (x8, coh, wt, cw))
        s1v, s2v = sta1.view(V, Bv), sta2.view(V, Bv)
        shared = lanes.shared(wt)
        outs = [ne.os_subset_equations_mode(
            xv[v], Jv[v:v + 1], cv[v], s1v[v], s2v[v],
            wv if shared else wv[v], os_id, os[v].subset(k), os_ntper,
            row_period, N, cwv if shared else cwv[v], mode=mode)
            for v in range(V)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))

    if os is not None:
        os_id = (os if lanes is None else os[0]).os_id.to(dev)

        def os_wt(k: int):
            """The weights of iteration k's subset (each visit's own)."""
            if lanes is None:
                return wt * (os_id == os.subset(k)).to(wt.dtype)[:, None]
            sel = torch.stack([os_id == o.subset(k) for o in os])
            return lanes.rows(wt) * sel.reshape(-1).to(wt.dtype)[:, None]

        def live_of(w):
            """[K] 1.0 where the weights ``w`` hold >= 1 usable row of
            chunk k (this rank's rows)."""
            row = (w > 0).any(dim=1).to(dtype)
            return torch.zeros((kmax,), dtype=dtype,
                               device=dev).scatter_reduce(
                0, chunk_id, row, "amax")

        if rows is not None:
            # every subset's liveness over the ranks, in one collective
            # a solve: [n_subsets, K]
            n_sub = int((os if lanes is None else os[0]).n_subsets)
            id_rows = os_id if lanes is None else os_id.repeat(V)
            wf = folded(wt)
            table = row_sum(torch.stack([
                live_of(wf * (id_rows == s).to(wt.dtype)[:, None])
                for s in range(n_sub)]), rows, "os_live") > 0
            ks = torch.arange(kmax, device=dev)

        def os_live(w, k: int):
            """[K]: iteration k's subset (each visit's own) holds >= 1
            usable row of chunk k (``w`` its weights; over every rank of
            a sharded solve)."""
            if rows is None:
                return live_of(w) > 0
            sub = [os.subset(k)] if lanes is None else \
                [o.subset(k) for o in os]
            return table[torch.as_tensor(np.repeat(sub, kmax // V),
                                         device=dev), ks]

        wt0 = os_wt(0)
        fac, JTe, cost = nrm_eq(p, wt0, wt, 0)
        live = os_live(wt0, 0)
    else:
        fac, JTe, cost = nrm_eq(p)
        live = torch.ones((kmax,), dtype=torch.bool, device=dev)
    cost0 = cost
    if dense:
        diag_max = torch.diagonal(fac, dim1=-2, dim2=-1).abs().amax(dim=-1)
    else:
        dd = torch.diagonal(fac.D, dim1=-2, dim2=-1)
        diag_max = dd.reshape(kmax, -1).abs().amax(dim=-1) + rho_aug
    mu = config.tau * torch.clamp(diag_max, min=1e-30)
    nu = torch.full((kmax,), 2.0, dtype=dtype, device=dev)
    stop = torch.zeros((kmax,), dtype=torch.bool, device=dev)
    itmax, cap = _lane_caps(config.itmax, itmax_dynamic, lanes)

    k = 0
    its = np.zeros(V, dtype=np.int64)
    cg_trips = np.zeros(V, dtype=np.int64)
    while k < itmax:
        lv = live_lanes(~stop & chunk_mask, V)
        if not lv.any():
            break
        its += lv
        if inner_cg:
            dp, ok, trips = _solve_damped_cg(
                fac, JTe, mu, config.jitter, rho_aug, sta1, sta2, N,
                config.cg_tol, config.cg_maxiter, active=~stop & chunk_mask,
                lists=lists, V=V, chunk_id=chunk_id, row_period=row_period,
                rows=rows)
            cg_trips += trips
        elif dense:
            dp, ok = _solve_damped(fac, JTe, mu, config.jitter, reduced)
        else:
            dp, ok = swp.solve_damped_blocks(fac, JTe, mu, config.jitter,
                                             sta1, sta2, N, reduced,
                                             rho=rho_aug)
        pnew = p + dp
        if os is not None:
            wt_next = os_wt(k + 1)
            facn, JTen, cost_new = nrm_eq(pnew, wt_next, wt, k + 1)
            sub_live = os_live(wt_next, k + 1)
        else:
            facn, JTen, cost_new = nrm_eq(pnew)
        dL = (dp * (mu[:, None] * dp + JTe)).sum(dim=-1)
        dF = cost - cost_new
        accept = ok & (dF > 0) & (dL > 0) & ~stop & chunk_mask
        rho = dF / torch.clamp(dL, min=1e-30)
        mu_acc = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                  min=1.0 / 3.0)
        mu = torch.where(accept, mu_acc, mu * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        small_dp = (torch.linalg.vector_norm(dp, dim=-1)
                    <= config.eps2 * (torch.linalg.vector_norm(p, dim=-1)
                                      + 1e-30))
        p = torch.where(accept[:, None], pnew, p)
        cost = torch.where(accept, cost_new, cost)
        # rejected chunks keep their entering blocks and gradient (under
        # OS: retry the same subset), except that a dead carried subset
        # is never retried: its dp is 0, so the new subset's equations
        # at pnew are the old point's (under ADMM the prior terms make
        # dp != 0, so there a chunk adopts on acceptance only)
        adopt = accept | (~live & chunk_mask) \
            if os is not None and aug is None else accept
        fac = _adopt(adopt, facn, fac, chunk_id)
        JTe = torch.where(adopt[:, None], JTen, JTe)
        if os is not None:
            live = torch.where(adopt, sub_live, live)
        small_grad = JTe.abs().amax(dim=-1) <= config.eps1
        if os is not None:
            small_grad = small_grad & live
        # the augmented cost is signed: no small-cost stop under ADMM
        small_cost = cost <= config.eps3 if aug is None \
            else torch.zeros_like(stop)
        stop = stop | small_grad | (accept & small_dp) | small_cost \
            | (k + 1 >= cap)
        k += 1
    J = p_to_J(p)
    J = torch.where(chunk_mask[:, None, None, None], J,
                    (J0 if Jref is None else Jref).to(J.dtype))
    if lanes is None:
        its, cg_trips = int(its[0]), int(cg_trips[0])
    return J, {"init_cost": cost0, "final_cost": cost, "iters": its,
               "cg_iters": cg_trips}


def _adopt(adopt, new, old, chunk_id):
    """The operator a chunk carries into the next iteration: ``new`` where
    ``adopt`` [K], else ``old``. Gram blocks and the dense matrix carry a
    leading K axis; the XLA route's per-row factors (MA, MB, w2) map
    chunks onto rows through ``chunk_id``, and its D is per chunk (so do
    the mode factors' FA, FB, w2 and D)."""
    def sel(mask, a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                           a, b)
    if torch.is_tensor(new):
        return sel(adopt, new, old)
    if isinstance(new, (ne.GNFactors, ne.GNFactorsMode)):
        ra = adopt[chunk_id]
        return type(new)(*(sel(ra, a, b) for a, b in zip(new[:3], old[:3])),
                         sel(adopt, new.D, old.D))
    return swp.GNBlocks(*(sel(adopt, a, b) for a, b in zip(new, old)))


def make_weights(flags, dtype=torch.float32):
    """[B, 8] sqrt-weights from row flags: only flag == 0 rows enter the
    solve (flag 2 = uv-cut rows are subtracted but not solved on)."""
    return (flags == 0).to(dtype)[:, None].expand(-1, 8).contiguous()
