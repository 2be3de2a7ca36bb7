"""Functions that ``tests/test_torch_parallel.py`` runs on the ranks of a
gloo group (``torch_group_steps.run_group``) and, with no group, in the
test process as the one-rank reference: one subband's rows over the
ranks (``sagecal_tpu_torch/parallel.py``). Kept apart from the tests,
which import jax, so that the spawned ranks import torch and the port
only. Every function takes the whole tile's problem (:func:`problem`,
numpy from a seed) and the world size, and works on its rank's rows."""

import numpy as np
import torch

from sagecal_tpu_torch import parallel
from sagecal_tpu_torch.ops import sweep as swp
from sagecal_tpu_torch.rime import predict as rp
from sagecal_tpu_torch.solvers import lm as lm_mod
from sagecal_tpu_torch.solvers import normal_eq as ne
from sagecal_tpu_torch.solvers import robust as rb
from sagecal_tpu_torch.solvers import rtr as rtr_mod
from sagecal_tpu_torch.solvers import sage


def problem(seed: int, n_stations: int = 6, tilesz: int = 5,
            nchunk=(2, 1, 1, 1, 1, 1, 1, 1)) -> dict:
    """A tile of [tilesz, nbase] rows of ``len(nchunk)`` clusters: random
    coherencies, Jones near identity, data = the corrupted model plus
    noise, a few rows flagged; numpy arrays (complex128 / float64)."""
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(n_stations, k=1)
    nbase = len(p)
    B = tilesz * nbase
    M, K = len(nchunk), int(max(nchunk))
    coh = (rng.standard_normal((M, B, 2, 2))
           + 1j * rng.standard_normal((M, B, 2, 2))) * 0.5
    eye = np.eye(2)[None, None, None]
    Jt = eye + 0.2 * (rng.standard_normal((M, K, n_stations, 2, 2))
                      + 1j * rng.standard_normal((M, K, n_stations, 2, 2)))
    cidx = rp.chunk_indices(tilesz, nbase, np.asarray(nchunk))
    sta1, sta2 = np.tile(p, tilesz), np.tile(q, tilesz)
    x8 = sum(rp.model8(torch.as_tensor(coh[m]), torch.as_tensor(Jt[m]),
                       torch.as_tensor(sta1), torch.as_tensor(sta2),
                       torch.as_tensor(cidx[m]).long()).numpy()
             for m in range(M))
    x8 = x8 + 0.05 * rng.standard_normal(x8.shape)
    flags = (rng.random(B) < 0.08).astype(np.int32)
    J0 = eye + 0.05 * (rng.standard_normal((M, K, n_stations, 2, 2))
                       + 1j * rng.standard_normal((M, K, n_stations, 2, 2)))
    return dict(coh=coh, J0=J0, x8=x8, flags=flags, cidx=cidx, sta1=sta1,
                sta2=sta2, nchunk=np.asarray(nchunk), n=n_stations,
                tilesz=tilesz, nbase=nbase,
                v=rng.standard_normal((K, 8 * n_stations)),
                shift=np.abs(rng.standard_normal(K)) + 0.1)


def _local(prob: dict, group, world: int):
    """(row group or None, this rank's tensors of ``prob``): its rows of
    the tile, padded rows flagged, the per-row tables sliced."""
    plan = parallel.RowPlan(prob["tilesz"], prob["nbase"], world)
    rank = 0 if group is None else group.rank
    rows = None if group is None else parallel.RowGroup(group, plan)
    t = torch.as_tensor
    take = lambda a, fill=0: plan.take(a, rank, fill)
    os_id, n_sub = lm_mod.os_subset_ids(prob["tilesz"], prob["nbase"])
    nb = prob["nbase"]
    loc = dict(
        x8=t(take(prob["x8"])),
        coh=t(np.moveaxis(take(np.moveaxis(prob["coh"], 1, 0)), 0, 1)
              ).contiguous(),
        flags=t(take(prob["flags"], 1)),
        cidx=t(plan.take_cols(prob["cidx"], rank)).long(),
        sta1=t(np.tile(prob["sta1"][:nb], plan.tper)).long(),
        sta2=t(np.tile(prob["sta2"][:nb], plan.tper)).long(),
        os_info=(take(os_id), n_sub))
    loc["wt"] = lm_mod.make_weights(loc["flags"], torch.float64)
    return rows, loc


def reduction_sites(group, prob: dict, world: int) -> dict:
    """Every kernel-route and XLA-route row reduction, the costs, the
    preconditioner, the nu means and the RTR and refine gradients on
    this rank's rows, summed over the ranks (numpy, by site)."""
    rows, L = _local(prob, group, world)
    N, nb = prob["n"], prob["nbase"]
    J = torch.as_tensor(prob["J0"][0])
    K = J.shape[0]
    x8, coh, wt, cid = L["x8"], L["coh"][0], L["wt"], L["cidx"][0]
    s1, s2 = L["sta1"], L["sta2"]
    v, shift = torch.as_tensor(prob["v"]), torch.as_tensor(prob["shift"])
    out = {}
    for jones in ("full", "diag"):
        Jm = ne.jones_constrain(J, jones)
        fac, JTe, cost = swp.gn_blocks(x8, Jm, coh, s1, s2, cid, wt, N, K,
                                       nb, jones=jones, rows=rows)
        out[f"sweep_{jones}"] = [*fac, JTe, cost]
        md = ne.jones_mdim(jones)
        plan = swp.matvec_plan(fac, s1, s2, N, shift=shift)
        out[f"sweep_{jones}"].append(swp.matvec_apply(
            plan, v[:, :2 * md * N].contiguous()))
    for mode in ("full", "phase"):
        out[f"normal_eq_{mode}"] = list(ne.normal_equations_mode(
            x8, J, coh, s1, s2, cid, wt, N, K, mode=mode, row_period=nb,
            rows=rows))
    fac, JTe, cost = ne.gn_factors_mode(x8, J, coh, s1, s2, cid, wt, N, K,
                                        row_period=nb, rows=rows)
    out["gn_full"] = [fac.D, JTe, cost, ne.gn_matvec(
        fac, v, s1, s2, cid, K, N, shift=shift, row_period=nb, rows=rows)]
    fac, JTe, cost = ne.gn_factors_mode(x8, J, coh, s1, s2, cid, wt, N, K,
                                        mode="diag", rows=rows)
    out["gn_diag"] = [fac.D, JTe, cost, ne.gn_matvec_mode(
        fac, v[:, :4 * N].contiguous(), s1, s2, cid, K, N, shift=shift,
        rows=rows)]
    out["cost"] = [ne.weighted_cost(x8, J, coh, s1, s2, cid, wt, K,
                                    rows=rows)]
    out["precond"] = [rtr_mod.station_precond(wt, s1, s2, cid, K, N,
                                              rows=rows)]
    e = ne.residual8(x8, J, coh, s1, s2, cid)
    w = rb.update_weights(e, 3.0)
    mask = wt > 0
    out["nu"] = [rb.update_nu_ml(w, mask, torch.tensor(2.0), rows=rows),
                 rb.mean_logsumw(w, mask, rows=rows)]
    local = rtr_mod.make_cost(x8, coh, s1, s2, cid, wt, K, N,
                              robust_nu=torch.tensor(3.0))
    p = ne.jones_c2r(J).reshape(K, -1)
    out["rtr"] = [rtr_mod._summed(local, rows)(p),
                  rtr_mod._egrad(local, rows)(p)]
    cfg = sage.SageConfig(rows=rows)
    p0, _, cost_fn, grad_fn = sage.refine_problem(
        x8, L["coh"], s1, s2, L["cidx"], torch.as_tensor(prob["J0"]), wt, N,
        cfg, mean_nu=2.5)
    out["refine"] = [cost_fn(p0), grad_fn(p0), cost_fn(1.01 * p0),
                     grad_fn(1.01 * p0)]
    return {k: [t.detach().numpy() for t in ts] for k, ts in out.items()}


#: (solver mode, kernel, inner, in-flight width) of :func:`solve_modes`:
#: every mode on the sweep route (--inner cg, which keeps the OS modes'
#: two-chunk cluster off the C4 amplification), then the XLA route's
#: dense and matrix-free assemblies, and in-flight groups on both routes
SOLVE_CASES = tuple((m, "pallas", "cg", 1) for m in range(7)) + (
    (1, "xla", "chol", 1), (3, "xla", "cg", 1), (5, "xla", "cg", 1),
    (1, "xla", "cg", 2), (5, "pallas", "cg", 2), (2, "pallas", "chol", 1))


def solve_modes(group, prob: dict, world: int, cases=SOLVE_CASES) -> list:
    """``sage.sagefit_host`` on this rank's rows in each case of
    ``cases``: (J, res_0, res_1, mean_nu, info's trips) a case."""
    rows, L = _local(prob, group, world)
    out = []
    for mode, kernel, inner, inflight in cases:
        cfg = sage.SageConfig(max_emiter=2, max_iter=4, max_lbfgs=3,
                              solver_mode=mode, randomize=False,
                              inner=inner, kernel=kernel,
                              nbase=prob["nbase"], inflight=inflight,
                              rows=rows)
        cmask = torch.as_tensor(np.arange(prob["J0"].shape[1])[None]
                                < prob["nchunk"][:, None])
        J, info = sage.sagefit_host(
            L["x8"], L["coh"], L["sta1"], L["sta2"], L["cidx"], cmask,
            torch.as_tensor(prob["J0"]), prob["n"], L["wt"], config=cfg,
            os_id=L["os_info"])
        out.append((J.numpy(), float(info["res_0"]), float(info["res_1"]),
                    float(info["mean_nu"]),
                    {k: int(info[k]) for k in ("solver_iters", "cg_iters",
                                               "tcg_iters")}))
    return out


def count_collectives(group, prob: dict, world: int) -> dict:
    """The row-sum collectives of one LM solve and one RTR solve on each
    route (``--inner cg``), beside the sweeps and the PCG/tCG products
    they made: by site, as ``parallel.SITES`` counts them."""
    rows, L = _local(prob, group, world)
    N, nb = prob["n"], prob["nbase"]
    J = torch.as_tensor(prob["J0"][0])
    calls = {"sweep": 0}
    gn_blocks = swp.gn_blocks

    def counted(*a, **kw):
        calls["sweep"] += 1
        return gn_blocks(*a, **kw)

    swp.gn_blocks = counted
    out = {}
    try:
        for kernel in ("pallas", "xla"):
            for solver in ("lm", "rtr"):
                parallel.reset_counters()
                calls["sweep"] = 0
                args = (L["x8"], L["coh"][0], L["sta1"], L["sta2"],
                        L["cidx"][0], L["wt"], J, N)
                if solver == "lm":
                    _, info = lm_mod.lm_solve(
                        *args, config=lm_mod.LMConfig(
                            itmax=5, inner="cg", kernel=kernel, rows=rows),
                        row_period=nb)
                    trips = info["cg_iters"]
                else:
                    _, info = rtr_mod.rtr_solve(
                        *args, config=rtr_mod.RTRConfig(
                            itmax=4, inner="cg", kernel=kernel, rows=rows),
                        row_period=nb)
                    trips = info["tcg_iters"]
                out[kernel, solver] = dict(
                    sites=dict(parallel.SITES), sweeps=calls["sweep"],
                    products=int(trips), collectives=parallel.COLLECTIVES,
                    bytes=parallel.BYTES)
    finally:
        swp.gn_blocks = gn_blocks
    return out


def live_row_sums(group, world: int) -> list:
    """``parallel.row_sums`` of tensors whose entries 1 and 3 on the
    leading axis are 0 on every rank, with and without ``live`` = (0, 2),
    and the bytes each sent."""
    rows = parallel.RowGroup(group, parallel.RowPlan(world, 1, world))
    a = torch.arange(12.0).view(4, 3) * (group.rank + 1)
    b = torch.arange(4.0) + group.rank
    a[1::2] = 0.0
    b[1::2] = 0.0
    out = []
    for live in (None, torch.tensor([0, 2])):
        parallel.reset_counters()
        out.append([t.numpy() for t in parallel.row_sums((a, b), rows,
                                                         live=live)]
                   + [parallel.BYTES])
    return out
