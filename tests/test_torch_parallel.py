"""One subband's rows over ranks (``sagecal_tpu_torch/parallel.py``) on
the CPU in float64, ranks of a gloo group (``tests/torch_shard_steps.py``
on ``torch_group_steps.run_group``), at one torch thread, inputs made by
numpy from a seed: a 6-station tile of 5 timeslots, 8 clusters, the
first in 2 hybrid chunks, 8% of the rows flagged.

- The row plan: whole-timeslot blocks, the last padded with zero-weight
  timeslots on the baseline pattern, and the per-row tables (chunk ids,
  timeslots, ordered-subset ids) sliced from the whole tile's.
- Every row reduction of the solvers at 2 and 3 ranks (uneven splits:
  3 + 2 and 2 + 2 + 1 timeslots) against one rank, within 1e-12 of each
  output's largest magnitude: the fused-sweep route's record and station
  aggregates with its blocks matvec, the XLA route's dense and
  matrix-free assemblies and products (full, diag, phase), the cost,
  the RTR preconditioner, the nu means, the RTR cost and its autograd
  gradient, and the refine's cost and gradient; every rank's values the
  same bits.
- ``sage.sagefit_host`` at 2 ranks in every solver mode, on both routes
  and with in-flight groups, against one rank (solutions within 1e-10,
  res_0/res_1 within 1e-10, nu and the trips equal), rank 1's solutions
  rank 0's bit for bit.
- The collectives: on the sweep route one a sweep and none a PCG or
  tCG product; on the XLA route one a product."""

import numpy as np
import pytest
import torch

from sagecal_tpu_torch import parallel
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.rime import predict as trp
from sagecal_tpu_torch.solvers import lm as tlm

import torch_shard_steps as steps
from torch_group_steps import run_group


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prob():
    return steps.problem(3)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("tilesz,world", [(5, 2), (5, 3), (6, 3), (2, 3)])
def test_row_plan_blocks_and_slices(tilesz, world):
    """Blocks of ceil(tilesz / P) timeslots (a rank of padding alone when
    P exceeds the timeslots' need), every real row once, the padding
    flagged on the baseline pattern, and the sliced tables the whole
    tile's at the real rows."""
    nbase = 3
    plan = parallel.RowPlan(tilesz, nbase, world)
    tper = -(-tilesz // world)
    assert plan.tper == tper and plan.n_rows == tilesz * nbase
    blocks = plan.blocks()
    assert blocks[0][0] == 0 and blocks[-1][1] == tilesz
    assert all(b[0] == a[1] for a, b in zip(blocks, blocks[1:]))
    os_id, _ = tlm.os_subset_ids(tilesz, nbase)
    tslot = tds.row_tslot(tilesz * nbase, nbase)
    cidx = trp.chunk_indices(tilesz, nbase, np.array([2, 3]))
    rows = np.arange(tilesz * nbase)
    seen = []
    for r, (t0, t1) in enumerate(blocks):
        real = (t1 - t0) * nbase
        for table in (os_id, tslot, rows):
            got = plan.take(table, r)
            assert got.shape == (plan.rows_per_rank,)
            assert np.array_equal(got[:real], table[t0 * nbase:t1 * nbase])
            assert not got[real:].any()
        got = plan.take_cols(cidx, r)
        assert got.shape == (2, plan.rows_per_rank)
        assert np.array_equal(got[:, :real], cidx[:, t0 * nbase:t1 * nbase])
        seen += list(plan.take(rows, r)[:real])
        assert np.array_equal(plan.take(np.zeros(tilesz * nbase), r, 1)
                              [real:], np.ones(plan.rows_per_rank - real))
    assert seen == list(rows)


def test_local_tile_pads_whole_flagged_timeslots():
    """``RowPlan.local_tile``: the rank's rows, padding rows flagged with
    zero data and uvw on the baseline pattern, the time table whole."""
    p, q = np.triu_indices(4, k=1)
    nb, tilesz = len(p), 5
    B = nb * tilesz
    rng = np.random.default_rng(0)
    tile = tds.VisTile(
        u=rng.standard_normal(B), v=rng.standard_normal(B),
        w=rng.standard_normal(B),
        x=rng.standard_normal((B, 2, 2, 2)) + 0j,
        flags=np.zeros(B, np.int8), sta1=np.tile(p, tilesz),
        sta2=np.tile(q, tilesz), freqs=np.array([1.0, 2.0]), freq0=1.5,
        fdelta=1.0, tdelta=1.0, dec0=0.0, ra0=0.0, n_stations=4, nbase=nb,
        tilesz=tilesz, time_mjd=np.arange(tilesz) * 1.0)
    plan = parallel.RowPlan(tilesz, nb, 2)
    loc = plan.local_tile(tile, 1)
    assert loc.nrows == 3 * nb
    assert np.array_equal(loc.x[:2 * nb], tile.x[3 * nb:])
    assert not loc.x[2 * nb:].any() and not loc.u[2 * nb:].any()
    assert (loc.flags[2 * nb:] == 1).all() and not loc.flags[:2 * nb].any()
    assert np.array_equal(loc.sta1, np.tile(p, 3))
    assert np.array_equal(loc.time_mjd, tile.time_mjd)


def test_row_sum_is_identity_without_a_group():
    t = torch.arange(4.0)
    parallel.reset_counters()
    assert parallel.row_sum(t, None) is t
    assert parallel.row_sums((t, t), None)[1] is t
    assert parallel.counters() == {"collectives": 0, "bytes": 0,
                                   "seconds": 0.0, "sites": {}}


def test_row_sums_of_live_entries_only():
    """``row_sums(..., live=)``: the live entries summed, the others 0,
    the same result as the whole sum when those are 0 on every rank, and
    only the live entries sent."""
    for full, live in run_group(steps.live_row_sums, 2, (2,), timeout=120):
        for a, b in zip(full[:2], live[:2]):
            assert np.array_equal(a, b)
        assert live[2] == full[2] // 2


@pytest.fixture(scope="module")
def sites_ref(prob):
    return steps.reduction_sites(None, prob, 1)


@pytest.mark.parametrize("world", [2, 3])
def test_reduction_sites_match_one_rank(prob, sites_ref, world):
    got = run_group(steps.reduction_sites, world, (prob, world),
                    timeout=300)
    for site, ref in sites_ref.items():
        for i, r in enumerate(ref):
            assert _rel(got[0][site][i], r) < 1e-12, (site, i)
            for g in got[1:]:
                assert np.array_equal(g[site][i], got[0][site][i]), \
                    (site, i)


def test_every_solver_mode_uneven_split_matches_one_rank(prob):
    ref = steps.solve_modes(None, prob, 1)
    got = run_group(steps.solve_modes, 2, (prob, 2), timeout=600)
    for case, r, g0, g1 in zip(steps.SOLVE_CASES, ref, got[0], got[1]):
        assert np.array_equal(g0[0], g1[0]), case
        assert g0[1:] == g1[1:], case
        assert _rel(g0[0], r[0]) < 1e-10, case
        for i in (1, 2):
            assert g0[i] == pytest.approx(r[i], rel=1e-10), case
        assert g0[3] == r[3] and g0[4] == r[4], case
        assert g0[2] < g0[1], case


def test_collectives_one_a_sweep_one_a_xla_product(prob):
    out = run_group(steps.count_collectives, 2, (prob, 2), timeout=300)
    for rank in out:
        for solver in ("lm", "rtr"):
            sw, xla = rank["pallas", solver], rank["xla", solver]
            assert sw["products"] > 0 and xla["products"] > 0
            # the sweep route: one collective a sweep, none a product
            assert sw["sites"]["sweep"] == sw["sweeps"] > 0
            assert "matvec" not in sw["sites"]
            # the XLA route: one a matrix-free product
            assert xla["sweeps"] == 0
            assert xla["sites"]["matvec"] == xla["products"]
        # LM on the sweep route: nothing but the sweeps
        assert rank["pallas", "lm"]["collectives"] \
            == rank["pallas", "lm"]["sweeps"]
