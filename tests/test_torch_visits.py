"""Port multi-visit sweep (sagecal_tpu_torch/ops/sweep.py) against the JAX
reference in float64: ``sweep_blocks_visits_plain`` against the Pallas
``sweep_blocks_visits`` (``_visits_kernel`` in interpret mode) at V = 3
visits, K = 2 chunks, N = 6 stations, T = 4 timeslots, over the
shared/per-visit operand combinations the solvers produce (rtol 1e-10 of
the largest reference entry), and the folding of a group's visits into
the chunk axis (``sweep.Lanes``): ``gn_blocks`` on the folded layout gives
V serial ``gn_blocks`` calls' D, JTe and cost."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.ops import sweep_pallas as swp
from sagecal_tpu_torch.ops import sweep as tswp
from sagecal_tpu_torch.solvers import normal_eq as tne

V, K, N, T = 3, 2, 6, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _visits(seed=0):
    """V visits' rows [T, nbase]: per-visit data, Jones, coherencies,
    chunk ids and weights, plus one shared copy of each per-row operand."""
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = nb * T
    sta1 = np.tile(p, T).astype(np.int32)
    sta2 = np.tile(q, T).astype(np.int32)
    tslot = np.arange(B) // nb
    # visit v splits its timeslots at v + 1: every visit its own chunk ids
    cid = np.stack([(tslot > v).astype(np.int32) for v in range(V)])
    x8 = rng.normal(size=(V, B, 8))
    J = (rng.normal(size=(V, K, N, 2, 2))
         + 1j * rng.normal(size=(V, K, N, 2, 2))) * 0.4 + np.eye(2)
    coh = rng.normal(size=(V, B, 2, 2)) + 1j * rng.normal(size=(V, B, 2, 2))
    wt = rng.random((V, B, 8)) * (rng.random((V, B, 1)) > 0.1)
    cw = rng.random((V, B, 8))
    return dict(x8=x8, J=J, coh=coh, cid=cid, wt=wt, cw=cw, sta1=sta1,
                sta2=sta2, nb=nb)


#: (chunk id, wt, cost_wt) per visit (True) or shared (False), as the
#: solvers produce them: plain LM / RTR (shared weights), robust IRLS
#: (per-visit weights), OS-LM on a group of equal chunk layouts (shared
#: chunk ids and cost weights), and all shared
COMBOS = {"wt_shared": (True, False, False),
          "wt_batched": (True, True, True),
          "cid_shared": (False, True, False),
          "all_shared": (False, False, False)}


def _operands(d, cidb, wb, cwb):
    return (d["cid"] if cidb else d["cid"][0], d["wt"] if wb else d["wt"][0],
            d["cw"] if cwb else d["cw"][0])


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_visits_plain_matches_pallas(combo):
    cidb, wb, cwb = COMBOS[combo]
    d = _visits(seed=len(combo))
    cid, wt, cw = _operands(d, cidb, wb, cwb)
    j = jnp.asarray
    ref = swp.sweep_blocks_visits(
        j(d["x8"]), j(d["J"]), j(d["coh"]), j(d["sta1"]), j(d["sta2"]),
        j(cid), j(wt), j(cw), d["nb"], K, V,
        (True, True, True, cidb, wb, cwb), interpret=True)
    t = lambda a: torch.as_tensor(np.asarray(a))
    s1b = t(d["sta1"][:d["nb"]]).long()
    s2b = t(d["sta2"][:d["nb"]]).long()
    Jt = t(d["J"])
    got = tswp.sweep_blocks_visits_plain(
        t(d["x8"]), Jt[:, :, s1b], Jt[:, :, s2b], t(d["coh"]), t(cid), t(wt),
        t(cw), d["nb"], V)
    wrapped = tswp.sweep_blocks_visits(
        t(d["x8"]), Jt, t(d["coh"]), t(d["sta1"]), t(d["sta2"]), t(cid),
        t(wt), t(cw), d["nb"], K, V)
    names = ("pp", "qq", "pq", "jtep", "jteq", "cost")
    for name, r, g, w in zip(names, ref, got, wrapped):
        r = np.asarray(r)
        assert g.shape == r.shape == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-10 * np.abs(r).max(),
                                   err_msg=name)
        assert torch.equal(w, g), name


def test_lane_folding_matches_serial_gn_blocks():
    """One ``gn_blocks`` call on a group's folded layout (rows [V B],
    chunks [V K], shared weights) against V serial calls: D, JTe and
    cost equal."""
    d = _visits(seed=7)
    t = lambda a: torch.as_tensor(np.asarray(a))
    nb, B = d["nb"], d["x8"].shape[1]
    wt = t(d["wt"][0])
    folded_cid = t(d["cid"] + K * np.arange(V)[:, None]).reshape(V * B)
    lanes = tswp.Lanes(V, K, t(d["cid"]).long())
    fac, JTe, cost = tswp.gn_blocks(
        t(d["x8"]).reshape(V * B, 8), t(d["J"]).reshape(V * K, N, 2, 2),
        t(d["coh"]).reshape(V * B, 2, 2), t(np.tile(d["sta1"], V)),
        t(np.tile(d["sta2"], V)), folded_cid, wt, N, V * K, nb, lanes=lanes)
    for v in range(V):
        sf, sJTe, scost = tswp.gn_blocks(
            t(d["x8"][v]), t(d["J"][v]), t(d["coh"][v]), t(d["sta1"]),
            t(d["sta2"]), t(d["cid"][v]), wt, N, K, nb)
        sl = slice(v * K, (v + 1) * K)
        for name, a, b in (("D", fac.D[sl], sf.D), ("pq", fac.pq[sl], sf.pq),
                           ("JTe", JTe[sl], sJTe), ("cost", cost[sl], scost)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14,
                                       atol=1e-14 * float(b.abs().max()),
                                       err_msg=f"visit {v} {name}")


def test_lanes_layout_helpers():
    cid = torch.zeros((2, 5), dtype=torch.int32)
    lanes = tswp.Lanes(2, 3, cid)
    shared = torch.arange(10.0).reshape(5, 2)
    folded = torch.arange(20.0).reshape(10, 2)
    assert lanes.B == 5 and lanes.shared(shared) and not lanes.shared(folded)
    assert torch.equal(lanes.rows(shared), torch.cat([shared, shared]))
    assert lanes.visits(folded).shape == (2, 5, 2)
    assert lanes.visits(shared) is shared
    nu = torch.tensor([2.0, 5.0])
    assert lanes.per_row(nu)[:, 0].tolist() == [2.0] * 5 + [5.0] * 5


def test_visit_strides_address_each_visit():
    """The visit strides the sweep kernel takes: for an operand with a
    [V] axis, the stride (in its float or int64 elements) times the
    element size is the distance in bytes from visit v's data to visit
    v + 1's (complex values two floats); a shared operand's stride is 0,
    as its one array serves every visit."""
    d = _visits()
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt)
    x8, J = t(d["x8"], torch.float32), t(d["J"], torch.complex64)
    coh = t(d["coh"], torch.complex64)
    cid = t(d["cid"], torch.int64)
    wt, cw = t(d["wt"], torch.float32), t(d["cw"], torch.float32)
    per_visit = (x8, wt, cw, cid, coh, J)
    strides = tswp.visit_strides(*per_visit)
    for a, st in zip(per_visit, strides):
        size = 8 if a.dtype == torch.int64 else 4
        assert st * size == a[1].data_ptr() - a[0].data_ptr() > 0
    shared = (x8, wt[0], cw[0], cid[0], coh, J[0])
    got = tswp.visit_strides(*shared)
    assert got[1:4] == (0, 0, 0) and got[5] == 0
    assert got[0] == strides[0] and got[4] == strides[4]


def test_visits_refuses_bad_shapes_and_modes():
    """A visit axis of another length, or a Jones mode the JAX package
    does not have, raises; diag and phase run (md = 2 and 1)."""
    d = _visits()
    t = lambda a: torch.as_tensor(np.asarray(a))
    args = (t(d["x8"]), t(d["J"]), t(d["coh"]), t(d["sta1"]), t(d["sta2"]),
            t(d["cid"]), t(d["wt"]), t(d["cw"]), d["nb"], K)
    with pytest.raises(ValueError):
        tswp.sweep_blocks_visits(*args, V + 1)
    with pytest.raises(ValueError, match="jones"):
        tswp.sweep_blocks_visits(*args, V, jones="polar")
    for jones, md in (("diag", 2), ("phase", 1)):
        pp = tswp.sweep_blocks_visits(*args, V, jones=jones)[0]
        assert pp.shape == (V, K, d["nb"], 2, md, md)


@pytest.mark.parametrize("jones", ["diag", "phase"])
@pytest.mark.parametrize("combo", ["wt_batched", "all_shared"])
def test_visits_modes_match_pallas(jones, combo):
    """The multi-visit sweep at md = 2 and 1 against the reference's
    sweep_blocks_visits(jones=) in interpret mode, V = 3 visits of K = 2
    chunks, on Jones whose off-diagonals are not zero (both constrain
    them on entry)."""
    cidb, wb, cwb = COMBOS[combo]
    d = _visits(seed=20 + len(jones) + len(combo))
    cid, wt, cw = _operands(d, cidb, wb, cwb)
    j = jnp.asarray
    ref = swp.sweep_blocks_visits(
        j(d["x8"]), j(d["J"]), j(d["coh"]), j(d["sta1"]), j(d["sta2"]),
        j(cid), j(wt), j(cw), d["nb"], K, V,
        (True, True, True, cidb, wb, cwb), interpret=True, jones=jones)
    t = lambda a: torch.as_tensor(np.asarray(a))
    got = tswp.sweep_blocks_visits(
        t(d["x8"]), t(d["J"]), t(d["coh"]), t(d["sta1"]), t(d["sta2"]),
        t(cid), t(wt), t(cw), d["nb"], K, V, jones=jones)
    md = tne.jones_mdim(jones)
    names = ("pp", "qq", "pq", "jtep", "jteq", "cost")
    for name, r, g in zip(names, ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-10 * np.abs(r).max(),
                                   err_msg=name)
    assert got[0].shape[-1] == md
