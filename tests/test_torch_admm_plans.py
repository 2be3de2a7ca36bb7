"""The port's blocked, bounded-staleness and 2-D consensus runners
(``consensus/admm.py``: ``make_admm_runner_blocked``,
``make_admm_runner_stale``, ``make_admm_runner_2d``, ``pad_time``) in
float64 on the CPU, on ``test_torch_admm_runner.py``'s problem cut to 3
subbands of 6 stations, at -R 0 on the XLA assembly:

- the blocked runner at ``block_f`` 1 and 2 (a ragged last block) and the
  stale runner at S = 0 and at S = 2 without a fault plan: every output
  ``torch.equal`` to the synchronous ``make_admm_runner``'s;
- the stale runner at S = 2 with ``admm_subband_slow`` at subband 1
  twice, and at S = 1 with a ``"fatal"`` rule: ``run.schedule`` and
  ``run.dead`` equal to the JAX stale runner's, the outputs within the
  runner gates of ``test_torch_admm_runner.py`` (RTOL 1e-8 of each
  output's largest magnitude; the residual norms of the data's norm);
- ``make_admm_runner_2d`` at T = 2 time shards over 3 intervals (padded
  to 4) against the JAX runner on a 3 x 2 ('freq', 'time') mesh of the
  CPU devices: JT, ZT, rhoT, res0T, res1T, r1sT, dualsT and Y0T of the 3
  real intervals at the same gates, the padded interval's rows zero;
  ``pad_time`` equal to the JAX ``pad_time``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from sagecal_tpu import faults
from sagecal_tpu.consensus import admm as cadmm
from sagecal_tpu.consensus import poly as cpoly
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import faults as tfaults
from sagecal_tpu_torch.consensus import admm as tadmm
from sagecal_tpu_torch.rime import predict as trp

from test_torch_admm_runner import (NAMES, RTOL, _cfgs, _rel,
                                    stacked_inputs, subband_problem)

NF = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_plan():
    for mod in (faults, tfaults):
        mod.disable()
    yield
    for mod in (faults, tfaults):
        mod.disable()


def _tt(a, dt=None):
    return torch.as_tensor(np.asarray(a)).to(dt or torch.float64)


@pytest.fixture(scope="module")
def problem():
    """3 subbands x 3 intervals: (sky, tsky, dsky, freqs, tiles [F][T],
    cmask, cidx, B, data norm)."""
    sky, tsky_, dsky, freqs, tiles0 = subband_problem(nf=NF, n_stations=6)
    tiles = [[t] for t in tiles0]
    for seed in (10, 20):
        _, _, _, _, more = subband_problem(nf=NF, n_stations=6, seed=seed)
        for f in range(NF):
            tiles[f].append(more[f])
    t0 = tiles0[0]
    kmax = int(sky.nchunk.max())
    cmask = np.arange(kmax)[None, :] < sky.nchunk[:, None]
    cidx = rp.chunk_indices(t0.tilesz, t0.nbase, sky.nchunk)
    B = cpoly.setup_polynomials(freqs, float(np.mean(freqs)), 2, 2)
    arrs = stacked_inputs(tiles0, sky)
    data = float(max(np.linalg.norm(x * w) / x.size
                     for x, w in zip(arrs[0], arrs[5])))
    return sky, tsky_, dsky, freqs, tiles, cmask, cidx, B, data


def _interval(problem, t):
    """Interval t's runner inputs (numpy, identity J0F)."""
    sky, _, _, freqs, tiles = problem[:5]
    arrs = stacked_inputs([tiles[f][t] for f in range(NF)], sky)
    arrs[4] = freqs
    return arrs


def _port_common(problem):
    sky, tsky_, dsky, freqs, tiles, cmask, cidx, B, _ = problem
    t0 = tiles[0][0]
    return (trp.split_sky(tsky_, torch.float64), _tt(t0.sta1, torch.long),
            _tt(t0.sta2, torch.long), _tt(cidx, torch.long), cmask,
            t0.n_stations, t0.fdelta, B)


def _jax_common(problem):
    sky, tsky_, dsky, freqs, tiles, cmask, cidx, B, _ = problem
    t0 = tiles[0][0]
    return (dsky, t0.sta1, t0.sta2, cidx, cmask, t0.n_stations, t0.fdelta,
            B)


def _targs(arrs):
    return [_tt(a) if i != 4 else np.asarray(a) for i, a in enumerate(arrs)]


def _gate(name, got, want, data):
    got, want = np.asarray(got), np.asarray(want)
    rel = _rel(got, want)
    if name.startswith(("res0", "res1", "r1s")):
        # a residual's roundoff is the data's (test_torch_admm_runner)
        rel = rel * np.abs(want).max() / max(np.abs(want).max(), data)
    assert rel <= RTOL, (name, rel)


@pytest.fixture(scope="module")
def sync_out(problem):
    """The synchronous runner's outputs on interval 0."""
    _, tc = _cfgs(2.0, False)
    run = tadmm.make_admm_runner(*_port_common(problem), tc, nf_total=NF)
    return [o.clone() for o in run(*_targs(_interval(problem, 0)))]


@pytest.mark.parametrize("plan", ["blocked1", "blocked2", "stale0",
                                  "stale2_no_plan"])
def test_plans_equal_synchronous_runner(problem, sync_out, plan):
    """Every output bit-identical to the synchronous runner's; the
    blocked runner's timer a solve entry a block and one consensus entry
    an iteration."""
    _, tc = _cfgs(2.0, False)
    timer = []
    common = _port_common(problem)
    if plan.startswith("blocked"):
        bf = int(plan[-1])
        run = tadmm.make_admm_runner_blocked(*common, tc, block_f=bf,
                                             nf_total=NF, timer=timer)
    else:
        run = tadmm.make_admm_runner_stale(
            *common, tc, nf_total=NF, staleness=0 if plan == "stale0" else 2,
            timer=timer)
    out = run(*_targs(_interval(problem, 0)))
    for name, a, b in zip(NAMES, out, sync_out):
        assert torch.equal(a, b), name
    labels = [lb for lb, _ in timer]
    if plan.startswith("blocked"):
        blk = [f"solve[{i}]" for i in range(-(-NF // bf))]
        assert labels == sum(([*blk, c] for c in ["cons0"] + [
            f"cons[{k}]" for k in range(1, tc.n_admm)]), [])
    else:
        assert labels[:NF + 1] == [f"solve0[{f}]" for f in range(NF)] \
            + ["cons0"]
        assert run.schedule[-1] == [] or all(
            np.all(r == 1.0) for r in run.schedule[-1])
        assert run.dead == []


STALE = {"slow": (2, [{"point": "admm_subband_slow", "at": [1],
                       "times": 2}]),
         "fatal": (1, [{"point": "admm_subband_slow", "at": [1],
                        "times": 1, "kind": "fatal"}])}


@pytest.mark.parametrize("case", sorted(STALE))
def test_stale_runner_matches_reference(problem, case):
    """The schedule and the dead set equal to the JAX stale runner's
    under the same fault plan, the outputs within the runner gates."""
    S, rules = STALE[case]
    jc, tc = _cfgs(2.0, False)
    arrs = _interval(problem, 0)
    faults.enable(rules)
    jrun = cadmm.make_admm_runner_stale(*_jax_common(problem), jc, NF,
                                        staleness=S)
    want = [np.asarray(o) for o in jrun(*[jnp.asarray(a) for a in arrs])]
    tfaults.enable(rules)
    trun = tadmm.make_admm_runner_stale(*_port_common(problem), tc,
                                        nf_total=NF, staleness=S)
    got = [o.cpu().numpy() for o in trun(*_targs(arrs))]
    assert len(trun.schedule) == len(jrun.schedule) == 1
    np.testing.assert_array_equal(np.stack(trun.schedule[0]),
                                  np.stack(jrun.schedule[0]))
    assert trun.dead == jrun.dead
    sched = np.stack(trun.schedule[0])
    if case == "slow":
        assert list(sched[:, 1]) == [0.0, 0.0, 1.0] and trun.dead == []
    else:
        assert trun.dead == [(0, 1, 1)] and not sched[:, 1].any()
        assert np.all(got[2][1] == 0.0)           # a dead subband's rho
    for name, g, w in zip(NAMES, got, want):
        _gate(name, g, w, problem[-1])


def test_pad_time_matches_reference():
    a = np.arange(2 * 3 * 4, dtype=float).reshape(2, 3, 4)
    for nt, T in ((3, 2), (3, 3), (3, 4), (3, 1)):
        want, wpad = cadmm.pad_time([a], nt, T)
        got, gpad = tadmm.pad_time([a], nt, T)
        assert gpad == wpad
        np.testing.assert_array_equal(got[0], want[0])
        tgot, tpad = tadmm.pad_time([torch.as_tensor(a)], nt, T)
        assert tpad == wpad
        np.testing.assert_array_equal(tgot[0].numpy(), want[0])


def test_runner_2d_matches_reference(problem):
    """T = 2 time shards over 3 intervals: the port (the shards in turn,
    interval 2 cold-started as shard 1's first) against the JAX 2-D runner
    on a 3 x 2 CPU mesh."""
    sky = problem[0]
    jc, tc = _cfgs(2.0, False)
    per_t = [_interval(problem, t) for t in range(3)]
    ft = [np.stack([p[k] for p in per_t], axis=1) for k in (0, 1, 2, 3, 5,
                                                             6)]
    (x8, u, v, w, wt, fr), tpad = cadmm.pad_time(ft, 3, 2)
    assert tpad == 4
    freqs, J0F = per_t[0][4], per_t[0][7]
    mesh = Mesh(np.array(jax.devices()[:6]).reshape(3, 2), ("freq", "time"))
    jrun = cadmm.make_admm_runner_2d(*_jax_common(problem), jc, mesh, NF, 3,
                                     host_loop=True)
    want = [np.asarray(o) for o in jrun(x8, u, v, w, freqs, wt, fr, J0F)]
    timer = []
    trun = tadmm.make_admm_runner_2d(*_port_common(problem), tc, 2, 3,
                                     nf_total=NF, timer=timer)
    got = [o.cpu().numpy() for o in trun(
        *[_tt(a) for a in (x8, u, v, w)], freqs, _tt(wt), _tt(fr),
        _tt(J0F))]
    assert [lb for lb, _ in timer] == ["interval[0]", "interval[1]",
                                       "interval[2]"]
    for name, g, w_ in zip(("JT", "ZT", "rhoT", "res0T", "res1T", "r1sT",
                            "dualsT", "Y0T"), got, want):
        assert g.shape == w_.shape, name
        _gate(name, g[:3], w_[:3], problem[-1])
        assert not np.any(g[3])                    # the padded interval
    # interval 2 cold-starts: its first residual is interval 0's kind
    assert np.all(got[4][:3] < got[3][:3])
    assert len(trun.resets) == 3 and sky.n_clusters == 2
