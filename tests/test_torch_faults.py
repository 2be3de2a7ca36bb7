"""The port's fault plans (``sagecal_tpu_torch/faults.py``) and metrics
registry (``sagecal_tpu_torch/obs/metrics.py``) against the JAX
package's modules, which they copy: for the same plan and seed the same
draws (``fires``, ``draw``, ``inject``, and the crc draw ``_draw`` of
probabilistic rules) and the same ``Plan`` state after them (every rule's
``fired``, the occurrence counts); the same spec forms and refusals; the
same transience classification and retry counts; and for the same calls
the same registry dump. The MPI CLI's ``--faults`` takes only
``admm_subband_slow`` rules (``cli_mpi.install_faults``)."""

import json

import pytest
import torch

from sagecal_tpu import faults
from sagecal_tpu.obs import metrics
from sagecal_tpu_torch import cli_mpi as tcli_mpi
from sagecal_tpu_torch import faults as tfaults
from sagecal_tpu_torch.obs import metrics as tmetrics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    """No plan and no registry before or after a test, in both
    packages."""
    for mod in (faults, tfaults):
        mod.disable()
    for mod in (metrics, tmetrics):
        mod.disable()
    yield
    for mod in (faults, tfaults):
        mod.disable()
    for mod in (metrics, tmetrics):
        mod.disable()


PLANS = {
    "slow_times": ([{"point": "admm_subband_slow", "at": [1], "times": 2},
                    {"point": "admm_subband_slow", "at": [2], "times": 1,
                     "kind": "fatal"}], 0),
    "probabilistic": ([{"point": "admm_subband_slow", "p": 0.35,
                        "times": None},
                       {"point": "ms_read", "p": 0.5, "times": 3}], 7),
    "unbounded_at": ([{"point": "ms_write", "at": [0, 3], "times": None,
                       "kind": "fatal"},
                      {"point": "solve_nan", "times": 2}], 3),
}
#: the queries: (function name, point, key), in order
QUERIES = ([("draw", "admm_subband_slow", f) for _ in range(4)
            for f in range(4)]
           + [("fires", "ms_read", k) for k in ("a", "b", 2) * 3]
           + [("inject", "ms_write", k) for k in range(5)]
           + [("fires", "solve_nan", None) for _ in range(3)])


def _replay(mod, rules, seed):
    plan = mod.enable(rules, seed=seed)
    out = []
    for fn, point, key in QUERIES:
        if fn == "inject":
            try:
                mod.inject(point, key=key)
                out.append(None)
            except mod.FaultError as e:
                out.append(type(e).__name__)
        else:
            out.append(getattr(mod, fn)(point, key=key))
    state = ([r.fired for r in plan.rules], sorted(plan._occ.items(),
                                                   key=repr))
    mod.disable()
    return out, state


@pytest.mark.parametrize("name", sorted(PLANS))
def test_draw_sequences_match_reference(name):
    rules, seed = PLANS[name]
    got = _replay(tfaults, rules, seed)
    want = _replay(faults, rules, seed)
    assert got == want
    assert any(x is not None and x is not False for x in got[0])


def test_crc_draw_matches_reference():
    for seed in (0, 1, 12345):
        for point in ("admm_subband_slow", "ms_read"):
            for key in (0, 7, "job:3", None):
                for occ in (1, 2, 9):
                    assert tfaults._draw(seed, point, key, occ) \
                        == faults._draw(seed, point, key, occ)


def test_spec_forms_and_refusals_match_reference(tmp_path):
    rules = [{"point": "admm_subband_slow", "at": [1], "times": 2}]
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 5, "rules": rules}))
    for spec in (json.dumps(rules), json.dumps({"seed": 5, "rules": rules}),
                 str(path), "@" + str(path)):
        a, b = tfaults.enable_spec(spec), faults.enable_spec(spec)
        assert a.seed == b.seed
        assert [(r.point, r.kind, r.at, r.times, r.p) for r in a.rules] \
            == [(r.point, r.kind, r.at, r.times, r.p) for r in b.rules]
    assert tfaults.POINTS == faults.POINTS
    for bad in ({"point": "no_such_point"},
                {"point": "ms_read", "kind": "sometimes"}):
        for mod in (tfaults, faults):
            with pytest.raises(ValueError):
                mod.Rule(**bad)
    tfaults.disable()
    assert not tfaults.active() and tfaults.draw("admm_subband_slow") is None


def test_transience_and_retry_match_reference():
    excs = [TimeoutError(), ConnectionError(), InterruptedError(),
            OSError("eio"), FileNotFoundError(), PermissionError(),
            ValueError()]
    for e in excs:
        assert tfaults.is_transient(e) == faults.is_transient(e)
    assert tfaults.is_transient(tfaults.TransientFault("x"))
    assert not tfaults.is_transient(tfaults.FatalFault("x"))
    dumps = []
    for mod, reg in ((tfaults, tmetrics), (faults, metrics)):
        reg.enable()
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise TimeoutError("flaky")
            return "ok"
        assert mod.retry_transient(flaky, what="io", attempts=3,
                                   base_s=0.0) == "ok"
        with pytest.raises(TimeoutError):
            mod.retry_transient(lambda: (_ for _ in ()).throw(
                TimeoutError()), what="io", attempts=2, base_s=0.0)
        dumps.append(reg.get().dump())
        reg.disable()
    assert dumps[0] == dumps[1]
    assert dumps[0]["retries_total"]["series"]["what=io"] == 3.0


def _metric_calls(reg):
    r = reg.enable()
    r.histogram("lat", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.7, 5.0, 50.0):
        reg.observe("lat", v, job="a")
    reg.observe("auto_hist", 0.003)
    reg.inc("admm_iterations_total")
    reg.inc("admm_iterations_total", 2)
    reg.set_gauge("admm_dual_residual", 0.25)
    with reg.scope_labels(job="j1"):
        reg.inc("tiles_solved_total")
        with reg.scope_labels(phase="w"):
            reg.set_gauge("g", 3.0, extra="x")
    c = r.counter("many")
    c.max_series = 2
    for k in range(4):
        reg.inc("many", key=str(k))
    stats = r.get("lat").stats(job="a")
    return r.dump(), stats


def test_registry_dump_matches_reference():
    got, gstats = _metric_calls(tmetrics)
    want, wstats = _metric_calls(metrics)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert gstats == wstats
    assert "key=_overflow" in got["many"]["series"]


def test_registry_is_a_noop_when_disabled():
    tmetrics.inc("x")
    tmetrics.set_gauge("y", 1.0)
    tmetrics.observe("z", 1.0)
    assert tmetrics.get() is None and not tmetrics.active()


def test_mpi_cli_takes_only_slow_subband_rules():
    """``install_faults``: a plan of admm_subband_slow rules is
    installed; a rule at any other point raises NotImplementedError
    naming ROADMAP queue A item 10 and leaves no plan behind."""
    plan = tcli_mpi.install_faults(json.dumps(
        [{"point": "admm_subband_slow", "at": [1], "times": 2}]))
    assert tfaults.get() is plan and len(plan.rules) == 1
    tfaults.disable()
    for point in ("ms_read", "solutions_write", "residual_fetch"):
        with pytest.raises(NotImplementedError, match="queue A item 10"):
            tcli_mpi.install_faults(json.dumps(
                {"rules": [{"point": "admm_subband_slow"},
                           {"point": point}]}))
        assert tfaults.get() is None
    assert tcli_mpi.install_faults(None) is None
