"""The port's solvers under the reduced storage policies (``--dtype-policy
bf16|f16``) against the JAX package on the CPU: LM under Cholesky (LU at
these policies) on the fused sweep, LM with PCG, and the reduced OS fast
path (each subset's equations from its own rows), at bf16 and f16 on
tests/test_dtype_policy.py's toy problem (float32 data, 8 stations, 4
timeslots, noise 0.05). The XLA assembly, robust LM, RTR, robust RTR and
NSD are in test_torch_dtype_policy_rtr.py, on the same harness.

At a reduced policy a float32 roundoff of the model flips the rounding
of a residual element to the storage dtype now and then, and the solves
carry such flips on: the trajectories of the two packages part at the
storage dtype's precision, not float32's. So each case also runs the JAX
solver with the coherencies moved by one float32 ulp (the real parts, up)
and holds the port to max(GATE, 10 x that spread) on the final cost,
where GATE is tests/test_dtype_policy.py's assembly tolerance of the
policy (2e-2 bf16, 4e-3 f16); and to ENVELOPE (0.25 bf16, 0.10 f16, the
JAX package's own envelopes) against the port's float32 run of the same
solve. nu and the costs are float32 under both policies.

Those final-cost gates do not tell the policies apart on this toy: the
float32 port's final cost lies 2.2e-4 to 2.5e-2 (bf16) and 6.5e-5 to
1.0e-3 (f16) from the JAX package's reduced one, inside GATE (read on
a CPU). So each solver also takes its first step in both packages
(:func:`check_first_step`): the cost at J0, which the solver computes
from its own entry-rounded data and storage residual, within INIT_GATE
of the reference's, while the float32 port's lies outside INIT_GATE (by
5.0e-6 to 5.3e-4); and the cost after one iteration nearer the
reference's than half the float32 port's distance from it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import lm as jlm
from sagecal_tpu.solvers import robust as jrb
from sagecal_tpu.solvers import rtr as jrtr
from sagecal_tpu_torch.solvers import lm as tlm
from sagecal_tpu_torch.solvers import robust as trb
from sagecal_tpu_torch.solvers import rtr as trtr

N, T = 8, 4
GATE = {"bf16": 2e-2, "f16": 4e-3}
#: the cost at J0, port against the JAX package at the same policy: the
#: same rounded operands, float32 sums in another order (<= 4.7e-7 read)
INIT_GATE = 2e-6
ENVELOPE = {"bf16": 0.25, "f16": 0.10}
#: the RTR family's problem and iterations: tests/test_dtype_policy.py's
#: RTR envelope case (seed 8, 12 trust-region iterations), where the chains
#: converge; from the identity on seed 5 the float32 RTR stops in another
#: local minimum (cost 7.2) than the bf16 and f16 ones (8.9)
RTR_SEED = 8
RTR_ITMAX = 12
JST = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32}
TST = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy(seed=5, noise=0.05):
    """tests/test_dtype_policy.py's ``_toy`` (N = 8, T = 4, one chunk)
    as float32/complex64 numpy arrays, and the coherencies with their
    real parts one float32 ulp up."""
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nbase = len(p)
    sta1 = np.tile(p, T).astype(np.int32)
    sta2 = np.tile(q, T).astype(np.int32)
    B = nbase * T
    cid = np.zeros(B, np.int32)
    coh = rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2))
    Jtrue = (rng.normal(size=(1, N, 2, 2)) * 0.3
             + 1j * rng.normal(size=(1, N, 2, 2)) * 0.3 + np.eye(2))
    V = Jtrue[cid, sta1] @ coh @ np.conj(Jtrue[cid, sta2].transpose(0, 2, 1))
    V = V + noise * (rng.normal(size=V.shape) + 1j * rng.normal(size=V.shape))
    x8 = np.stack([V.reshape(B, 4).real, V.reshape(B, 4).imag],
                  -1).reshape(B, 8).astype(np.float32)
    coh = coh.astype(np.complex64)
    cohp = (np.nextafter(coh.real, np.float32(np.inf))
            + 1j * coh.imag).astype(np.complex64)
    return x8, coh, cohp, sta1, sta2, cid, nbase


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_solve(kind, policy, x8, coh, s1, s2, cid, nbase, itmax=None):
    """(final cost, nu or None) of the JAX package's solver ``kind``
    (``itmax`` iterations, else the case's own)."""
    J0 = jnp.tile(jnp.eye(2, dtype=jnp.complex64), (1, N, 1, 1))
    wt = jnp.ones(x8.shape, jnp.float32)
    x = jnp.asarray(x8)
    args = (x, jnp.asarray(coh), jnp.asarray(s1), jnp.asarray(s2),
            jnp.asarray(cid))
    nu = None
    if kind.startswith("lm") or kind == "rlm":
        cfg = jlm.LMConfig(itmax=itmax or 10, dtype_policy=policy,
                           inner="cg" if kind == "lm_cg" else "chol",
                           kernel="xla" if kind == "lm_xla" else "pallas")
        os = None
        if kind == "lm_os":
            ids, ns = jlm.os_subset_ids(T, nbase)
            os = jlm.OSConfig(os_id=jnp.asarray(ids), n_subsets=ns,
                              key=jax.random.PRNGKey(0), randomize=False)
        if kind == "rlm":
            _, nu, info = jrb.robust_lm_solve(*args, wt, J0, N, config=cfg,
                                              row_period=nbase)
        else:
            _, info = jlm.lm_solve(*args, wt, J0, N, config=cfg, os=os,
                                   row_period=nbase)
    elif kind in ("rtr", "rrtr"):
        cfg = jrtr.RTRConfig(itmax=itmax or RTR_ITMAX, dtype_policy=policy,
                             inner="cg", kernel="pallas")
        if kind == "rtr":
            _, info = jrtr.rtr_solve(*args, wt, J0, N, config=cfg,
                                     row_period=nbase)
        else:
            _, nu, info = jrtr.rtr_solve_robust(*args, wt, J0, N, config=cfg,
                                                row_period=nbase)
    else:
        # NSD takes the rows in the storage dtype its caller stored them
        st = JST[policy]
        _, nu, info = jrtr.nsd_solve_robust(
            x.astype(st), *args[1:], wt.astype(st), J0, N,
            config=jrtr.NSDConfig(itmax=itmax or 10))
    return float(np.asarray(info["final_cost"]).sum()), \
        None if nu is None else float(nu), \
        float(np.asarray(info["init_cost"]).sum())


def _port_solve(kind, policy, x8, coh, s1, s2, cid, nbase, itmax=None):
    """(final cost, nu or None, nu dtype) of the port's solver ``kind``."""
    J0 = _t(np.tile(np.eye(2, dtype=np.complex64), (1, N, 1, 1)))
    wt = torch.ones(x8.shape, dtype=torch.float32)
    x = _t(x8)
    args = (x, _t(coh), _t(s1).long(), _t(s2).long(), _t(cid).long())
    nu = None
    if kind.startswith("lm") or kind == "rlm":
        cfg = tlm.LMConfig(itmax=itmax or 10, dtype_policy=policy,
                           inner="cg" if kind == "lm_cg" else "chol",
                           kernel="xla" if kind == "lm_xla" else "pallas")
        os = None
        if kind == "lm_os":
            ids, ns = tlm.os_subset_ids(T, nbase)
            os = tlm.OSConfig(os_id=_t(ids).long(), n_subsets=ns,
                              randomize=False)
        if kind == "rlm":
            _, nu, info = trb.robust_lm_solve(*args, wt, J0, N, config=cfg,
                                              row_period=nbase)
        else:
            _, info = tlm.lm_solve(*args, wt, J0, N, config=cfg, os=os,
                                   row_period=nbase)
    elif kind in ("rtr", "rrtr"):
        cfg = trtr.RTRConfig(itmax=itmax or RTR_ITMAX, dtype_policy=policy,
                             inner="cg", kernel="pallas")
        if kind == "rtr":
            _, info = trtr.rtr_solve(*args, wt, J0, N, config=cfg,
                                     row_period=nbase)
        else:
            _, nu, info = trtr.rtr_solve_robust(*args, wt, J0, N, config=cfg,
                                                row_period=nbase)
    else:
        st = TST[policy]
        _, nu, info = trtr.nsd_solve_robust(
            x.to(st), *args[1:], wt.to(st), J0, N,
            config=trtr.NSDConfig(itmax=itmax or 10))
    assert info["final_cost"].dtype == torch.float32
    return float(info["final_cost"].sum()), \
        None if nu is None else (float(nu), nu.dtype), \
        float(info["init_cost"].sum())


def check(kind, policy):
    x8, coh, cohp, s1, s2, cid, nbase = toy(
        seed=RTR_SEED if kind in ("rtr", "rrtr", "nsd") else 5)
    cj, nuj, _ = _jax_solve(kind, policy, x8, coh, s1, s2, cid, nbase)
    cjp, _, _ = _jax_solve(kind, policy, x8, cohp, s1, s2, cid, nbase)
    ct, nut, _ = _port_solve(kind, policy, x8, coh, s1, s2, cid, nbase)
    cf, _, _ = _port_solve(kind, "f32", x8, coh, s1, s2, cid, nbase)
    spread = abs(cjp / cj - 1.0)
    gate = max(GATE[policy], 10.0 * spread)
    assert abs(ct / cj - 1.0) <= gate, (ct, cj, spread)
    assert abs(ct / cf - 1.0) < ENVELOPE[policy], (ct, cf)
    if nut is not None:
        assert nut[1] == torch.float32
        assert nuj is not None


def check_first_step(kind, policy):
    """The solver's first step at ``policy`` against the JAX package's,
    where the trajectories have not parted yet: the cost at J0 within
    INIT_GATE, and the cost after one iteration nearer the reference's
    than half the distance of the port's float32 step; the float32 port's
    cost at J0 outside INIT_GATE, so the gate tells the policies apart."""
    x8, coh, _, s1, s2, cid, nbase = toy(
        seed=RTR_SEED if kind in ("rtr", "rrtr", "nsd") else 5)
    cj, _, ij = _jax_solve(kind, policy, x8, coh, s1, s2, cid, nbase, 1)
    ct, _, it = _port_solve(kind, policy, x8, coh, s1, s2, cid, nbase, 1)
    cf, _, if_ = _port_solve(kind, "f32", x8, coh, s1, s2, cid, nbase, 1)
    assert abs(it / ij - 1.0) <= INIT_GATE, (it, ij)
    assert abs(if_ / ij - 1.0) > INIT_GATE, (if_, ij)
    assert abs(ct / cj - 1.0) <= 0.5 * abs(cf / cj - 1.0), (ct, cf, cj)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
@pytest.mark.parametrize("kind", ["lm_chol", "lm_cg", "lm_os"])
def test_lm_reduced_matches_reference(kind, policy):
    check(kind, policy)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
@pytest.mark.parametrize("kind", ["lm_chol", "lm_cg", "lm_os"])
def test_lm_reduced_first_step(kind, policy):
    check_first_step(kind, policy)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
def test_os_fast_path_takes_subset_equations(policy, monkeypatch):
    """The reduced OS body assembles from each subset's rows alone
    (``normal_eq.os_subset_equations_mode``, dense, LU) on either route,
    never the sweep; at f32 the masked full pass stays."""
    from sagecal_tpu_torch.ops import sweep as tsw
    from sagecal_tpu_torch.solvers import normal_eq as tne
    calls = {"os": 0, "sweep": 0}
    real_os, real_sweep = tne.os_subset_equations_mode, tsw.sweep_blocks

    def os_eq(*a, **k):
        calls["os"] += 1
        return real_os(*a, **k)

    def sweep(*a, **k):
        calls["sweep"] += 1
        return real_sweep(*a, **k)

    monkeypatch.setattr(tne, "os_subset_equations_mode", os_eq)
    monkeypatch.setattr(tsw, "sweep_blocks", sweep)
    x8, coh, _, s1, s2, cid, nbase = toy()
    ids, ns = tlm.os_subset_ids(T, nbase)
    for pol, want in ((policy, "os"), ("f32", "sweep")):
        calls.update(os=0, sweep=0)
        tlm.lm_solve(_t(x8), _t(coh), _t(s1).long(), _t(s2).long(),
                     _t(cid).long(), torch.ones(x8.shape),
                     _t(np.tile(np.eye(2, dtype=np.complex64), (1, N, 1, 1))),
                     N, config=tlm.LMConfig(itmax=3, dtype_policy=pol),
                     os=tlm.OSConfig(os_id=_t(ids).long(), n_subsets=ns,
                                     randomize=False), row_period=nbase)
        assert calls[want] > 0 and calls["os" if want == "sweep"
                                         else "sweep"] == 0, (pol, calls)
