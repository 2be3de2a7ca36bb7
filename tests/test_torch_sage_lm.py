"""Port SAGE EM loop (sagecal_tpu_torch/solvers/sage.py) against the JAX
reference in float64, LM family: sagefit_host in the OS modes 0, 2 and 3
with ``-R 0`` (rotating subsets, identity cluster order), two clusters
over 6 stations and 4 timeslots, the first with K chunks. Gates: res_0
and res_1 rtol 1e-8, mean_nu equal, equal executed LM iterations and PCG
trips, J atol 1e-6. The RTR/NSD modes are in test_torch_sage_rtr.py.

The OS modes under the Cholesky inner solver are held to these gates on
single-chunk clusters. With two chunks the first subset holds no row of
chunk 1, the reference seeds that chunk's damping from an all-zero block
(mu0 = 1e-33), and float64 roundoff grows ~1e9-fold: the reference itself,
run on the data moved by one ulp, lands ~2e-6 away in J. Those cases are
held to the reference's own spread, measured in the same test
(``test_os_chol_two_chunks_within_reference_spread``); the PCG route does
not amplify it and runs K = 2 at the plain gates."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import lm as lm_mod
from sagecal_tpu.solvers import sage
from sagecal_tpu_torch.solvers import sage as tsage

from test_torch_lm import _problem, _t

N, T = 6, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sage_pair(mode, inner, K, seed=7, randomize=False, port_seed=42,
              ulp_draws=0):
    """(JAX, port) sagefit_host results: 2 clusters, the first with K
    chunks, 2 EM iterations (so the last-iteration switch of the OS
    modes runs), 4 LM/RTR iterations, 3 LBFGS iterations. With
    ``ulp_draws`` > 0 the JAX results also hold that many reference runs
    on the data with every value moved by one ulp (a seeded random sign),
    as a third element: the reference's own roundoff spread."""
    x8, coh, s1, s2, cid, nbase = _problem(N=N, T=T, K=K, M=2, seed=seed,
                                           noise=0.1)
    x8[::11] += 1.5                                     # outlier rows
    cidx = np.stack([cid, np.zeros_like(cid)])
    cmask = np.array([[True] * K, [True] + [False] * (K - 1)])
    wt = np.ones((x8.shape[0], 8))
    J0 = np.tile(np.eye(2, dtype=complex), (2, K, N, 1, 1))
    os_id = lm_mod.os_subset_ids(T, nbase)
    common = dict(max_emiter=2, max_iter=4, max_lbfgs=3, lbfgs_m=3,
                  solver_mode=mode, randomize=randomize, nbase=nbase,
                  inner=inner)

    def jax_run(x):
        cfg = sage.SageConfig(kernel="pallas", fuse="off", promote="off",
                              **common)
        return sage.sagefit_host(
            *(jnp.asarray(a) for a in (x, coh, s1, s2, cidx, cmask, J0)),
            N, jnp.asarray(wt), config=cfg, os_id=os_id)

    ref = None
    if not randomize:
        ref = jax_run(x8)
    if ulp_draws:
        rng = np.random.default_rng(0)
        ref = ref + ([jax_run(x8 * (1.0 + 2.0 ** -52
                                    * rng.choice([-1.0, 1.0], x8.shape)))
                      for _ in range(ulp_draws)],)
    got = tsage.sagefit_host(
        _t(x8), _t(coh), _t(s1), _t(s2), _t(cidx), _t(cmask), _t(J0), N,
        _t(wt), config=tsage.SageConfig(**common), os_id=os_id,
        seed=port_seed)
    return ref, got


def check_pair(ref, got):
    (J, info), (tJ, tinfo) = ref, got
    for key in ("res_0", "res_1"):
        np.testing.assert_allclose(float(tinfo[key]), float(info[key]),
                                   rtol=1e-8)
    assert float(tinfo["mean_nu"]) == float(info["mean_nu"])
    assert tinfo["solver_iters"] == int(info["solver_iters"])
    assert tinfo["cg_iters"] == int(info["cg_iters"])
    assert tinfo["lbfgs_iters"] == int(info["lbfgs_iters"])
    np.testing.assert_allclose(tJ.numpy(), np.asarray(J), atol=1e-6)
    assert tinfo["res_1"] < float(tinfo["res_0"])


CASES = [(0, "chol", 1), (2, "cg", 2), (3, "chol", 1)]


@pytest.fixture(scope="module")
def runs():
    return {case: sage_pair(*case) for case in CASES}


@pytest.mark.parametrize("mode,inner,K", CASES)
def test_sagefit_host_os_modes_match_reference(runs, mode, inner, K):
    ref, got = runs[(mode, inner, K)]
    check_pair(ref, got)
    robust = mode in (2, 3)
    assert (float(got[1]["mean_nu"]) != 2.0) == robust
    assert (got[1]["cg_iters"] > 0) == (inner == "cg")


@pytest.mark.parametrize("mode", [0, 3])
def test_os_chol_two_chunks_within_reference_spread(mode):
    """OS-LM under Cholesky on a 2-chunk cluster whose first subset misses
    chunk 1. The witness: the reference against itself, on the data moved
    by one ulp (3 seeded draws), moves J by more than the plain 1e-6 gate
    (measured 3.3e-6 in mode 3, 3.6e-6 in mode 0). The port must take the
    same trips and nu and land within max(plain gate, 10 x that spread):
    res_1 rtol max(1e-8, 10 s_res), J atol max(1e-6, 10 s_J) (measured
    3.3e-8 / 3.0e-6 in mode 3 against the spread's 3.6e-8 / 3.3e-6)."""
    (J, info, pert), (tJ, tinfo) = sage_pair(mode, "chol", 2, ulp_draws=3)
    s_res = max(abs(float(i["res_1"]) / float(info["res_1"]) - 1.0)
                for _, i in pert)
    s_J = max(float(np.abs(np.asarray(Jq) - np.asarray(J)).max())
              for Jq, _ in pert)
    assert 1e-6 < s_J < 1e-4 and s_res < 1e-6
    assert all(float(i["mean_nu"]) == float(info["mean_nu"])
               and int(i["solver_iters"]) == int(info["solver_iters"])
               for _, i in pert)
    assert float(tinfo["mean_nu"]) == float(info["mean_nu"])
    assert tinfo["solver_iters"] == int(info["solver_iters"])
    assert tinfo["lbfgs_iters"] == int(info["lbfgs_iters"])
    np.testing.assert_allclose(float(tinfo["res_0"]), float(info["res_0"]),
                               rtol=1e-10)
    np.testing.assert_allclose(float(tinfo["res_1"]), float(info["res_1"]),
                               rtol=max(1e-8, 10 * s_res))
    np.testing.assert_allclose(tJ.numpy(), np.asarray(J),
                               atol=max(1e-6, 10 * s_J))
    assert tinfo["res_1"] < float(tinfo["res_0"])


def test_randomized_subsets_are_seeded():
    """-R 1: the subset draws and cluster order come from the seed: the
    same seed repeats the solve exactly, another seed changes it."""
    _, a = sage_pair(3, "chol", 1, randomize=True, port_seed=5)
    _, b = sage_pair(3, "chol", 1, randomize=True, port_seed=5)
    _, c = sage_pair(3, "chol", 1, randomize=True, port_seed=6)
    assert torch.equal(a[0], b[0]) and a[1]["res_1"] == b[1]["res_1"]
    assert not torch.equal(a[0], c[0])
    assert a[1]["res_1"] < float(a[1]["res_0"])
