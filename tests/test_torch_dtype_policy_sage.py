"""The port's SAGE EM loop under the reduced storage policies against the
JAX package on the CPU: ``sagefit_host`` at bf16 and f16 in -j 1 (LM),
-j 3 (OS-LM then OS robust LM: single-chunk clusters, so the reduced OS
fast path) and -j 5 --inner cg (robust RTR), and ``sagefit_host_tiles``
(2 solve intervals as one lane-batched solve) at -j 1; two clusters over
6 stations and 4 timeslots (test_torch_sage_lm.py's problem, float32
data), 2 EM iterations, ``-R 0``.

The data and weights are rounded to the storage dtype at entry, the
running residual stays in it, and the EM state is float32. As in
test_torch_dtype_policy_solvers.py the two packages' trajectories part
at the storage dtype's precision, so each case also runs the JAX package
with the coherencies moved by one float32 ulp and holds the port's res_1
to max(GATE, 10 x that spread) of the reference's (GATE 2e-2 bf16, 4e-3
f16); res_0 (the entry residual, before any solve) to 1e-6; and res_1 to
ENVELOPE (0.25 bf16, 0.10 f16) of the port's own float32 run."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import lm as jlm
from sagecal_tpu.solvers import sage
from sagecal_tpu_torch.solvers import sage as tsage

from test_torch_dtype_policy_solvers import ENVELOPE, GATE
from test_torch_lm import _problem

N, T = 6, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(K, tiles=None):
    """(x8, coh, cohp, s1, s2, cidx, cmask, J0, wt, nbase) as float32 /
    complex64 numpy arrays: 2 clusters, the first with K chunks; with
    ``tiles`` a leading tile axis on x8, coh, J0 and wt (tile t its own
    noise seed). ``cohp``: the coherencies' real parts one float32 ulp
    up."""
    def one(seed):
        x8, coh, s1, s2, cid, nb = _problem(N=N, T=T, K=K, M=2, seed=seed,
                                            noise=0.1)
        return x8.astype(np.float32), coh.astype(np.complex64), s1, s2, \
            cid, nb
    if tiles is None:
        x8, coh, s1, s2, cid, nb = one(7)
    else:
        parts = [one(7 + t) for t in range(tiles)]
        x8 = np.stack([p[0] for p in parts])
        coh = np.stack([p[1] for p in parts])
        _, _, s1, s2, cid, nb = parts[0]
    cohp = (np.nextafter(coh.real, np.float32(np.inf))
            + 1j * coh.imag).astype(np.complex64)
    cidx = np.stack([cid, np.zeros_like(cid)])
    cmask = np.array([[True] * K, [True] + [False] * (K - 1)])
    lead = () if tiles is None else (tiles,)
    J0 = np.tile(np.eye(2, dtype=np.complex64), lead + (2, K, N, 1, 1))
    wt = np.ones(lead + (x8.shape[-2], 8), np.float32)
    return x8, coh, cohp, s1, s2, cidx, cmask, J0, wt, nb


def _t(a):
    return torch.as_tensor(np.array(a))


def _common(mode, inner, nb, policy):
    return dict(max_emiter=2, max_iter=6, max_lbfgs=3, lbfgs_m=3,
                solver_mode=mode, randomize=False, nbase=nb, inner=inner,
                kernel="pallas", dtype_policy=policy)


def _jax(policy, mode, inner, d, coh, tiles=False):
    x8, _, _, s1, s2, cidx, cmask, J0, wt, nb = d
    cfg = sage.SageConfig(fuse="off", promote="off",
                          **_common(mode, inner, nb, policy))
    os_id = jlm.os_subset_ids(T, nb)
    args = [jnp.asarray(a) for a in (x8, coh, s1, s2, cidx, cmask, J0)]
    if tiles:
        keys = sage.tile_keys(x8.shape[0])
        _, info = sage.sagefit_host_tiles(*args, N, jnp.asarray(wt),
                                          config=cfg, os_id=os_id, keys=keys)
    else:
        _, info = sage.sagefit_host(*args, N, jnp.asarray(wt), config=cfg,
                                    os_id=os_id)
    return np.atleast_1d(np.asarray(info["res_0"], np.float64)), \
        np.atleast_1d(np.asarray(info["res_1"], np.float64))


def _port(policy, mode, inner, d, tiles=False):
    x8, coh, _, s1, s2, cidx, cmask, J0, wt, nb = d
    cfg = tsage.SageConfig(**_common(mode, inner, nb, policy))
    os_id = jlm.os_subset_ids(T, nb)
    args = [_t(a) for a in (x8, coh, s1, s2, cidx, cmask, J0)]
    fit = tsage.sagefit_host_tiles if tiles else tsage.sagefit_host
    J, info = fit(*args, N, _t(wt), config=cfg, os_id=os_id)
    assert J.dtype == torch.complex64
    assert torch.as_tensor(info["mean_nu"]).dtype == torch.float32
    return np.atleast_1d(np.asarray(torch.as_tensor(info["res_0"]),
                                    np.float64)), \
        np.atleast_1d(np.asarray(info["res_1"], np.float64))


def check(policy, mode, inner, K, tiles=None):
    d = _inputs(K, tiles)
    r0j, r1j = _jax(policy, mode, inner, d, d[1], tiles is not None)
    _, r1p = _jax(policy, mode, inner, d, d[2], tiles is not None)
    r0t, r1t = _port(policy, mode, inner, d, tiles is not None)
    _, r1f = _port("f32", mode, inner, d, tiles is not None)
    spread = float(np.max(np.abs(r1p / r1j - 1.0)))
    gate = max(GATE[policy], 10.0 * spread)
    np.testing.assert_allclose(r0t, r0j, rtol=1e-6)
    assert np.all(np.abs(r1t / r1j - 1.0) <= gate), (r1t, r1j, spread)
    assert np.all(np.abs(r1t / r1f - 1.0) < ENVELOPE[policy]), (r1t, r1f)
    assert np.all(r1t < r0t)


CASES = [(1, "chol", 2), (3, "chol", 1), (5, "cg", 2)]


@pytest.mark.parametrize("policy", ["bf16", "f16"])
@pytest.mark.parametrize("mode,inner,K", CASES)
def test_sagefit_host_reduced_matches_reference(policy, mode, inner, K):
    check(policy, mode, inner, K)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
def test_sagefit_host_tiles_reduced_matches_reference(policy):
    check(policy, 1, "chol", 2, tiles=2)
