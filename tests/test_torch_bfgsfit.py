"""The per-channel bandpass solver of ``-b 1``: sagecal_tpu_torch/solvers/
sage.py ``bfgsfit`` against the JAX package's ``sage.bfgsfit`` in
float64, warm-started near the solution with a row-weighted fit: the
non-robust cost (``-j 1``), the Student's-t cost at nu = ``-L`` (``-j
2``, and ``-j 5`` at nu = 3), and ``--jones diag`` and ``phase``. Gates: J
atol 1e-6, res_0/res_1 rtol 1e-8, equal LBFGS iterations."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu.solvers import sage
from sagecal_tpu_torch.solvers import sage as tsage

from test_torch_lm import _problem, _t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "j1": (1, "full", 2.0),
    "robust_j2": (2, "full", 2.0),
    "robust_j5_nu3": (5, "full", 3.0),
    "diag": (1, "diag", 2.0),
    "phase_robust": (2, "phase", 2.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bfgsfit_matches_reference(case):
    mode, jones, nu = CASES[case]
    N, M, K = 6, 2, 2
    x8, coh, s1, s2, cid, nbase = _problem(N=N, K=K, M=M, seed=41)
    cidx = np.stack([cid] * M)
    rng = np.random.default_rng(7)
    wt = np.ones((x8.shape[0], 8))
    wt[rng.random(x8.shape[0]) < 0.1] = 0.0
    J0 = (np.tile(np.eye(2, dtype=complex), (M, K, N, 1, 1))
          + 0.05 * (rng.normal(size=(M, K, N, 2, 2))
                    + 1j * rng.normal(size=(M, K, N, 2, 2))))
    cfg = dict(max_lbfgs=6, lbfgs_m=4, solver_mode=mode, jones_mode=jones)
    Jr, info = sage.bfgsfit(
        jnp.asarray(x8), jnp.asarray(coh), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(cidx), jnp.asarray(J0), N, jnp.asarray(wt),
        config=sage.SageConfig(**cfg), nu=nu)
    Jt, tinfo = tsage.bfgsfit(
        _t(x8), _t(coh), _t(s1).long(), _t(s2).long(), _t(cidx).long(),
        _t(J0), N, _t(wt), config=tsage.SageConfig(**cfg), nu=nu)
    assert tinfo["lbfgs_iters"] == int(info["lbfgs_iters"]) > 0
    for key in ("res_0", "res_1"):
        np.testing.assert_allclose(tinfo[key], float(info[key]), rtol=1e-8)
    assert tinfo["res_1"] < tinfo["res_0"]
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jr), atol=1e-6)
    if jones != "full":
        assert not Jt[..., 0, 1].any() and not Jt[..., 1, 0].any()
