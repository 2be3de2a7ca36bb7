"""Port SAGE EM loop (sagecal_tpu_torch/solvers/sage.py) against the JAX
reference in float64, RTR family: sagefit_host in modes 4 (RTR), 5
(robust RTR, the CLI default) and 6 (NSD) with ``-R 0``, under both tCG
operators. Gates as in test_torch_sage_lm.py: res_0 and res_1 rtol 1e-8,
mean_nu equal, equal executed iterations, J atol 1e-6."""

import pytest
import torch

from test_torch_sage_lm import check_pair, sage_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [(4, "cg", 2), (5, "chol", 2), (5, "cg", 1), (6, "chol", 2)]


@pytest.fixture(scope="module")
def runs():
    return {case: sage_pair(*case) for case in CASES}


@pytest.mark.parametrize("mode,inner,K", CASES)
def test_sagefit_host_rtr_modes_match_reference(runs, mode, inner, K):
    ref, got = runs[(mode, inner, K)]
    check_pair(ref, got)
    assert (float(got[1]["mean_nu"]) != 2.0) == (mode != 4)
    # tCG products run in the RTR modes; the reference counts no PCG trip
    assert got[1]["cg_iters"] == 0
    assert (got[1]["tcg_iters"] > 0) == (mode != 6)
