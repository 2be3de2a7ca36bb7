"""The port's solvers under the reduced storage policies against the JAX
package on the CPU, with test_torch_dtype_policy_solvers.py's harness and
gates (the port within max(GATE, 10 x the JAX package's spread under a
one-float32-ulp move of the coherencies) of the reference's final cost,
and within ENVELOPE of its own float32 run): LM on the XLA assembly
(``--kernel xla``: the reduced assembly and LU), robust LM, RTR and
robust RTR with the matrix-free tCG, and NSD (the RTR family on the JAX
package's own RTR envelope problem, RTR_SEED, at RTR_ITMAX iterations), at
bf16 and f16; and the first step of each (``check_first_step``: the cost
at J0 within INIT_GATE of the reference's, the float32 port's outside
it, and the cost after one iteration nearer the reference's than the
float32 port's)."""

import pytest
import torch

from test_torch_dtype_policy_solvers import check, check_first_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
@pytest.mark.parametrize("kind", ["lm_xla", "rlm", "rtr", "rrtr", "nsd"])
def test_solver_reduced_matches_reference(kind, policy):
    check(kind, policy)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
@pytest.mark.parametrize("kind", ["lm_xla", "rlm", "rtr", "rrtr", "nsd"])
def test_solver_reduced_first_step(kind, policy):
    check_first_step(kind, policy)
