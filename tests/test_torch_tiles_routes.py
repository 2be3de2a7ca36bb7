"""``sagefit_host_tiles`` against the JAX package's on the XLA assembly
(LM; robust RTR under PCG) and in the constrained Jones modes (LM at
diag, robust RTR under PCG at phase), at ``-R 0``; the problem, the
reference's route and the gates of test_torch_tiles.py."""

import pytest
import torch

from test_torch_tiles import _Runs, check_pair, check_tcg_and_nu

TAGS = ("lm_xla", "rrtr_cg_xla", "lm_diag", "rrtr_cg_phase")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("tag", TAGS)
def test_sagefit_host_tiles_matches_reference(runs, tag):
    check_pair(runs, tag)


def test_route_cases_reach_their_routes(runs):
    """Robust RTR on the XLA assembly: tCG products per tile, nu off its
    start; diag solutions with zero off-diagonals."""
    check_tcg_and_nu(runs, "rrtr_cg_xla")
    J = runs["lm_diag"][1][0].numpy()
    assert not J[..., 0, 1].any() and not J[..., 1, 0].any()
