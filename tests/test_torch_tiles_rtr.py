"""``sagefit_host_tiles`` against the JAX package's, the RTR family: RTR,
robust RTR (on 3 tiles, and under PCG) and NSD, at ``-R 0``; the
problem, the reference's route and the gates of test_torch_tiles.py."""

import pytest
import torch

from test_torch_tiles import _Runs, check_pair, check_tcg_and_nu

TAGS = ("rtr", "rrtr_t3", "rrtr_cg", "nsd")


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


def test_rtr_cases_reach_their_routes(runs):
    """Robust RTR under PCG: tCG products per tile, nu off its start."""
    check_tcg_and_nu(runs, "rrtr_cg")
