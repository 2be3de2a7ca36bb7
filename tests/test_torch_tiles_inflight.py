"""``sagefit_host_tiles`` against the JAX package's with in-flight
cluster groups (``inflight = 2`` on 8 clusters: LM, and robust RTR under
PCG), at ``-R 0``; the problem, the reference's route and the gates of
test_torch_tiles.py."""

import pytest
import torch

from test_torch_tiles import (_Runs, check_groups_of_two, check_pair,
                              check_tcg_and_nu)

TAGS = ("lm_inflight", "rrtr_cg_inflight")


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


def test_inflight_cases_reach_their_routes(runs):
    """Groups of 2 in every tile; robust RTR: tCG products per tile, nu
    off its start."""
    for tag in TAGS:
        check_groups_of_two(runs, tag)
    check_tcg_and_nu(runs, "rrtr_cg_inflight")
