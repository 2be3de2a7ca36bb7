"""``sagefit_host_tiles`` against the JAX package's with ``randomize``
on (LM on 8 clusters and 3 tiles, robust RTR under PCG, NSD): the port
is fed the reference's per-tile permutations, and each tile's weighted
sweep sorts and caps its visits by its own cost reductions; the problem,
the reference's route and the gates of test_torch_tiles.py."""

import pytest
import torch

from test_torch_tiles import _Runs, check_pair

TAGS = ("lm_random", "rrtr_random", "nsd_random")


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


def test_random_cases_reach_their_routes(runs):
    """-R 1 on 8 clusters: each tile's weighted sweep caps its visits by
    its own cost reductions, so the tiles take different iterations."""
    its = runs["lm_random"][1][1]["solver_iters"]
    assert len(set(its.tolist())) > 1
