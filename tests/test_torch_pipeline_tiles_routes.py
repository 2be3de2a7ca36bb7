"""``--tile-batch 2`` end to end, both CLIs, for the in-flight groups
(``-j 1 --inflight 2 --kernel pallas`` on 8 clusters), the XLA assembly
(``-j 1 --kernel xla``) and ``-j 1 --jones diag --kernel pallas``: the
observation, the runs and the gates of test_torch_pipeline_tiles.py
(per-tile res_0/res_1 rtol 1e-8 with nu equal, solutions atol 1e-6, the
written column 1e-7 of the data's largest magnitude), with its
helpers."""

import pytest
import torch

from test_torch_pipeline_tiles import (check_batches, check_residual_norms,
                                       check_solutions_and_column,
                                       make_tiles_runs)

TAGS = ("diag", "inflight", "xla")


@pytest.fixture(scope="module")
def tiles_runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield make_tiles_runs(tmp_path_factory, "torch_pipeline_tiles_routes",
                          TAGS)
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_tiles_residual_norms_match(tiles_runs, tag, key):
    check_residual_norms(tiles_runs, tag, key)


@pytest.mark.parametrize("tag", TAGS)
def test_tiles_solutions_and_column_match(tiles_runs, tag):
    check_solutions_and_column(tiles_runs, tag)


@pytest.mark.parametrize("tag", TAGS)
def test_tiles_runs_batch_after_the_solo_tile(tiles_runs, tag):
    check_batches(tiles_runs, tag)
