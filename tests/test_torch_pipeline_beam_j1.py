"""The station beam at ``-j 1`` (LM, then the LBFGS refine) through both
CLIs, ``-B 1``, ``-B 2`` and ``-B 3``, on the observation of
test_torch_pipeline_beam.py (its 2-chunk cluster kept), float64 on the
CPU, at that file's gates: per-tile res_0/res_1 rtol 1e-8 with equal nu,
solutions atol 1e-6, the written column 1e-7 of the data's largest
magnitude; no port run calls the coherency kernel's entry point."""

import pytest
import torch

from test_torch_pipeline_beam import (FLAGS, both_clis, check_column,
                                      check_residual_norms, check_solutions)

RUNS = {f"b{b}_j1": (["-j", "1", "-B", str(b)], "sky.txt.cluster")
        for b in (1, 2, 3)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_beam_j1",
                    {tag: (FLAGS + f, c) for tag, (f, c) in RUNS.items()})
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(RUNS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_beam_j1_residual_norms_match(runs, tag, key):
    check_residual_norms(runs, tag, key)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_beam_j1_solutions_and_column_match(runs, tag):
    check_solutions(runs[0], runs[1], tag)
    check_column(runs[0], tag)


def test_beam_j1_generic_route(runs):
    assert runs[3] == 0
    assert all(h["res_1"] < h["res_0"] for tag in RUNS
               for h in runs[2][tag][1])
