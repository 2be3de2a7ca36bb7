"""The station beam under ``--tile-batch`` and ``-b 1``, both CLIs end to
end on the observation of test_torch_pipeline_beam.py, float64 on the
CPU:

- ``-j 5 --inner cg --tile-batch 2 -B 2``: tile 0 alone, tiles 1-2 one
  lane-batched solve, each tile with its own beam tables;
- ``-j 1 -b 1 -B 1``: the channel solves and residuals through the
  array factor at each channel's frequency.

``-a`` and ``-N`` under the beam are in test_torch_pipeline_beam_sim.py.
Gates (those of test_torch_pipeline.py): per-tile res_0/res_1 rtol 1e-8
with equal nu, solutions atol 1e-6, the written column 1e-7 of the
data's largest magnitude; no port run calls the coherency kernel's entry
point."""

import pytest
import torch

from test_torch_pipeline_beam import (FLAGS, both_clis, check_column,
                                      check_residual_norms, check_solutions)

RUNS = {
    "tile_batch": ["-j", "5", "--inner", "cg", "--tile-batch", "2", "-B",
                   "2"],
    "bandpass": ["-j", "1", "-b", "1", "-B", "1"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_beam_options",
                    {tag: (FLAGS + f, "sky.txt.cluster")
                     for tag, f in RUNS.items()})
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(RUNS))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_beam_option_residual_norms_match(runs, tag, key):
    check_residual_norms(runs, tag, key)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_beam_option_solutions_and_column_match(runs, tag):
    check_solutions(runs[0], runs[1], tag)
    check_column(runs[0], tag)


def test_beam_options_generic_route(runs):
    """No kernel-path call; the batch solved tiles 1-2 together; every
    channel fit of -b 1 lowered its cost."""
    _, _, out, kernel_calls = runs
    assert kernel_calls == 0
    tb = out["tile_batch"][1]
    assert tb[0]["batch"] is None and tb[1]["batch"]["tiles"] == [1, 2]
    assert all(c["res_1"] < c["res_0"] for h in out["bandpass"][1]
               for c in h["channels"])
