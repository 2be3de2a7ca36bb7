"""The station beam under the simulation modes and stochastic
calibration, both CLIs end to end on the observation of
test_torch_pipeline_beam.py, float64 on the CPU:

- ``-a 1 -B 2``: the simulated model through the full beam;
- ``-N 2 -M 2 -w 2 -B 2``: stochastic calibration, each minibatch row
  gathering the tile's beam tables at its timeslot in the tile (two
  minibatches of 2 timeslots: a minibatch-local index would read the
  first minibatch's times for the second).

Gates (those of test_torch_pipeline.py): per-tile res_0/res_1 rtol 1e-8,
solutions atol 1e-6, the written column 1e-7 of the data's largest
magnitude (the simulated one too); no port run calls the coherency
kernel's entry point."""

import pytest
import torch

from test_torch_pipeline_beam import (FLAGS, both_clis, check_column,
                                      check_residual_norms, check_solutions)

STOCHASTIC = ["-N", "2", "-M", "2", "-w", "2", "-m", "5", "-B", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_beam_stochastic",
                    {"stochastic": (FLAGS + STOCHASTIC, "sky.txt.cluster")})
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim_runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_beam_sim",
                    {"sim": (FLAGS + ["-a", "1", "-B", "2"],
                             "sky.txt.cluster")}, sim=True)
    torch.set_num_threads(n)


@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_beam_stochastic_residual_norms_match(runs, key):
    check_residual_norms(runs, "stochastic", key)


def test_beam_stochastic_solutions_and_column_match(runs):
    check_solutions(runs[0], runs[1], "stochastic")
    check_column(runs[0], "stochastic")
    assert runs[3] == 0


def test_beam_simulation_matches(sim_runs):
    assert sim_runs[3] == 0
    check_column(sim_runs[0], "sim")
