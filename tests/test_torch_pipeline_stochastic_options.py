"""The ``-q`` warm start and the full-batch options under ``-N``: both
CLIs on the observation of test_torch_pipeline_options.py (3 tiles of 8
stations, 5 timeslots and 4 channels; 3 clusters), float64 on the CPU,
at the stochastic tests' ``-t 5 -l 6 -m 5``:

- ``-N 1 -M 2 -q`` from the full-batch base run's file (a single-band
  file: every band starts from it);
- ``-N 1 -M 2 -w 2 -q`` from a two-band stochastic file (band for band)
  and ``-N 1 -M 2 -q`` from the same file (one band: it starts from the
  file's first band);
- ``-N 1 -M 2 -W 1 -b 1 -J 1 -k 1 -a 1 -z``: ``-W``, ``-b``, ``-J``,
  ``-a`` and ``-z`` are no-ops under ``-N`` in both packages (the JAX
  CLI routes ``-N`` before it looks at ``-a``), so each CLI writes what
  it writes at ``-N 1 -M 2 -k 1``.

Gates (those of test_torch_pipeline_stochastic.py): per-tile
res_0/res_1 rtol 1e-8, solutions atol 1e-6, the written column 1e-7 of
the data's largest magnitude."""

import numpy as np
import pytest
import torch

from sagecal_tpu_torch.io import dataset as tds

from test_torch_pipeline_options import (N_TILES, both_clis,
                                         check_residual_norms,
                                         check_solutions_and_column)
from test_torch_pipeline_stochastic import COMMON

#: tag -> flags after COMMON ("@base" the full-batch base run's JAX
#: solutions, "@w2" the n_w2 run's JAX two-band file, "@ignore" the -z
#: file)
STOCH = {
    "n_plain": ["-N", "1", "-M", "2"],
    "n_w2": ["-N", "1", "-M", "2", "-w", "2"],
    "n_warm": ["-N", "1", "-M", "2", "-q", "@base"],
    "n_warm_bands": ["-N", "1", "-M", "2", "-w", "2", "-q", "@w2"],
    "n_warm_first_band": ["-N", "1", "-M", "2", "-q", "@w2"],
    "n_plain_k": ["-N", "1", "-M", "2", "-k", "1"],
    "n_noops": ["-N", "1", "-M", "2", "-W", "1", "-b", "1", "-J", "1", "-k",
                "1", "-a", "1", "-z", "@ignore"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_stochastic_options",
                    {tag: COMMON + f for tag, f in STOCH.items()},
                    base=True)
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(STOCH))
@pytest.mark.parametrize("key", ["res_0", "res_1"])
def test_stochastic_options_residual_norms_match(runs, tag, key):
    check_residual_norms(runs, tag, key, nu=False)


@pytest.mark.parametrize("tag", sorted(STOCH))
def test_stochastic_options_solutions_and_column_match(runs, tag):
    check_solutions_and_column(runs, tag)


def test_stochastic_warm_start_moves_the_start(runs):
    """Each -q run's tile 0 starts elsewhere than its run from the
    identity, in both CLIs."""
    out = runs[2]
    for tag, plain in (("n_warm", "n_plain"), ("n_warm_bands", "n_w2"),
                       ("n_warm_first_band", "n_plain")):
        for k in (0, 1):
            assert out[tag][k][0]["res_0"] != out[plain][k][0]["res_0"]


def test_stochastic_ignores_full_batch_options(runs):
    """Under -N, -W 1 -b 1 -J 1 -a 1 -z change nothing in either CLI."""
    tmp, _, out = runs
    for side, k in (("jax", 0), ("torch", 1)):
        assert [h["res_1"] for h in out["n_noops"][k]] == \
            [h["res_1"] for h in out["n_plain_k"][k]]
        assert (tmp / f"n_noops_{side}.sol").read_text() == \
            (tmp / f"n_plain_k_{side}.sol").read_text()
        a = tds.SimMS(str(tmp / f"n_noops_{side}.ms"),
                      data_column="CORRECTED_DATA")
        b = tds.SimMS(str(tmp / f"n_plain_k_{side}.ms"),
                      data_column="CORRECTED_DATA")
        for i in range(N_TILES):
            np.testing.assert_array_equal(a.read_tile(i).x,
                                          b.read_tile(i).x)
