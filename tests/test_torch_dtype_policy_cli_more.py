"""Both CLIs under ``--dtype-policy bf16|f16`` on the CPU, as
test_torch_dtype_policy_cli.py holds them (its harness and gates): ``-j
1 -b 1`` (the joint solve, then an LBFGS fit a channel from data at the
pipeline dtype, rounded to the storage dtype at the fit's entry), ``-N 1
-M 2`` (stochastic calibration: the bands' data and weights staged in the
storage dtype) and ``--tile-batch 2`` on 3 tiles of single-chunk
clusters (tile 0 alone, tiles 1-2 one batch; the default mode's OS
iterations take the reduced OS fast path, each tile's lanes their own
subsets)."""

import pytest
import torch

from test_torch_dtype_policy_cli import check_run


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("policy", ["bf16", "f16"])
@pytest.mark.parametrize("tag", ["bandpass", "stochastic", "tile_batch"])
def test_cli_reduced_matches_reference(tmp_path, tag, policy):
    hj, ht = check_run(tmp_path, tag, policy)
    if tag == "bandpass":
        # every channel's fit lowers its cost
        assert all(c["res_1"] < c["res_0"] for h in ht
                   for c in h["channels"])
    if tag == "tile_batch":
        assert [h["batch"] and h["batch"]["tiles"] for h in ht] == \
            [None, [1, 2], [1, 2]]
