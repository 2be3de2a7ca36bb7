"""Both CLIs under ``--dtype-policy bf16|f16`` on the CPU, as
test_torch_dtype_policy_cli.py holds them (its harness and gates): ``-j
5 --inner cg --inflight 2`` on 8 clusters (10 stations run it as OS
robust LM with PCG; the groups are lane-batched solves through the
multi-visit sweep, each group's joint update tried at the relaxations)."""

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
def test_cli_inflight_reduced_matches_reference(tmp_path, policy):
    hj, ht = check_run(tmp_path, "inflight", policy)
    assert sum(len(h["groups"]) for h in ht) > 0
