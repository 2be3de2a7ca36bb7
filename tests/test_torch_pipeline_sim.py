"""The simulation modes ``-a 1/2/3`` end to end: both CLIs on the
observation of test_torch_pipeline_options.py (3 tiles of 8 stations, 5
timeslots and 4 channels; 3 clusters), float64 on the CPU: ``-a 1``,
``-a 2`` and ``-a 3`` with ``-p`` (the JAX base run's solutions, tile ti
taking interval min(ti, 2)), with ``-p -z`` (cluster 1 left out), and
``-a 1`` without ``-p``, with and without ``-z`` (which then does
nothing, as in the JAX package). Gate: the written column 1e-10 of its
largest magnitude."""

import numpy as np
import pytest
import torch

from sagecal_tpu_torch.io import dataset as tds

from test_torch_pipeline_options import N_TILES, both_clis, columns

#: tag -> flags ("@base" the base run's JAX solutions, "@ignore" the -z
#: file naming cluster 1)
SIM = {
    "a1": ["-a", "1"],
    "a1_z": ["-a", "1", "-z", "@ignore"],
    "a1_p": ["-a", "1", "-p", "@base"],
    "a2_p": ["-a", "2", "-p", "@base"],
    "a3_p": ["-a", "3", "-p", "@base"],
    "a1_pz": ["-a", "1", "-p", "@base", "-z", "@ignore"],
    "a2_pz": ["-a", "2", "-p", "@base", "-z", "@ignore"],
    "a3_pz": ["-a", "3", "-p", "@base", "-z", "@ignore"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield both_clis(tmp_path_factory, "torch_pipeline_sim", SIM, sim=True,
                    base=True)
    torch.set_num_threads(n)


@pytest.mark.parametrize("tag", sorted(SIM))
def test_simulation_column_matches(runs, tag):
    tmp = runs[0]
    for got, want in columns(tmp, tag):
        assert got.shape == want.shape and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want,
                                   atol=1e-10 * np.abs(want).max())


def test_simulation_modes_compose(runs):
    """a2 - data, data - a3 and a1 agree; -z leaves cluster 1 out only
    with -p; the solutions change the model; the CPU run launches no
    kernel."""
    tmp = runs[0]
    raw = tds.SimMS(str(tmp / "pristine.ms"))
    col = {tag: [c[0] for c in columns(tmp, tag)] for tag in SIM}
    for i in range(N_TILES):
        x = raw.read_tile(i).x
        for z in ("p", "pz"):
            a1 = col[f"a1_{z}"][i]
            np.testing.assert_allclose(col[f"a2_{z}"][i] - x, a1,
                                       atol=1e-12 * np.abs(a1).max())
            np.testing.assert_allclose(x - col[f"a3_{z}"][i], a1,
                                       atol=1e-12 * np.abs(a1).max())
        np.testing.assert_array_equal(col["a1_z"][i], col["a1"][i])
        assert not np.allclose(col["a1_pz"][i], col["a1_p"][i])
        assert not np.allclose(col["a1_p"][i], col["a1"][i])
    hist = runs[2]["a1_p"][1]
    assert [h["tile"] for h in hist] == list(range(N_TILES))
    assert all(h["launches"]["coh"] == 0 for h in hist)
