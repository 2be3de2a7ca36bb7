"""Both MPI CLIs on ``tests/test_cli_mpi.py``'s four-subband data, more
option sets (``test_torch_cli_mpi.py`` holds the default, ``-C 1 -G
--mdl`` and ``-X``, and the gates): ``-B 1`` (the array factor of a
synthetic layout in every predict), ``-q`` (every subband warm-started
from one solution interval), ``-k 1 -U 1`` (the residual corrected by
cluster 1 and made with the consensus polynomial's solutions) and
``--inflight 2`` (which two clusters run in sequence: the width clamps
to M // 4), each at ``-j 1`` with the written columns within 1e-8 of the
data's largest magnitude and the Z and worker files within 1e-6. And
``--dtype-policy bf16`` (the subbands' rows stored in bf16, the
consensus state in float32): the written columns within 2e-2 of the
data's largest magnitude and the final mean residual within 2e-2 of the
JAX CLI's (the bf16 gate of ``test_torch_dtype_policy_cli.py``), the
port's final residual within 0.25 of its own float64 run's."""

import numpy as np
import pytest
import torch

from sagecal_tpu_torch import utils
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.io import solutions as tsol

from test_torch_cli_mpi import _copy, data, run_both  # noqa: F401
from test_torch_cli_mpi import BASE

import sagecal_tpu_torch.cli_mpi as tcli_mpi


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warm_file(data):
    """One interval of near-identity J beside the data (the -q input)."""
    root, _, _, _, sky = data
    path = root / "warm.txt"
    if not path.exists():
        rng = np.random.default_rng(8)
        J = np.tile(np.eye(2, dtype=complex), (sky.n_clusters, 1, 8, 1, 1))
        J = J + 0.05 * (rng.normal(size=J.shape)
                        + 1j * rng.normal(size=J.shape))
        with tsol.SolutionWriter(str(path), 150e6, 1e6, 1.0, 8,
                                 sky.n_clusters, sky.n_eff_clusters) as w:
            w.write_interval(J, sky.nchunk)
    return str(path)


@pytest.mark.parametrize("tag,flags", [
    ("beam", ["-j", "1", "-B", "1"]),
    ("warm", ["-j", "1", "-q", "@warm"]),
    ("correct_global", ["-j", "1", "-k", "1", "-U", "1"]),
    ("inflight", ["-j", "1", "--inflight", "2"])])
def test_mpi_cli_options_match_reference(data, tag, flags):
    flags = [_warm_file(data) if f == "@warm" else f for f in flags]
    run_both(data, tag, flags)


def _final(lines):
    ln = [x for x in lines if x.startswith("Timeslot:")][-1]
    return float(ln.split("final=")[1].split()[0])


def test_mpi_cli_bf16(data):
    from sagecal_tpu import cli_mpi
    import contextlib
    import io
    _, sky_path, clus_path, _, _ = data
    finals, cols = {}, {}
    for side, policy in (("jax", "bf16"), ("torch", "bf16"),
                         ("f64", "f32")):
        lst, paths, work = _copy(data, f"bf16_{side}")
        argv = ["-f", lst, "-s", str(sky_path), "-c", str(clus_path),
                "-j", "1", "--dtype-policy", policy] + BASE
        if side == "jax":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli_mpi.main(argv + ["--mesh-devices", "1",
                                            "--host-loop"]) == 0
            lines = buf.getvalue().splitlines()
        else:
            lines = []
            assert tcli_mpi.main(argv + ["--platform", "cpu"],
                                 log=lines.append) == 0
        finals[side] = _final(lines)
        cols[side] = [tds.SimMS(p, data_column="CORRECTED_DATA")
                      .read_tile(0).x for p in paths]
        scale = max(np.abs(tds.SimMS(p).read_tile(0).x).max() for p in paths)
    col = max(np.abs(a - b).max() for a, b in zip(cols["torch"],
                                                  cols["jax"])) / scale
    assert col <= 2e-2, col
    assert abs(finals["torch"] / finals["jax"] - 1.0) <= 2e-2, finals
    assert abs(finals["torch"] / finals["f64"] - 1.0) <= 0.25, finals
    assert np.all(np.isfinite(utils.c2r(cols["torch"][0])))
