"""Two public functions of ported modules against the JAX package:
``cli.warn_legacy_flags`` (the startup warning on ``-y < 10`` and ``-o >
1``, called on every run of the full-batch CLI) and
``rime/residual.calculate_residuals_interp`` (residuals of the new
solutions corrected by the old ones) in float64 at rtol 1e-10, on
``tests/test_residual_extras.py``'s tiny problem."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagecal_tpu import cli
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.rime import predict as rp
from sagecal_tpu.rime import residual as rr
from sagecal_tpu_torch import cli as tcli
from sagecal_tpu_torch import convert
from sagecal_tpu_torch.rime import residual as trr

from test_residual_extras import _tiny_problem


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [[], ["-y", "5"], ["-o", "2"],
                                   ["-y", "9.5", "-o", "3"],
                                   ["-y", "10", "-o", "1"]])
def test_warn_legacy_flags_matches_reference(extra):
    """The same warnings, word for word, on the same command line."""
    argv = ["-d", "obs.ms", "-s", "sky.txt", "-c", "sky.cluster"] + extra
    outs = []
    for mod in (cli, tcli):
        err = io.StringIO()
        warnings = mod.warn_legacy_flags(mod.build_parser().parse_args(argv),
                                         err=err)
        outs.append((warnings, err.getvalue()))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == ("-y" in extra and float(extra[1]) < 10) \
        + ("-o" in extra and float(extra[extra.index("-o") + 1]) > 1)


def test_full_batch_cli_warns_on_every_run(tmp_path, capsys):
    """The port's CLI prints the warning before it runs (here the run
    then fails on a missing dataset)."""
    with pytest.raises(Exception):
        tcli.main(["-d", str(tmp_path / "none.ms"), "-s", "s", "-c", "c",
                   "-y", "5", "-j", "1", "--platform", "cpu"])
    assert "-y/--uvmax=5 lambda" in capsys.readouterr().err


@pytest.mark.parametrize("correct", [None, 0, 1])
def test_residuals_interp_match_reference(tmp_path, correct):
    """Old and new solutions differ: the model of J_new subtracted, the
    residual corrected by J_old's cluster ``correct`` (none: the plain
    residual of J_new)."""
    _, sky, dsky, tile, Jtrue = _tiny_problem(tmp_path, [149e6, 151e6])
    J_old = ds.random_jones(2, sky.nchunk, tile.n_stations, seed=7,
                            scale=0.2)
    cidx = rp.chunk_indices(tile.tilesz, tile.nbase, sky.nchunk)
    rows = (tile.x, tile.u, tile.v, tile.w)
    want = np.asarray(rr.calculate_residuals_interp(
        dsky, jnp.asarray(J_old), jnp.asarray(Jtrue),
        *map(jnp.asarray, rows), jnp.asarray(tile.freqs), tile.fdelta / 2,
        jnp.asarray(tile.sta1), jnp.asarray(tile.sta2), jnp.asarray(cidx),
        jnp.asarray(sky.subtract_mask()), correct_idx=correct))
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    t = lambda a: torch.as_tensor(np.array(a))
    got = trr.calculate_residuals_interp(
        tsky, t(J_old), t(Jtrue), *map(t, rows), np.asarray(tile.freqs),
        tile.fdelta / 2, t(tile.sta1).long(), t(tile.sta2).long(),
        t(cidx).long(), sky.subtract_mask(), correct_idx=correct).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())
    if correct is not None:
        plain = trr.calculate_residuals_multifreq(
            tsky, t(Jtrue), *map(t, rows), np.asarray(tile.freqs),
            tile.fdelta / 2, t(tile.sta1).long(), t(tile.sta2).long(),
            t(cidx).long(), sky.subtract_mask(),
            correct_idx=correct).numpy()
        assert np.abs(got - plain).max() > 1e-6 * np.abs(plain).max()
