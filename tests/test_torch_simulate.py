"""The simulation modes and the inputs of ``-a``, ``-z``, ``-q`` and
``-b 1`` against the JAX package in float64:

- ``rime/residual.simulate_visibilities``, modes 1/2/3, with and without
  solutions ``J``, with and without an ignore mask, on a point/gaussian
  sky and on a sky of every morphology (the split predict), at 1e-10 of
  max|model|;
- the ``-b 1`` coherencies: channel f of one F-channel call with
  per-channel flux against the JAX package's predict of channel f alone
  (``pipeline._build_chan_solver``), at rtol 1e-10;
- ``skymodel.read_ignore_list`` and ``io/solutions.read_warm_start``
  (the last interval; band 0 of a multi-band file; None for a file with
  no interval; the ValueErrors of a station or effective-cluster
  mismatch)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import skymodel
from sagecal_tpu.io import solutions as sol
from sagecal_tpu.rime import predict as rp
from sagecal_tpu.rime import residual as rr
from sagecal_tpu_torch import skymodel as tsky
from sagecal_tpu_torch.io import solutions as tsol
from sagecal_tpu_torch.rime import predict as trp
from sagecal_tpu_torch.rime import residual as trr

from test_torch_predict_mixed import read_both, write_mixed_sky
from test_torch_residual import _problem

FDELTA = 0.06e6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skies(kind, tmp_path):
    """(JAX host sky, port host sky) of ``kind``: the residual tests'
    point/gaussian sky or a mixed sky of 3 clusters."""
    if kind == "point_gaussian":
        sky = _problem()[0]
        return sky, sky
    return read_both(write_mixed_sky(tmp_path, ["PGDRS", "SGP", "GPR"]))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("kind", ["point_gaussian", "mixed"])
@pytest.mark.parametrize("with_J", [False, True])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_simulate_matches_reference(tmp_path, kind, with_J, mode):
    jsky, psky = _skies(kind, tmp_path)
    _, J, x, uvw, freqs, s1, s2, cidx = _problem()
    M = jsky.n_clusters
    J = J[:M] if with_J else None
    cidx = cidx[:M]
    for ignore in (None, np.arange(M) != 1):
        want = np.asarray(rr.simulate_visibilities(
            rp.sky_to_device(jsky, jnp.float64), jnp.asarray(x),
            *map(jnp.asarray, uvw), jnp.asarray(freqs), FDELTA,
            jnp.asarray(s1), jnp.asarray(s2), mode=mode,
            J=None if J is None else jnp.asarray(J),
            chunk_idx=jnp.asarray(cidx), ignore_mask=ignore))
        got = trr.simulate_visibilities(
            trp.split_sky(psky, torch.float64), _t(x), *map(_t, uvw),
            list(freqs), FDELTA, _t(s1).long(), _t(s2).long(), mode=mode,
            J=None if J is None else _t(J), chunk_idx=_t(cidx).long(),
            ignore_mask=ignore).numpy()
        model = want if mode == 1 else want - x if mode == 2 else x - want
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(model).max())


@pytest.mark.parametrize("kind", ["point_gaussian", "mixed"])
def test_bandpass_channel_slices_match_reference(tmp_path, kind):
    """One call of all channels, sliced, is the JAX per-channel predict."""
    jsky, psky = _skies(kind, tmp_path)
    _, _, _, uvw, freqs, _, _, _ = _problem()
    freqs = np.array([148e6, 150e6, 152e6, 154e6])
    got = trp.coherencies(trp.split_sky(psky, torch.float64),
                          *map(_t, uvw), list(freqs), FDELTA,
                          per_channel_flux=True).numpy()
    dsky = rp.sky_to_device(jsky, jnp.float64)
    for f, fr in enumerate(freqs):
        want = np.asarray(rp.coherencies(
            dsky, *map(jnp.asarray, uvw), jnp.asarray([fr]), FDELTA,
            per_channel_flux=True)[:, :, 0])
        np.testing.assert_allclose(got[:, :, f], want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def test_read_ignore_list_matches_reference(tmp_path):
    path = tmp_path / "ignore.txt"
    path.write_text("# clusters\n\n3 extra words\n  -2\n7\n# 9\n3\n")
    got = tsky.read_ignore_list(str(path))
    assert got == skymodel.read_ignore_list(str(path)) == {3, -2, 7}


def _sky3():
    """A host sky of 3 clusters (1, 2 and 3 chunks), the last with a
    negative id (solved, not subtracted)."""
    return _problem()[0]


def _write(path, blocks, N, nchunk, bands=None):
    """A solution file of ``blocks`` (lists of per-band J with
    ``bands``) through the port's writer."""
    sky = _sky3()
    w = tsol.SolutionWriter(str(path), 150e6, 1e6, 1.0, N, sky.n_clusters,
                            sky.n_eff_clusters, nchan=None if bands is None
                            else 4, nsolbw=bands)
    with w:
        for J in blocks:
            if bands is None:
                w.write_interval(J, nchunk)
            else:
                w.write_interval_multiband(J, nchunk)


def _jones(seed, N, K=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, K, N, 2, 2))
            + 1j * rng.normal(size=(3, K, N, 2, 2)))


@pytest.mark.parametrize("bands", [None, 2])
def test_read_warm_start_matches_reference(tmp_path, bands):
    sky = _sky3()
    N = 5
    blocks = [_jones(s, N) if bands is None
              else [_jones(10 * s + b, N) for b in range(bands)]
              for s in range(3)]
    path = tmp_path / "warm.sol"
    _write(path, blocks, N, sky.nchunk, bands)
    got = tsol.read_warm_start(str(path), sky, N)
    want = sol.read_warm_start(str(path), sky, N)
    np.testing.assert_array_equal(got, want)
    last = blocks[-1] if bands is None else blocks[-1][0]
    # the written columns are rounded to 7 digits; a cluster's chunks
    # past its own count are not in the file
    mask = np.arange(3)[None, :] < sky.nchunk[:, None]
    np.testing.assert_allclose(got[mask], last[mask], rtol=1e-6,
                               atol=1e-6)


def test_read_warm_start_empty_file_is_none(tmp_path):
    sky = _sky3()
    path = tmp_path / "empty.sol"
    _write(path, [], 5, sky.nchunk)
    assert tsol.read_warm_start(str(path), sky, 5) is None
    assert sol.read_warm_start(str(path), sky, 5) is None


@pytest.mark.parametrize("case", ["stations", "clusters"])
def test_read_warm_start_mismatch_raises(tmp_path, case):
    sky = _sky3()
    path = tmp_path / "warm.sol"
    _write(path, [_jones(0, 5)], 5, sky.nchunk)
    n, other = 5, sky
    if case == "stations":
        n = 6
    else:
        # one cluster fewer: the file's effective-cluster count is wrong
        other = tsky.ClusterSky(**{
            f: getattr(sky, f)[:2] for f in sky.__dataclass_fields__})
    with pytest.raises(ValueError, match=case[:7]) as got:
        tsol.read_warm_start(str(path), other, n)
    with pytest.raises(ValueError) as want:
        sol.read_warm_start(str(path), other, n)
    assert str(got.value) == str(want.value)
