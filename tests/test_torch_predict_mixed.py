"""The port's predict of every source morphology against the JAX package,
in float64: ``skymodel.split_for_kernel`` field by field against
``split_for_pallas`` (exactly), and the port's generic and split
coherencies (``rime/predict.py``: the coherency kernel's plain version on
the point/gaussian half, the eager envelopes on the rest) against the
JAX generic ``coherencies`` at rtol 1e-10, for each source type alone, a
mixed sky, a cluster with no rest, a sky with no point or gaussian, and
with and without per-channel flux. The skies are LSM text files with
``.fits.modes`` shapelet files, parsed by both packages, with sources
near the phase centre and beyond the projection cut."""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import skymodel
from sagecal_tpu.ops import coh_pallas
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import skymodel as tsky
from sagecal_tpu_torch.ops import coh as tcoh
from sagecal_tpu_torch.rime import predict as trp

RA0 = 2.0 * math.pi / 12
DEC0 = 52.0 * math.pi / 180
FREQS = np.array([140e6, 150e6, 160e6])
FDELTA = 0.18e6
#: leading letter of an LSM name -> morphology (P point)
KINDS = "PGDRS"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hms(rad):
    h = (rad * 12 / math.pi) % 24
    hh, mm = int(h), int((h - int(h)) * 60)
    return f"{hh} {mm} {((h - hh) * 60 - mm) * 60:.8f}"


def _dms(rad):
    d = abs(rad * 180 / math.pi)
    dd, mm = int(d), int((d - int(d)) * 60)
    return f"{'-' if rad < 0 else ''}{dd} {mm} {((d - dd) * 60 - mm) * 60:.8f}"


def write_mixed_sky(tmp, clusters, seed=0, format_3=False, nchunk=None):
    """An LSM sky + cluster file: ``clusters`` a list of per-cluster
    strings of morphology letters (``KINDS``), one source each; every
    other source sits ~5 degrees out (beyond the projection cut),
    shapelets get n0 = 2..6 modes files. Returns (sky, cluster) paths."""
    rng = np.random.default_rng(seed)
    lines, clus = [], []
    for m, kinds in enumerate(clusters):
        names = []
        for s, kind in enumerate(kinds):
            name = f"{kind}{m}x{s}"
            off = 0.09 if s % 2 else 0.01
            ra = RA0 + rng.normal(0, off) / math.cos(DEC0)
            dec = DEC0 + rng.normal(0, off)
            sI = rng.uniform(0.5, 3.0)
            sQ, sU, sV = rng.normal(0, 0.2, 3)
            si = rng.uniform(-1.0, -0.3)
            eX = eY = eP = 0.0
            if kind == "G":
                eX, eY = rng.uniform(1e-4, 4e-3, 2)
                eP = rng.uniform(0, math.pi)
            elif kind in "DR":
                eX = rng.uniform(1e-3, 8e-3)
            elif kind == "S":
                eX, eY = rng.uniform(0.5, 1.5, 2)
                eP = rng.uniform(0, math.pi)
                n0 = 2 + (s + m) % 5
                modes = rng.normal(0, 1.0, n0 * n0)
                with open(tmp / f"{name}.fits.modes", "w") as f:
                    f.write("0 0 0 0 0 0\n"
                            f"{n0} {rng.uniform(2e-3, 2e-2):.8e}\n")
                    f.writelines(f"{i} {x:.10e}\n"
                                 for i, x in enumerate(modes))
            spec = (f"{si:.6f} {rng.normal(0, 0.3):.6f} "
                    f"{rng.normal(0, 0.1):.6f}" if format_3
                    else f"{si:.6f}")
            lines.append(f"{name} {_hms(ra)} {_dms(dec)} {sI:.6f} "
                         f"{sQ:.6f} {sU:.6f} {sV:.6f} {spec} 0 {eX:.8e} "
                         f"{eY:.8e} {eP:.6f} 150e6")
            names.append(name)
        k = 1 if nchunk is None else nchunk[m]
        clus.append(f"{m} {k} " + " ".join(names))
    (tmp / "sky.txt").write_text("\n".join(lines) + "\n")
    (tmp / "sky.txt.cluster").write_text("\n".join(clus) + "\n")
    return tmp / "sky.txt", tmp / "sky.txt.cluster"


def read_both(paths, format_3=False):
    """The sky parsed by each package (host ClusterSky)."""
    args = (str(paths[0]), str(paths[1]), RA0, DEC0, 150e6, format_3)
    return skymodel.read_sky_cluster(*args), tsky.read_sky_cluster(*args)


def _rows(B=53, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 4e-6, B), rng.normal(0, 4e-6, B),
            rng.normal(0, 4e-7, B))


def _jax(sky, per_channel):
    u, v, w = (jnp.asarray(a) for a in _rows())
    return np.asarray(rp.coherencies(
        rp.sky_to_device(sky, jnp.float64), u, v, w, jnp.asarray(FREQS),
        FDELTA, per_channel_flux=per_channel))


def _uvw():
    return [torch.as_tensor(a) for a in _rows()]


def _close(got, want, rtol=1e-10):
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


#: sky name -> per-cluster morphology strings
SKIES = {
    "point": ["PPP", "PP"],
    "gaussian": ["GGG", "GG"],
    "disk": ["DDD", "DD"],
    "ring": ["RRR", "RR"],
    "shapelet": ["SSS", "SS"],
    "mixed": ["PGDRS", "SRDGPPG", "GPS"],
    "no_rest_cluster": ["PGD", "PPG", "GS"],
    "no_point_gaussian": ["DRS", "SSR"],
}


#: the skies with no live point or gaussian: no kernel launch
NO_PG = ("disk", "ring", "shapelet", "no_point_gaussian")


def _sky(tmp_path, name, format_3=False):
    return read_both(write_mixed_sky(tmp_path, SKIES[name], seed=len(name),
                                     format_3=format_3), format_3)


@pytest.mark.parametrize("name", sorted(SKIES))
def test_split_for_kernel_matches_reference(tmp_path, name):
    jsky, psky = _sky(tmp_path, name)
    jpg, jrest = skymodel.split_for_pallas(jsky)
    ppg, prest = tsky.split_for_kernel(psky)
    assert (prest is None) == (jrest is None)
    assert tcoh.any_supported(psky) == coh_pallas.any_supported(jsky)
    assert tcoh.any_supported(psky) == (name not in NO_PG)
    for got, want in ((ppg, jpg), (prest, jrest)):
        if want is None:
            continue
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if not isinstance(b, np.ndarray):
                assert a == b, f.name
                continue
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_split_all_point_gaussian_is_none(tmp_path):
    _, psky = _sky(tmp_path, "gaussian")
    pg, rest = tsky.split_for_kernel(psky)
    assert rest is None
    np.testing.assert_array_equal(pg.smask, psky.smask)
    split = trp.split_sky(psky, torch.float64)
    assert split.rest is None and not split.with_shapelets


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("name", sorted(SKIES))
def test_generic_coherencies_match_reference(tmp_path, name, per_channel):
    jsky, psky = _sky(tmp_path, name)
    got = trp.coherencies_generic(trp.sky_to_device(psky, torch.float64),
                                  *_uvw(), FREQS, FDELTA,
                                  per_channel_flux=per_channel)
    _close(got.numpy(), _jax(jsky, per_channel))


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("name", sorted(SKIES))
def test_split_coherencies_match_reference(tmp_path, name, per_channel,
                                           monkeypatch):
    """The split (the kernel's plain version on the point/gaussian half,
    launched exactly when the sky has such a source, plus the generic
    rest) against the reference's one generic sum."""
    jsky, psky = _sky(tmp_path, name)
    split = trp.split_sky(psky, torch.float64)
    calls = []
    orig = tcoh.coherencies
    monkeypatch.setattr(tcoh, "coherencies",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = trp.coherencies(split, *_uvw(), FREQS, FDELTA,
                          per_channel_flux=per_channel)
    assert len(calls) == (0 if name in NO_PG else 1)
    assert (split.rest is None) == (name in ("point", "gaussian"))
    _close(got.numpy(), _jax(jsky, per_channel))


def test_device_sky_splits_like_host_sky(tmp_path):
    """A SkyArrays handed to ``coherencies`` (the simulator's and the
    residual's direct callers) is split as its host sky is."""
    _, psky = _sky(tmp_path, "mixed")
    a = trp.coherencies(trp.sky_to_device(psky, torch.float64), *_uvw(),
                        FREQS, FDELTA, per_channel_flux=True)
    b = trp.coherencies(trp.split_sky(psky, torch.float64), *_uvw(), FREQS,
                        FDELTA, per_channel_flux=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_format_3_spectra_match_reference(tmp_path):
    """-F 1 skies (nonzero 2nd/3rd-order spectral indices) per channel."""
    jsky, psky = _sky(tmp_path, "mixed", format_3=True)
    assert np.any(psky.spec_idx2 != 0)
    got = trp.coherencies(trp.split_sky(psky, torch.float64), *_uvw(),
                          FREQS, FDELTA, per_channel_flux=True)
    _close(got.numpy(), _jax(jsky, True))


def test_shapelet_rows_in_blocks_match_one_shot(tmp_path, monkeypatch):
    """The shapelet grid summed in row blocks equals the one-shot sum."""
    _, psky = _sky(tmp_path, "shapelet")
    dsky = trp.sky_to_device(psky, torch.float64)
    want = trp.coherencies_generic(dsky, *_uvw(), FREQS, FDELTA)
    from sagecal_tpu_torch.rime import envelopes
    monkeypatch.setattr(envelopes, "SHAPELET_BLOCK_ELEMS", 7 * 3 * 36)
    got = trp.coherencies_generic(dsky, *_uvw(), FREQS, FDELTA)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
