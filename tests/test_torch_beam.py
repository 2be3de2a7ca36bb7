"""The port's station beam (sagecal_tpu_torch/rime/beam.py) and the
beam terms of its predict (rime/predict.py) against the JAX package's,
float64, on inputs drawn with numpy from a seed.

Gates: the element basis, array factor, element Jones and cluster beam
tables to 1e-10 (absolute; the tables are O(1)); the copied LOFAR
element tables bit-equal to the JAX package's; beam.npz and coefficient
files round-tripping in both directions; and the coherencies at dobeam
1, 2 and 3 (a point, a gaussian and a disk per cluster, 2 channels with
per-channel flux) within 1e-10 of the largest magnitude of the JAX
``coherencies(beam=...)``, with no coherency-kernel launch."""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import skymodel
from sagecal_tpu.io import dataset as jds
from sagecal_tpu.rime import beam as jbm
from sagecal_tpu.rime import predict as jrp
from sagecal_tpu_torch import convert
from sagecal_tpu_torch.ops import coh as tcoh
from sagecal_tpu_torch.rime import beam as tbm
from sagecal_tpu_torch.rime import predict as trp

TOL = 1e-10
RA0 = (0 + 41 / 60) * math.pi / 12
DEC0 = 40 * math.pi / 180
FREQS = np.array([149e6, 151e6])
N_ST, TILESZ = 6, 3
#: mid-timeslot JDs of a tile (MJD seconds 4.93e9 + 10 s steps)
TIME_JD = (4.93e9 + 10.0 * (np.arange(TILESZ) + 0.5)) / 86400.0 + 2400000.5
SKY = """\
P0A 0 40 0 40 0 0 3.0 0 0 0 0 0 0 0 0 150e6
G0B 0 42 0 40 30 0 2.0 0 0 0 -0.7 0 2e-4 1e-4 0.5 150e6
D1A 1 20 0 38 0 0 2.5 0 0 0 0 0 5e-4 0 0 150e6
P1B 1 10 0 41 0 0 1.5 0.1 0 0 -0.5 0 0 0 0 150e6
"""
CLUSTER = "0 1 P0A G0B\n1 2 D1A P1B\n"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def _infos(seed=5, band="lba"):
    """The same synthetic beam metadata in both packages."""
    jinfo = jbm.synthetic_beam(N_ST, TIME_JD, RA0, DEC0, 150e6, n_elem=8,
                               band=band, seed=seed)
    return jinfo, convert.beaminfo_from_numpy(**dataclasses.asdict(jinfo))


def _beams(dtype_j=jnp.float64):
    jinfo, tinfo = _infos()
    return (jbm.beam_to_device(jinfo, 150e6, dtype_j),
            tbm.beam_to_device(tinfo, 150e6, torch.float64))


def test_lofar_tables_equal_reference():
    # the port reads its own copy, never a file of the JAX package
    assert "sagecal_tpu_torch" in tbm._DATA_DIR
    for band in ("lba", "hba"):
        a, b = jbm.lofar_element_coeffs(band), tbm.lofar_element_coeffs(band)
        for k in ("freqs", "theta", "phi"):
            assert np.array_equal(getattr(a, k), getattr(b, k))
        assert (a.M, a.beta) == (b.M, b.beta)


def test_mode_tables_and_basis():
    for M in (3, 7):
        for x, y in zip(jbm.mode_table(M), tbm.mode_table(M)):
            assert np.array_equal(x, y)
        _close(jbm.mode_preamble(M, 0.5), tbm.mode_preamble(M, 0.5), 0.0)
    rng = np.random.default_rng(3)
    r = rng.uniform(0, np.pi / 2, 40)
    th = rng.uniform(0, 2 * np.pi, 40)
    got = tbm.element_basis(torch.as_tensor(r), torch.as_tensor(th), 7, 0.5)
    ref = jbm.element_basis(jnp.asarray(r), jnp.asarray(th), 7, 0.5)
    _close(got, ref)


def test_synthetic_coeffs_and_interpolation():
    a = jbm.synthetic_element_coeffs("hba", n_freqs=4)
    b = tbm.synthetic_element_coeffs("hba", n_freqs=4)
    _close(a.theta, b.theta)
    _close(a.phi, b.phi)
    ec = tbm.lofar_element_coeffs("lba")
    jec = jbm.lofar_element_coeffs("lba")
    for f in (5e6, 33.3e6, 58e6, 1e9):
        for x, y in zip(tbm.element_pattern_at(ec, f),
                        jbm.element_pattern_at(jec, f)):
            _close(x, y, 0.0)


def test_beam_to_device_and_synthetic_beam():
    jb, tb = _beams()
    for name in jbm.BeamArrays._fields:
        _close(getattr(tb, name), np.asarray(getattr(jb, name)), 0.0)
    assert tbm.band_for_freq(60e6) == "lba" and \
        tbm.band_for_freq(150e6) == "hba"


def test_array_factor_element_jones_cluster_beam():
    jb, tb = _beams()
    rng = np.random.default_rng(7)
    ra = RA0 + rng.normal(0, 0.05, 5)
    dec = DEC0 + rng.normal(0, 0.05, 5)
    ra_t, dec_t = torch.as_tensor(ra), torch.as_tensor(dec)
    af = tbm.array_factor(tb, ra_t, dec_t, 151e6)
    _close(af, jbm.array_factor(jb, jnp.asarray(ra), jnp.asarray(dec),
                                151e6))
    assert float(af.abs().max()) > 0.1
    E = tbm.element_jones(tb, ra_t, dec_t)
    _close(E, jbm.element_jones(jb, jnp.asarray(ra), jnp.asarray(dec)))
    assert float(E.abs().max()) > 0.1
    for dobeam in (1, 2, 3):
        got = tbm.cluster_beam(tb, ra_t, dec_t, FREQS, dobeam)
        ref = jbm.cluster_beam(jb, jnp.asarray(ra), jnp.asarray(dec),
                               jnp.asarray(FREQS), dobeam)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                _close(g, r)


def test_beaminfo_round_trips(tmp_path):
    jinfo, tinfo = _infos(seed=9, band="hba")
    tbm.save_beaminfo(str(tmp_path / "t.npz"), tinfo)
    jbm.save_beaminfo(str(tmp_path / "j.npz"), jinfo)
    for path in ("t.npz", "j.npz"):
        for load in (tbm.load_beaminfo, jbm.load_beaminfo):
            back = load(str(tmp_path / path))
            for k in ("longitude", "latitude", "time_jd", "elem_xyz",
                      "elem_mask"):
                assert np.array_equal(getattr(back, k), getattr(tinfo, k))
            assert (back.ra0, back.dec0, back.freq0) == \
                (tinfo.ra0, tinfo.dec0, tinfo.freq0)
            for k in ("freqs", "theta", "phi"):
                assert np.array_equal(getattr(back.ecoeff, k),
                                      getattr(tinfo.ecoeff, k))
    tbm.save_element_coeffs(str(tmp_path / "ec.npz"), tinfo.ecoeff)
    back = jbm.load_element_coeffs(str(tmp_path / "ec.npz"))
    assert np.array_equal(back.theta, tinfo.ecoeff.theta)


def test_resolve_beaminfo(tmp_path):
    """A stored beam.npz is read; without one the synthetic layout is
    used, with the warning, as in the JAX package."""
    jinfo, tinfo = _infos()

    class _Stored:
        def beam_info(self):
            return tinfo

    class _None:
        def beam_info(self):
            return None

    meta = {"n_stations": N_ST, "ra0": RA0, "dec0": DEC0, "freq0": 150e6}
    assert tbm.resolve_beaminfo(0, _Stored(), meta) is None
    assert tbm.resolve_beaminfo(2, _Stored(), meta) is tinfo
    logs = []
    got = tbm.resolve_beaminfo(1, _None(), meta, log=logs.append)
    ref = jbm.resolve_beaminfo(1, _None(), meta, log=lambda *a: None)
    assert "SYNTHETIC" in logs[0]
    assert np.array_equal(got.elem_xyz, ref.elem_xyz)
    assert np.array_equal(got.ecoeff.theta, ref.ecoeff.theta)


def _skies(tmp_path):
    (tmp_path / "sky.txt").write_text(SKY)
    (tmp_path / "sky.txt.cluster").write_text(CLUSTER)
    srcs = skymodel.parse_sky_model(str(tmp_path / "sky.txt"), RA0, DEC0,
                                    150e6)
    sky = skymodel.build_cluster_sky(srcs, skymodel.parse_cluster_file(
        str(tmp_path / "sky.txt.cluster")))
    jsky = jrp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy({k: np.asarray(getattr(jsky, k))
                                   for k in jrp.SkyArrays._fields})
    return jsky, tsky


@pytest.mark.parametrize("dobeam", [1, 2, 3])
def test_coherencies_with_beam(tmp_path, dobeam):
    jsky, tsky = _skies(tmp_path)
    jb, tb = _beams()
    xyz = jds.random_array(N_ST, seed=4)
    ha = np.linspace(0.0, 7.29e-5 * 10 * TILESZ, TILESZ, endpoint=False)
    u, v, w, p, q = jds.uvw_tracks(xyz, DEC0, ha)
    u, v, w = (a.reshape(-1) / jds.C_M_S for a in (u, v, w))
    nbase = p.shape[0]
    s1, s2 = np.tile(p, TILESZ), np.tile(q, TILESZ)
    ts = jds.row_tslot(u.shape[0], nbase)
    ref = jrp.coherencies(jsky, jnp.asarray(u), jnp.asarray(v),
                          jnp.asarray(w), jnp.asarray(FREQS), 1e6,
                          per_channel_flux=True, beam=jb, dobeam=dobeam,
                          tslot=jnp.asarray(ts), sta1=jnp.asarray(s1),
                          sta2=jnp.asarray(s2))
    t = torch.as_tensor
    c0 = tcoh.LAUNCHES
    kw = dict(per_channel_flux=True, beam=tb, dobeam=dobeam,
              tslot=t(ts).long(), sta1=t(s1).long(), sta2=t(s2).long())
    got = trp.coherencies(tsky, t(u), t(v), t(w), FREQS, 1e6, **kw)
    # a split sky takes the generic route with the beam too
    split = trp.coherencies(trp.split_arrays(tsky), t(u), t(v), t(w), FREQS,
                            1e6, **kw)
    assert tcoh.LAUNCHES == c0
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    _close(got.numpy() / scale, ref / scale)
    _close(split.numpy() / scale, ref / scale)
    # the beam changes the prediction
    plain = trp.coherencies(tsky, t(u), t(v), t(w), FREQS, 1e6,
                            per_channel_flux=True)
    assert np.abs(plain.numpy() - ref).max() > 1e-3 * scale


def test_simulate_dataset_through_the_beam(tmp_path):
    """``simulate_dataset`` with the full beam, row and channel flags:
    the port's tile equals the JAX package's (data within 1e-10 of its
    largest magnitude, flags exactly), and a beam.npz round-trips
    through ``SimMS.create(beam_info=)``."""
    from sagecal_tpu_torch.io import dataset as tds
    jsky, tsky = _skies(tmp_path)
    jb, tb = _beams()
    J = jds.random_jones(2, np.array([1, 2]), N_ST, seed=2, scale=0.2)
    kw = dict(n_stations=N_ST, tilesz=TILESZ, freqs=FREQS, ra0=RA0,
              dec0=DEC0, jones=J, nchunk=np.array([1, 2]), noise_sigma=0.01,
              seed=4, flag_fraction=0.1, chan_flag_fraction=0.3, dobeam=2)
    ref = jds.simulate_dataset(jsky, beam=jb, **kw)
    got = tds.simulate_dataset(tsky, beam=tb, **kw)
    scale = np.abs(ref.x).max()
    _close(got.x / scale, ref.x / scale)
    assert np.array_equal(got.flags, ref.flags)
    assert np.array_equal(got.cflags, ref.cflags) and got.cflags.any()
    jinfo, tinfo = _infos()
    tds.SimMS.create(str(tmp_path / "b.ms"), [got], beam_info=tinfo)
    back = jds.SimMS(str(tmp_path / "b.ms")).beam_info()
    assert np.array_equal(back.elem_xyz, jinfo.elem_xyz)
    assert tds.SimMS(str(tmp_path / "b.ms")).read_tile(0).cflags is not None
