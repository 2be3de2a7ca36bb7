"""The port's tile packer (sagecal_tpu_torch/io/native.py and
csrc/tile_pack.cc) against the JAX package's ``pack_tile_py``: the
native packer, its numpy version and the reference agree element-wise
(x8 to 1e-12 of its largest magnitude, the row flags and the flag ratio
exactly), over the more-than-half rule, the uv cut, the taper and the
tail padding; and ``VisTile.pack`` / ``solve_input`` against the JAX
``VisTile``'s on the same tile. Inputs are drawn with numpy from seeds."""

import numpy as np
import pytest
import torch

from sagecal_tpu.io import dataset as jds
from sagecal_tpu.io import native as jnat
from sagecal_tpu_torch import convert
from sagecal_tpu_torch.io import native as tnat


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, nrow=300, nchan=5, frac=0.35):
    rng = np.random.default_rng(seed)
    vis = (rng.normal(size=(nrow, nchan, 2, 2))
           + 1j * rng.normal(size=(nrow, nchan, 2, 2)))
    cf = (rng.random((nrow, nchan)) < frac).astype(np.uint8)
    cf[:7] = 1            # fully flagged rows
    cf[7:12, :nchan // 2 + 1] = 0
    cf[7:12, nchan // 2 + 1:] = 1
    u = rng.normal(0, 800.0, nrow)
    v = rng.normal(0, 800.0, nrow)
    return vis, cf, u, v


def _check(got, ref):
    x8, fl, fr = got
    rx8, rfl, rfr = ref
    scale = np.abs(rx8).max()
    np.testing.assert_allclose(x8 / scale, rx8 / scale, rtol=0, atol=1e-12)
    assert np.array_equal(fl, rfl) and fl.dtype == np.uint8
    assert fr == rfr


CASES = {
    "half_rule": dict(nchan=4),               # exactly half good: flag 2
    "odd_channels": dict(nchan=5),
    "uvcut": dict(nchan=6, uvmin=150.0, uvmax=1500.0),
    "taper": dict(nchan=3, uvtaper_m=600.0, freq0=150e6),
    "tail_padding": dict(nchan=2, pad=37),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packers_agree(case):
    kw = dict(CASES[case])
    pad = kw.pop("pad", 0)
    vis, cf, u, v = _inputs(len(case), nchan=kw.pop("nchan"))
    nrow = vis.shape[0] + pad
    ref = jnat.pack_tile_py(vis, cf, u, v, nrow, **kw)
    _check(tnat.pack_tile_py(vis, cf, u, v, nrow, **kw), ref)
    n0 = tnat.PACKS
    _check(tnat.pack_tile(vis, cf, u, v, nrow, **kw), ref)
    assert tnat.PACKS == n0 + 1
    assert tnat.LIB_PATH.startswith(str(tnat.BUILD_DIR))
    if pad:
        assert np.all(ref[1][-pad:] == 1) and not ref[0][-pad:].any()
    assert set(np.unique(ref[1])) <= {0, 1, 2}


def test_build_is_cached_by_source_hash():
    path = tnat.build()
    assert path == tnat.lib_path() and path.exists()
    assert tnat.build() == path


def _tiles(chan_flags: bool):
    """A JAX-simulated tile (its first three rows stored as uv-cut, flag
    2, with no channel flagged; a fifth of the rows flagged) and the
    port's copy of it."""
    from sagecal_tpu import skymodel
    from sagecal_tpu.rime import predict as rp
    import jax.numpy as jnp
    srcs = {"P0": skymodel.Source(name="P0", ra=0.0, dec=0.7, ll=0.01,
                                  mm=0.02, nn=-2.5e-4, sI=2.0, sQ=0.0,
                                  sU=0.0, sV=0.0, sI0=2.0, sQ0=0.0,
                                  sU0=0.0, sV0=0.0, spec_idx=0.0,
                                  spec_idx1=0.0, spec_idx2=0.0, f0=150e6)}
    sky = skymodel.build_cluster_sky(srcs, [(0, 1, ["P0"])])
    tile = jds.simulate_dataset(
        rp.sky_to_device(sky, jnp.float64), 6, 3, [148e6, 150e6, 152e6],
        0.0, 0.7, noise_sigma=0.1, seed=4, flag_fraction=0.2,
        chan_flag_fraction=0.4 if chan_flags else 0.0)
    tile.flags[:3] = 2
    if tile.cflags is not None:
        tile.cflags[:3] = 0
    fields = {k: getattr(tile, k) for k in tile.__dataclass_fields__}
    return tile, convert.tile_from_numpy(**fields)


@pytest.mark.parametrize("chan_flags", [True, False])
@pytest.mark.parametrize("taper", [0.0, 400.0])
def test_vistile_pack_and_solve_input(chan_flags, taper):
    jt, tt = _tiles(chan_flags)
    ref = jt.pack(uvtaper_m=taper)
    _check(tt.pack(uvtaper_m=taper), ref)
    rx8, rfl, rgood = jt.solve_input(uvtaper_m=taper)
    x8, fl, good = tt.solve_input(uvtaper_m=taper)
    np.testing.assert_allclose(x8, rx8, rtol=0, atol=1e-12)
    assert np.array_equal(fl, rfl)
    np.testing.assert_allclose(good, rgood, rtol=0, atol=1e-12)
    if chan_flags or taper:
        # the stored uv-cut rows survive the packed path
        assert np.all(fl[:3] == 2)
    assert tt.flag_ratio == jt.flag_ratio
    assert np.array_equal(tt.time_jd, jt.time_jd)
    assert np.array_equal(tt.tslot, jt.tslot)
