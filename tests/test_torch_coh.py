"""Port coherency kernel module (sagecal_tpu_torch/ops/coh.py) against
the JAX reference: its plain PyTorch version must match the Pallas
kernel in interpret mode (float32, the tolerance of
tests/test_pallas.py) and the XLA predict path in float64 (rtol 1e-10:
the same maths summed in another order). The CUDA kernel's arithmetic
(csrc/coh.cu) is replayed here by a numpy float32 replica, and its launch
geometry and host-side channel-spacing decision are checked on the
CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import skymodel
from sagecal_tpu.io import dataset as jds
from sagecal_tpu.ops import coh_pallas
from sagecal_tpu.rime import predict as rp
from sagecal_tpu_torch import convert
from sagecal_tpu_torch.ops import coh as tcoh
from sagecal_tpu_torch.rime import predict as trp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def point_sky(n_clusters=2, n_src=3, seed=0):
    """The tests/test_pallas.py point-source model."""
    rng = np.random.default_rng(seed)
    srcs, clusters = {}, []
    for m in range(n_clusters):
        names = []
        for s in range(n_src):
            nm = f"P{m}_{s}"
            ll, mm = rng.normal(0, 0.02, 2)
            nn = np.sqrt(1 - ll * ll - mm * mm)
            srcs[nm] = skymodel.Source(
                name=nm, ra=0, dec=0, ll=ll, mm=mm, nn=nn - 1,
                sI=float(rng.uniform(0.5, 3)), sQ=0.2, sU=0.1, sV=-0.05,
                sI0=2.0, sQ0=0.2, sU0=0.1, sV0=-0.05,
                spec_idx=-0.7, spec_idx1=0.0, spec_idx2=0.0, f0=150e6)
            names.append(nm)
        clusters.append((m, 1, names))
    return skymodel.build_cluster_sky(srcs, clusters)


def gaussian_sky(seed=3, project=True):
    """The tests/test_pallas.py mixed point + gaussian model."""
    sky = point_sky(seed=seed)
    rng = np.random.default_rng(seed)
    for m in range(sky.stype.shape[0]):
        sky.stype[m, 0] = skymodel.STYPE_GAUSSIAN
        sky.eX[m, 0] = 2 * 0.002
        sky.eY[m, 0] = 2 * 0.001
        sky.eP[m, 0] = float(rng.random())
        if project:
            xi = float(rng.random())
            phi = float(rng.random())
            sky.cxi[m, 0], sky.sxi[m, 0] = np.cos(xi), np.sin(xi)
            sky.cphi[m, 0], sky.sphi[m, 0] = np.cos(phi), np.sin(phi)
            sky.use_projection[m, 0] = True
    return sky


SKIES = {"point": lambda: point_sky(),
         "gauss_noproj": lambda: gaussian_sky(project=False),
         "gauss_proj": lambda: gaussian_sky(project=True)}


def _inputs(dtype, seed=1, B=37):
    rng = np.random.default_rng(seed)
    u = rng.normal(0, 2e-6, B)
    v = rng.normal(0, 2e-6, B)
    w = rng.normal(0, 2e-7, B)
    freqs = np.array([140e6, 150e6, 160e6])
    return [np.asarray(a, dtype) for a in (u, v, w, freqs)]


def _port(sky, arrs, fdelta, per_channel, dtype):
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields},
        real_dtype=dtype)
    u, v, w, f = (torch.as_tensor(a).to(dtype) for a in arrs)
    return trp.coherencies(tsky, u, v, w, f, fdelta,
                           per_channel_flux=per_channel).numpy()


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("kind", sorted(SKIES))
def test_plain_matches_pallas_interpret_f32(kind, per_channel):
    sky = SKIES[kind]()
    arrs = _inputs(np.float32)
    want = np.asarray(coh_pallas.coherencies(
        rp.sky_to_device(sky, jnp.float32),
        *[jnp.asarray(a) for a in arrs], 0.18e6,
        per_channel_flux=per_channel, block_b=16, interpret=True))
    got = _port(sky, arrs, 0.18e6, per_channel, torch.float32)
    assert got.shape == want.shape == (2, 37, 3, 2, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("kind", sorted(SKIES))
def test_plain_matches_xla_predict_f64(kind, per_channel):
    sky = SKIES[kind]()
    arrs = _inputs(np.float64)
    want = np.asarray(rp.coherencies(
        rp.sky_to_device(sky, jnp.float64),
        *[jnp.asarray(a) for a in arrs], 0.18e6,
        per_channel_flux=per_channel))
    got = _port(sky, arrs, 0.18e6, per_channel, torch.float64)
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_supported_matches_reference():
    sky = point_sky()
    assert tcoh.supported(sky) == coh_pallas.supported(sky)
    sky.stype[0, 1] = skymodel.STYPE_SHAPELET
    assert not tcoh.supported(sky)
    assert tcoh.supported(sky) == coh_pallas.supported(sky)


def test_extended_sources_raise():
    """A disk source no longer raises: the predict splits the sky (the
    kernel's plain version on the points, the eager envelope on the disk)
    and matches the JAX predict."""
    sky = point_sky()
    sky.stype[0, 1] = skymodel.STYPE_DISK
    sky.eX[0, 1] = sky.eY[0, 1] = 2e-3
    assert not tcoh.supported(sky) and tcoh.any_supported(sky)
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    arrs = _inputs(np.float64)
    want = np.asarray(rp.coherencies(dsky, *(jnp.asarray(a) for a in arrs),
                                     0.18e6))
    u, v, w, f = (torch.as_tensor(a) for a in arrs)
    got = trp.coherencies(tsky, u, v, w, f, 0.18e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_gauss_coeffs_and_weights_match():
    sky = gaussian_sky()
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    np.testing.assert_allclose(tcoh.gauss_coeffs(tsky).numpy(),
                               np.asarray(coh_pallas.gauss_coeffs(dsky)),
                               rtol=1e-14, atol=1e-16)
    f = np.array([140e6, 160e6])
    np.testing.assert_allclose(
        tcoh.stokes_weights(tsky, torch.as_tensor(f), True).numpy(),
        np.asarray(coh_pallas.stokes_weights(dsky, jnp.asarray(f), True)),
        rtol=1e-13)


@pytest.mark.parametrize("per_channel", [False, True])
def test_stokes_weights_broadcast_matches(per_channel):
    """The channel broadcast of ``stokes_weights`` against the JAX
    ``vmap`` over channels, with per-channel flux on and off."""
    sky = gaussian_sky()
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    f = np.array([140e6, 150e6, 163e6])
    got = tcoh.stokes_weights(tsky, torch.as_tensor(f), per_channel).numpy()
    want = np.asarray(coh_pallas.stokes_weights(dsky, jnp.asarray(f),
                                                per_channel))
    assert got.shape == want.shape == (2, 3, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-13)


@pytest.mark.parametrize("B", [257, 1000])
@pytest.mark.parametrize("F", [1, 3, 8, 17])
def test_coh_geometry_covers_each_channel_and_row_once(F, B):
    """Replays csrc/coh.cu's grid over (row block, channel tile) and its
    threads: every (channel, row) of a cluster is written exactly once,
    no tile exceeds the kernel's channel capacity, and the geometry
    passes the launch's own checks."""
    geo = tcoh.coh_geometry(F, B)
    assert geo.ft in tcoh.COH_FT and 1 <= geo.tile <= geo.ft
    assert geo.n_tiles * geo.tile >= F > (geo.n_tiles - 1) * geo.tile
    R = tcoh.COH_ROWS
    assert geo.row_blocks * R >= B > (geo.row_blocks - 1) * R
    seen = np.zeros((F, B), int)
    for t in range(geo.n_tiles):
        f0 = t * geo.tile
        nf = min(geo.tile, F - f0)
        assert 1 <= nf <= geo.ft
        for rb in range(geo.row_blocks):
            b = rb * R + np.arange(R)
            b = b[b < B]
            seen[f0:f0 + nf, b[:, None]] += 1
    assert np.all(seen == 1)


def test_channel_step_decides_on_the_host():
    f = 150e6 + 0.18e6 * (np.arange(8) - 3.5)
    assert tcoh.channel_step(f) == pytest.approx(0.18e6, rel=1e-12)
    # a list built by accumulation (float64 roundoff) is still even
    acc = np.cumsum(np.r_[149e6, np.full(16, 195312.5 / 3)])
    assert tcoh.channel_step(acc) == pytest.approx(195312.5 / 3)
    assert tcoh.channel_step(np.float32(f)) == pytest.approx(0.18e6)
    g = f.copy()
    g[5] += 1e3
    assert tcoh.channel_step(g) is None
    assert tcoh.channel_step([150e6]) is None
    assert tcoh.channel_step(np.array([150e6, 150e6])) is None


def test_coherencies_take_the_step_from_the_host_list(monkeypatch):
    """``coherencies`` uploads the host's channel list and derives the
    kernel's channel step from that same list, so the channels and the
    step cannot disagree; a list, a numpy array and a CPU tensor give the
    same result, and a channel list already on a device is refused."""
    sky = gaussian_sky()
    dsky = rp.sky_to_device(sky, jnp.float64)
    tsky = convert.sky_from_numpy(
        {k: np.asarray(getattr(dsky, k)) for k in dsky._fields})
    u, v, w, _ = (torch.as_tensor(a) for a in _inputs(np.float64))
    seen = []
    real = tcoh.coherencies_points

    def spy(*args, step=None):
        seen.append((args[4].numpy().copy(), step))
        return real(*args, step=step)

    monkeypatch.setattr(tcoh, "coherencies_points", spy)
    even = 150e6 + 0.18e6 * np.arange(4)
    uneven = even + np.array([0, 0, 1e3, 0])
    assert tcoh.channel_step(even) is not None
    for fl, step in ((even, tcoh.channel_step(even)), (uneven, None)):
        seen.clear()
        outs = [tcoh.coherencies(tsky, u, v, w, f, 0.18e6, True)
                for f in (fl, list(fl), torch.as_tensor(fl))]
        for out in outs[1:]:
            assert torch.equal(out, outs[0])
        for freqs, got in seen:
            np.testing.assert_array_equal(freqs, fl)
            assert got == step
    with pytest.raises(TypeError, match="host"):
        tcoh.coherencies(tsky, u, v, w, torch.empty(4, device="meta"),
                         0.18e6)


# -- a numpy float32 replica of csrc/coh.cu's arithmetic ---------------------

F32, F64 = np.float32, np.float64


def _fma(a, b, c):
    """fmaf: the float64 product of two float32 values is exact."""
    return (np.asarray(a, F64) * np.asarray(b, F64)
            + np.asarray(c, F64)).astype(F32)


#: csrc/coh.cu sincospi_red: minimax coefficients in u = r^2 of sin(pi r) / r
#: and cos(pi r) on [-1/2, 1/2]
SIN_C = [F32(c) for c in (3.1415927410125732, -5.167710304260254,
                          2.5500776767730713, -0.5982921719551086,
                          0.07765940576791763)]
COS_C = [F32(c) for c in (1.0, -4.934802055358887, 4.058709144592285,
                          -1.3352121114730835, 0.23493756353855133,
                          -0.024396715685725212)]


def _sincospi(a, b):
    """csrc/coh.cu sincospi_red of the exact product of float32 a, b
    (half turns): (sin, cos) up to the returned sign (-1)^rint(a b)."""
    magic = F32(12582912.0)
    x = np.asarray(a, F32).astype(F64) * np.asarray(b, F32)   # exact
    y = (x + magic).astype(F32)
    r = (x - (y - magic)).astype(F32)
    u = r * r

    def poly(cf):
        acc = np.full_like(u, cf[-1])
        for c in cf[-2::-1]:
            acc = _fma(acc, u, c)
        return acc

    sign = np.where(y.view(np.int32) & 1, F32(-1), F32(1))
    return r * poly(SIN_C), poly(COS_C), sign


def test_sincospi_red_within_2e7():
    """The kernel's reduced sincos against float64 over phases of up to
    4000 half turns and near 0: within 1.6e-7 (about 2.6 float32 ulp at
    1, against the ~1e-5 rad of a float32 phase at 1e3 rad)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-4000, 4000, 200_000),
                        rng.uniform(-1, 1, 100_000)]).astype(F32)
    s, c, sign = _sincospi(x, F32(1))
    r = np.pi * (x.astype(F64) - 2 * np.rint(x.astype(F64) / 2))
    assert np.abs(s * sign.astype(F64) - np.sin(r)).max() <= 2e-7
    assert np.abs(c * sign.astype(F64) - np.cos(r)).max() <= 2e-7


def kernel_replica(uvw3, geom, flux, gauss, freqs, fdelta, step=None):
    """csrc/coh.cu's formulation in numpy float32, [M, B, F, 8]: channel
    tiles from ``coh_geometry``; per (m, b, s) once the fringe rate G' in
    turns per Hz (fmaf chain), |sinc| by the reduced sine and a
    reciprocal, the gaussian's q; per channel the phasor by the reduced
    sincos of 2 G' f (an exact reduction in half turns) or, given
    ``step``, the tile's first channel and the step by it and each next
    channel by rotation (restarted every tile), the envelope by exp2, and
    the sums XX, YY, P, Q, R, T."""
    M, _, S = geom.shape
    F, B = freqs.shape[0], uvw3.shape[1]
    u, v, w = (uvw3[i].astype(F32) for i in range(3))
    geo = tcoh.coh_geometry(F, B)
    recur = step is not None and F > 1
    PI, HALF_PI = F32(3.14159265358979), F32(1.5707963267948966)
    LOG2E = F32(1.4426950408889634)
    out = np.zeros((M, B, F, 8), F32)
    for m in range(M):
        for t in range(geo.n_tiles):
            f0 = t * geo.tile
            nf = min(geo.tile, F - f0)
            fk = freqs[f0:f0 + nf].astype(F32)
            two_f = F32(2) * fk
            ex2 = -(fk * fk) * LOG2E
            acc = np.zeros((nf, 8, B), F32)
            for s in range(S):
                gl, gm, gn = geom[m, :, s]
                Gp = _fma(gl, u, _fma(gm, v, gn * w))
                xs = Gp * F32(fdelta)
                xpi = PI * xs
                with np.errstate(divide="ignore", invalid="ignore"):
                    sinc = np.abs((_sincospi(Gp, fdelta)[0].astype(F64)
                                   / xpi).astype(F32))
                scale = np.where(np.abs(xpi) > 1e-30, sinc, F32(1))
                g = gauss[m, :, s]
                isg = g[10] > 0
                if isg:
                    up = _fma(g[0], u, _fma(g[1], v, g[2] * w))
                    vp = _fma(g[3], u, _fma(g[4], v, g[5] * w))
                    ut = _fma(g[6], up, g[7] * vp)
                    vt = _fma(g[8], up, g[9] * vp)
                    q = _fma(ut, ut, vt * vt)
                    scale = scale * HALF_PI
                if recur:
                    sn, cs, sign = _sincospi(Gp, two_f[0])
                    scale = scale * sign
                    sd, cd, sign = _sincospi(Gp, F32(2) * F32(step))
                    sd, cd = sd * sign, cd * sign
                    if not isg:
                        cs, sn = cs * scale, sn * scale
                for k in range(nf):
                    e = scale
                    if not recur:
                        sn, cs, sign = _sincospi(Gp, two_f[k])
                        e = e * sign
                    if isg:
                        e = e * np.exp2(ex2[k] * q).astype(F32)
                    C, Sn = cs, sn
                    if isg or not recur:
                        C, Sn = C * e, Sn * e
                    wt = flux[m, f0 + k, :, s].astype(F32)
                    a = acc[k]
                    for c, (wi, ph) in enumerate(((0, C), (0, Sn), (2, C),
                                                  (3, Sn), (2, Sn), (3, C),
                                                  (1, C), (1, Sn))):
                        a[c] = _fma(wt[wi], ph, a[c])
                    if recur:
                        cs, sn = (_fma(cs, cd, -(sn * sd)),
                                  _fma(sn, cd, cs * sd))
            for k in range(nf):
                xx_r, xx_i, P, Q, R, T, yy_r, yy_i = acc[k]
                out[m, :, f0 + k] = np.stack(
                    [xx_r, xx_i, P - Q, R + T, P + Q, R - T, yy_r, yy_i], -1)
    return out


def full_width_sky(spread: float, seed: int = 0, n_clusters: int = 2,
                   n_src: int = 64):
    """Clusters of ``n_src`` sources (a quarter gaussian, projected) ~0.004
    around centres ``spread`` (rad, rms) from the phase centre: 0.03 is
    chip_smoke.py's ~3 degree field, 0.15 a wide one."""
    rng = np.random.default_rng(seed)
    srcs, clusters = {}, []
    for m in range(n_clusters):
        c = rng.normal(0, spread, 2)
        names = []
        for s in range(n_src):
            nm = f"S{m}_{s}"
            ll, mm = c + rng.normal(0, 0.004, 2)
            nn = np.sqrt(1 - ll * ll - mm * mm)
            sI0 = float(rng.uniform(0.2, 2))
            srcs[nm] = skymodel.Source(
                name=nm, ra=0, dec=0, ll=ll, mm=mm, nn=nn - 1, sI=sI0,
                sQ=0.1, sU=0.05, sV=-0.02, sI0=sI0, sQ0=0.1, sU0=0.05,
                sV0=-0.02, spec_idx=-0.7, spec_idx1=0.0, spec_idx2=0.0,
                f0=150e6)
            names.append(nm)
        clusters.append((m, 1, names))
    sky = skymodel.build_cluster_sky(srcs, clusters)
    for m in range(n_clusters):
        for s in range(0, n_src, 4):
            sky.stype[m, s] = skymodel.STYPE_GAUSSIAN
            sky.eX[m, s] = 2 * rng.uniform(1e-4, 4e-4)
            sky.eY[m, s] = 2 * rng.uniform(5e-5, 2e-4)
            sky.eP[m, s] = rng.uniform(0, np.pi)
            xi, phi = rng.random(2)
            sky.cxi[m, s], sky.sxi[m, s] = np.cos(xi), np.sin(xi)
            sky.cphi[m, s], sky.sphi[m, s] = np.cos(phi), np.sin(phi)
            sky.use_projection[m, s] = True
    return sky


def full_width_rows(B: int = 400, seed: int = 0):
    """``B`` rows (seconds, float32) of chip_smoke.py's 62-station tracks
    (120 timeslots of 10 s at declination 52), the longest baseline
    among them."""
    xyz = jds.random_array(62, seed=1)
    ha = np.linspace(0.0, jds.OMEGA_E * 10.0 * 120, 120, endpoint=False)
    u, v, w, _, _ = jds.uvw_tracks(xyz, 52 * np.pi / 180, ha)
    u, v, w = (a.reshape(-1) / jds.C_M_S for a in (u, v, w))
    rows = np.random.default_rng(seed).choice(u.size, B, replace=False)
    rows[0] = np.argmax(u * u + v * v)
    return [a[rows].astype(F32) for a in (u, v, w)]


#: chip_smoke.py's channels: 150 MHz +- 0.63 MHz, 8 of 0.18 MHz
FULL_FREQS = (150e6 + 0.18e6 * (np.arange(8) - 3.5)).astype(F32)

_JAX_REFS = {}


def _jax_refs(spread):
    """(inputs, JAX interpret kernel f32, XLA predict f64 on the same
    float32-rounded inputs, max phase in rad) for one field, once per
    module."""
    if spread not in _JAX_REFS:
        u, v, w = full_width_rows()
        sky = full_width_sky(spread)
        d32 = rp.sky_to_device(sky, jnp.float32)
        d64 = type(d32)(*(a.astype(jnp.float64)
                          if jnp.issubdtype(a.dtype, jnp.floating) else a
                          for a in d32))
        fd = 0.18e6
        want = np.asarray(rp.coherencies(
            d64, *(jnp.asarray(a, jnp.float64) for a in
                   (u, v, w, FULL_FREQS)), fd, per_channel_flux=True))
        jk = np.asarray(coh_pallas.coherencies(
            d32, *(jnp.asarray(a) for a in (u, v, w, FULL_FREQS)), fd,
            per_channel_flux=True, interpret=True))
        geom = np.asarray(jnp.stack([d32.ll, d32.mm, d32.nn], 1))
        args = (np.stack([u, v, w]), geom,
                np.asarray(coh_pallas.stokes_weights(
                    d32, jnp.asarray(FULL_FREQS), True)),
                np.asarray(coh_pallas.gauss_coeffs(d32)), FULL_FREQS, fd)
        G = np.abs(np.einsum("mcs,cb->msb", geom.astype(F64),
                             np.stack([u, v, w]).astype(F64)))
        phase = 2 * np.pi * float(G.max()) * float(FULL_FREQS.max())
        _JAX_REFS[spread] = (args, jk, want, phase)
    return _JAX_REFS[spread]


@pytest.mark.parametrize("phasor", ["sincos", "recurrence"])
@pytest.mark.parametrize("spread", [0.03, 0.15])
def test_kernel_replica_within_twice_the_jax_kernel_error(spread, phasor):
    """The kernel's float32 formulation (``kernel_replica``) on
    chip_smoke.py's array and channels (400 rows with the longest
    baseline, 2 clusters of 64 sources, a quarter gaussian) against the
    float64 XLA predict on the same float32 inputs: its error, max|diff|
    / max|ref|, is at most twice the JAX Pallas kernel's (interpret
    mode, float32), the card's gate. Measured: chip_smoke's field
    (spread 0.03, max phase 642 rad) JAX kernel 8.4e-6, per-channel
    sincos 4.6e-6, recurrence 4.6e-6; a wide field (0.15, 2896 rad)
    2.6e-5, 1.6e-5, 1.6e-5. The replica also matches the port's plain
    version within the card's 1e-4."""
    args, jk, want, phase = _jax_refs(spread)
    assert phase > 400
    step = tcoh.channel_step(FULL_FREQS) if phasor == "recurrence" else None
    assert phasor == "sincos" or step == pytest.approx(0.18e6)
    rep = kernel_replica(*args, step=step)
    M, B, F, _ = rep.shape
    got = (rep[..., 0::2] + 1j * rep[..., 1::2]).reshape(M, B, F, 2, 2)
    ref = np.abs(want).max()
    err_rep = np.abs(got - want).max() / ref
    err_jax = np.abs(jk - want).max() / ref
    assert err_rep <= 2 * err_jax
    plain = tcoh.coherencies_points_plain(
        *(torch.as_tensor(np.array(a)) for a in args[:5]), args[5]).numpy()
    assert np.abs(rep - plain).max() <= 1e-4 * np.abs(plain).max()
