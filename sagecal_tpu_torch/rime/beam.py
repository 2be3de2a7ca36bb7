"""Station beam models (port of ``sagecal_tpu/rime/beam.py``): the
geometric array factor and the spherical element beam.

Reference ``src/lib/Radio``:

- ``arraybeam`` (stationbeam.c:44): the per-(source, time, station)
  array-factor gain |mean_k exp(-i 2 pi / c r . p_k)|, beamformed at
  ``f0`` toward (ra0, dec0), evaluated at ``f`` toward the source; 0
  below the horizon;
- ``element_beam`` (stationbeam.c:119-260): the per-(source, time,
  station) 2x2 element Jones from a dual-pol polar basis (elementbeam.c
  ``eval_elementcoeffs``), E = [[X.theta, X.phi], [Y.theta, Y.phi]] with
  X at (zd, az - pi/4) and Y at (zd, az + pi/4);
- ``set_elementcoeffs`` (elementbeam.c:39): linear interpolation of the
  coefficient tables in frequency. The measured LOFAR LBA/HBA tables
  ship as data (``rime/data/lofar_elem_{lba,hba}.npz``, the JAX
  package's files unchanged).

The tables are computed in plain PyTorch on the tensors' device, in
their dtype (float32 on the card, float64 on the CPU), as the JAX
package computes them in XLA: they feed the generic predict
(``rime.predict``), never the coherency kernel. Beam modes follow
Dirac_common.h:97-109: NONE 0, ARRAY 1, FULL 2, ELEMENT 3.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import coords

C_M_S = 299792458.0

DOBEAM_NONE = 0
DOBEAM_ARRAY = 1
DOBEAM_FULL = 2
DOBEAM_ELEMENT = 3

BEAM_ELEM_MODES = 7     # polynomial order M; Nmodes = M(M+1)/2 = 28
BEAM_ELEM_BETA = 0.5


# ---------------------------------------------------------------------------
# element-beam coefficient tables (host side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElementCoeffs:
    """Dual-pol element-pattern coefficients on a frequency grid:
    theta/phi [Nfreq, Nmodes] complex, freqs in Hz."""

    freqs: np.ndarray
    theta: np.ndarray
    phi: np.ndarray
    M: int = BEAM_ELEM_MODES
    beta: float = BEAM_ELEM_BETA

    @property
    def n_modes(self) -> int:
        return self.M * (self.M + 1) // 2


def mode_table(M: int):
    """(n, m, p = (n - |m|)/2, |m|) per mode (elementbeam.c:147-158)."""
    n_l, m_l = [], []
    for n in range(M):
        for m in range(-n, n + 1, 2):
            n_l.append(n)
            m_l.append(m)
    n_a = np.asarray(n_l)
    m_a = np.asarray(m_l)
    absm = np.abs(m_a)
    return n_a, m_a, (n_a - absm) // 2, absm


def mode_preamble(M: int, beta: float) -> np.ndarray:
    """Per-mode normalization (elementbeam.c:146-159):
    (-1)^p sqrt(p! / (pi ((n+|m|)/2)!)) / beta^(1+|m|)."""
    n_a, _, p_a, absm = mode_table(M)
    out = np.empty(len(n_a))
    for i, (p, q) in enumerate(zip(p_a, (n_a + absm) // 2)):
        out[i] = math.sqrt(math.factorial(p) / (math.pi * math.factorial(q)))
        if p % 2:
            out[i] = -out[i]
        out[i] *= beta ** (-1.0 - absm[i])
    return out


def _laguerre(p: int, q: int, x):
    """Generalized Laguerre L_p^q(x) by the ascending recursion
    (elementbeam.c:176-196)."""
    if p == 0:
        return torch.ones_like(x)
    lm2 = torch.ones_like(x)
    lm1 = 1.0 + q - x
    if p == 1:
        return lm1
    for i in range(2, p + 1):
        inv = 1.0 / i
        cur = (2.0 + inv * (q - 1.0 - x)) * lm1 - (1.0 + inv * (q - 1)) * lm2
        lm2, lm1 = lm1, cur
    return lm1


def element_basis(r, theta, M: int, beta):
    """The basis at polar (r = zenith angle, theta = rotated azimuth):
    [..., Nmodes] complex (eval_elementcoeffs, elementbeam.c:198-235).
    ``beta`` a float or a 0-d tensor."""
    _, m_a, p_a, absm = mode_table(M)
    pre = mode_preamble(M, 1.0)
    rb = (r / beta) ** 2
    ex = torch.exp(-0.5 * rb)
    cols = []
    for i in range(len(m_a)):
        lg = _laguerre(int(p_a[i]), int(absm[i]), rb)
        rm = (math.pi / 4.0 + r) ** int(absm[i])
        bscale = beta ** (-1.0 - int(absm[i]))
        pr = rm * lg * ex * (float(pre[i]) * bscale)
        ang = -float(m_a[i]) * theta
        cols.append(torch.complex(pr * torch.cos(ang), pr * torch.sin(ang)))
    return torch.stack(cols, dim=-1)


def synthetic_element_coeffs(band: str = "lba", M: int = BEAM_ELEM_MODES,
                             beta: float = BEAM_ELEM_BETA,
                             n_freqs: int = 10) -> ElementCoeffs:
    """The polar basis fitted by least squares to an analytic crossed
    dipole (E_theta ~ cos(zd) cos(phi), E_phi ~ -sin(phi), a gentle
    frequency taper): a stand-in table on the same (M, beta) basis."""
    if band == "lba":
        freqs = np.linspace(10e6, 100e6, n_freqs)
    else:
        freqs = np.linspace(110e6, 250e6, n_freqs)
    rr = np.linspace(0.0, np.pi / 2, 24)
    tt = np.linspace(0.0, 2 * np.pi, 33)[:-1]
    Rg, Tg = np.meshgrid(rr, tt, indexing="ij")
    A = element_basis(torch.as_tensor(Rg.ravel()),
                      torch.as_tensor(Tg.ravel()), M, beta).numpy()
    th_tab = np.empty((n_freqs, A.shape[1]), complex)
    ph_tab = np.empty((n_freqs, A.shape[1]), complex)
    fmid = freqs.mean()
    for i, f in enumerate(freqs):
        taper = np.cos(Rg.ravel()) ** (1.0 + 0.5 * (f - fmid) / fmid)
        e_th = taper * np.cos(Tg.ravel()) * (1.0 + 0.1j * (f - fmid) / fmid)
        e_ph = -np.sin(Tg.ravel()) * (1.0 - 0.05j * (f - fmid) / fmid)
        th_tab[i] = np.linalg.lstsq(A, e_th, rcond=None)[0]
        ph_tab[i] = np.linalg.lstsq(A, e_ph, rcond=None)[0]
    return ElementCoeffs(freqs=freqs, theta=th_tab, phi=ph_tab, M=M,
                         beta=beta)


_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def lofar_element_coeffs(band: str) -> ElementCoeffs:
    """The measured LOFAR LBA/HBA element tables (the reference's
    elementcoeff.h: 10 LBA / 15 HBA frequencies x 28 modes, M = 7,
    beta = 0.5; frequencies in Hz)."""
    return load_element_coeffs(
        os.path.join(_DATA_DIR, f"lofar_elem_{band}.npz"))


def default_element_coeffs(band: str) -> ElementCoeffs:
    """The LOFAR tables; the synthetic dipole fit only if the packaged
    data files are missing."""
    try:
        return lofar_element_coeffs(band)
    except (FileNotFoundError, OSError):        # pragma: no cover
        return synthetic_element_coeffs(band)


def save_element_coeffs(path: str, ecoeff: ElementCoeffs) -> None:
    np.savez(path, freqs=ecoeff.freqs, theta=ecoeff.theta, phi=ecoeff.phi,
             M=ecoeff.M, beta=ecoeff.beta)


def load_element_coeffs(path: str) -> ElementCoeffs:
    with np.load(path) as z:
        return ElementCoeffs(freqs=z["freqs"], theta=z["theta"],
                             phi=z["phi"], M=int(z["M"]),
                             beta=float(z["beta"]))


def element_pattern_at(ecoeff: ElementCoeffs, freq_hz: float):
    """The pattern vectors at ``freq_hz``: a linear blend of the two
    bracketing table rows, clamped at the ends (elementbeam.c:80-103)."""
    f = ecoeff.freqs
    if freq_hz <= f[0]:
        return ecoeff.theta[0].copy(), ecoeff.phi[0].copy()
    if freq_hz >= f[-1]:
        return ecoeff.theta[-1].copy(), ecoeff.phi[-1].copy()
    ih = int(np.searchsorted(f, freq_hz))
    il = ih - 1
    wl = freq_hz - f[il]
    wh = f[ih] - freq_hz
    w1 = wl / (wl + wh)
    th = (1.0 - w1) * ecoeff.theta[il] + w1 * ecoeff.theta[ih]
    ph = (1.0 - w1) * ecoeff.phi[il] + w1 * ecoeff.phi[ih]
    return th, ph


# ---------------------------------------------------------------------------
# beam geometry: host metadata, device tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BeamInfo:
    """Host station and beam metadata (readAuxData with the beam,
    data.cpp:194): station longitude/latitude, element offsets, times."""

    longitude: np.ndarray        # [N] rad
    latitude: np.ndarray         # [N] rad
    time_jd: np.ndarray          # [T] JD (days)
    ra0: float                   # beam pointing (rad)
    dec0: float
    freq0: float                 # beamformer reference frequency (Hz)
    elem_xyz: np.ndarray         # [N, Emax, 3] element positions (m)
    elem_mask: np.ndarray        # [N, Emax] bool
    ecoeff: ElementCoeffs | None = None


class BeamArrays(NamedTuple):
    """The beam model as tensors on one device (the JAX pytree)."""

    longitude: torch.Tensor      # [N]
    latitude: torch.Tensor       # [N]
    gmst: torch.Tensor           # [T] degrees (or [Tb, T] for a batch)
    ra0: torch.Tensor
    dec0: torch.Tensor
    freq0: torch.Tensor
    elem_xyz: torch.Tensor       # [N, Emax, 3]
    elem_mask: torch.Tensor      # [N, Emax] bool
    n_elem: torch.Tensor         # [N]
    patt_theta: torch.Tensor     # [Nmodes, 2] re/im at the data's freq0
    patt_phi: torch.Tensor
    elem_beta: torch.Tensor


def beam_to_device(info: BeamInfo, data_freq0: float | None = None,
                   real_dtype=torch.float32, time_jd=None,
                   device="cpu") -> BeamArrays:
    """Beam metadata -> :class:`BeamArrays` on ``device`` in
    ``real_dtype``. The element pattern is interpolated once at the
    data's reference frequency (fullbatch_mode.cpp:70); ``time_jd``
    replaces the stored times (per-tile staging). GMST is computed on
    the host in float64 (:func:`coords.jd2gmst_np`)."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                  device=device).to(real_dtype)
    f0ref = data_freq0 or info.freq0
    ecoeff = info.ecoeff or default_element_coeffs(band_for_freq(f0ref))
    th, ph = element_pattern_at(ecoeff, f0ref)
    th = np.stack([th.real, th.imag], axis=-1)
    ph = np.stack([ph.real, ph.imag], axis=-1)
    gmst = coords.jd2gmst_np(info.time_jd if time_jd is None else time_jd)
    mask = np.asarray(info.elem_mask, bool)
    return BeamArrays(
        longitude=f(info.longitude), latitude=f(info.latitude),
        gmst=f(gmst), ra0=f(info.ra0), dec0=f(info.dec0),
        freq0=f(info.freq0), elem_xyz=f(info.elem_xyz),
        elem_mask=torch.as_tensor(mask, device=device),
        n_elem=f(mask.sum(axis=1)), patt_theta=f(th), patt_phi=f(ph),
        elem_beta=f(ecoeff.beta))


def synthetic_beam(n_stations: int, time_jd, ra0: float, dec0: float,
                   freq0: float, n_elem: int = 24, extent_m: float = 30.0,
                   band: str = "lba", seed: int = 5,
                   ecoeff: ElementCoeffs | None = None) -> BeamInfo:
    """LOFAR-like synthetic beam metadata: stations near the LOFAR core,
    elements on a horizontal disc, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    lon0, lat0 = 0.12, 0.92   # ~LOFAR core (rad)
    longitude = lon0 + 1e-4 * rng.normal(size=n_stations)
    latitude = lat0 + 1e-4 * rng.normal(size=n_stations)
    r = extent_m * np.sqrt(rng.random((n_stations, n_elem)))
    th = 2 * np.pi * rng.random((n_stations, n_elem))
    elem = np.stack([r * np.cos(th), r * np.sin(th), np.zeros_like(r)],
                    axis=-1)
    mask = np.ones((n_stations, n_elem), bool)
    return BeamInfo(longitude=longitude, latitude=latitude,
                    time_jd=np.atleast_1d(np.asarray(time_jd, float)),
                    ra0=ra0, dec0=dec0, freq0=freq0, elem_xyz=elem,
                    elem_mask=mask,
                    ecoeff=ecoeff or default_element_coeffs(band))


def band_for_freq(freq_hz: float) -> str:
    """LBA below the ~100 MHz FM gap, HBA above."""
    return "lba" if freq_hz < 105e6 else "hba"


def resolve_beaminfo(dobeam: int, ms, meta: dict, log=print):
    """A dataset's beam metadata: its stored ``beam.npz``, else a
    synthetic layout, with a warning (a made-up array serves simulation
    and tests, not instrument data)."""
    if not dobeam:
        return None
    info = ms.beam_info()
    if info is None:
        log("WARNING: beam enabled (-B) but the dataset stores no beam "
            "metadata (beam.npz); using a SYNTHETIC station/element "
            "layout — solutions will not correspond to a real instrument")
        info = synthetic_beam(
            meta["n_stations"], np.array([2451545.0]), meta["ra0"],
            meta["dec0"], meta["freq0"], band=band_for_freq(meta["freq0"]))
    return info


def save_beaminfo(path: str, info: BeamInfo) -> None:
    """Beam metadata beside a dataset (the SimMS counterpart of the MS's
    LOFAR_ANTENNA_FIELD subtable); the JAX package's keys."""
    ec = info.ecoeff or default_element_coeffs(band_for_freq(info.freq0))
    np.savez(path, longitude=info.longitude, latitude=info.latitude,
             time_jd=info.time_jd, ra0=info.ra0, dec0=info.dec0,
             freq0=info.freq0, elem_xyz=info.elem_xyz,
             elem_mask=info.elem_mask, ec_freqs=ec.freqs, ec_theta=ec.theta,
             ec_phi=ec.phi, ec_M=ec.M, ec_beta=ec.beta)


def load_beaminfo(path: str) -> BeamInfo:
    with np.load(path) as z:
        ec = ElementCoeffs(freqs=z["ec_freqs"], theta=z["ec_theta"],
                           phi=z["ec_phi"], M=int(z["ec_M"]),
                           beta=float(z["ec_beta"]))
        return BeamInfo(longitude=z["longitude"], latitude=z["latitude"],
                        time_jd=z["time_jd"], ra0=float(z["ra0"]),
                        dec0=float(z["dec0"]), freq0=float(z["freq0"]),
                        elem_xyz=z["elem_xyz"], elem_mask=z["elem_mask"],
                        ecoeff=ec)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _direction_components(az, el):
    """(sin t cos p, sin t sin p, cos t) with t = pi/2 - el, p = -az
    (stationbeam.c:63-67)."""
    theta = math.pi / 2 - el
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(-az), torch.cos(-az)
    return st * cp, st * sp, ct


def _azel(beam: BeamArrays, ra, dec):
    """(az, el) [S, T, N] of directions (ra, dec) [S]."""
    return coords.radec2azel_gmst(
        ra[:, None, None], dec[:, None, None],
        beam.longitude[None, None, :], beam.latitude[None, None, :],
        beam.gmst[None, :, None])


def array_factor(beam: BeamArrays, ra, dec, freq):
    """Array-factor gains [S, T, N] toward (ra, dec) [S] at one
    frequency (arraybeam, stationbeam.c:44-110)."""
    az, el = _azel(beam, ra, dec)
    az0, el0 = coords.radec2azel_gmst(
        beam.ra0, beam.dec0, beam.longitude[None, None, :],
        beam.latitude[None, None, :], beam.gmst[None, :, None])
    sx, sy, sz = _direction_components(az, el)
    s0x, s0y, s0z = _direction_components(az0, el0)
    freq = torch.as_tensor(freq, dtype=ra.dtype, device=ra.device)
    r1 = beam.freq0 * s0x - freq * sx                   # [S, T, N]
    r2 = beam.freq0 * s0y - freq * sy
    r3 = beam.freq0 * s0z - freq * sz
    tpc = 2.0 * math.pi / C_M_S
    xyz = beam.elem_xyz[None, None]                     # [1, 1, N, E, 3]
    ph = -tpc * (r1[..., None] * xyz[..., 0] + r2[..., None] * xyz[..., 1]
                 + r3[..., None] * xyz[..., 2])         # [S, T, N, E]
    m = beam.elem_mask[None, None]
    zero = torch.zeros((), dtype=ph.dtype, device=ph.device)
    cs = torch.sum(torch.where(m, torch.cos(ph), zero), dim=-1)
    sn = torch.sum(torch.where(m, torch.sin(ph), zero), dim=-1)
    gain = torch.sqrt(cs * cs + sn * sn) / beam.n_elem[None, None, :]
    return torch.where(el >= 0.0, gain, zero)


def element_jones(beam: BeamArrays, ra, dec):
    """Element Jones [S, T, N, 2, 2] complex toward (ra, dec) [S]
    (element_beam, stationbeam.c:215-260); zero below the horizon."""
    az, el = _azel(beam, ra, dec)
    zd = math.pi / 2 - el
    M = int(round((math.isqrt(8 * beam.patt_theta.shape[0] + 1) - 1) / 2))
    bx = element_basis(zd, az - math.pi / 4, M, beam.elem_beta)
    by = element_basis(zd, az + math.pi / 4, M, beam.elem_beta)
    patt_t = torch.complex(beam.patt_theta[:, 0], beam.patt_theta[:, 1])
    patt_p = torch.complex(beam.patt_phi[:, 0], beam.patt_phi[:, 1])
    ex_t = torch.sum(bx * patt_t, dim=-1)
    ex_p = torch.sum(bx * patt_p, dim=-1)
    ey_t = torch.sum(by * patt_t, dim=-1)
    ey_p = torch.sum(by * patt_p, dim=-1)
    E = torch.stack([torch.stack([ex_t, ex_p], -1),
                     torch.stack([ey_t, ey_p], -1)], -2)
    return torch.where((el >= 0.0)[..., None, None], E,
                       torch.zeros_like(E))


def cluster_beam(beam: BeamArrays, ra_s, dec_s, freqs, dobeam: int):
    """A cluster's beam tables (af [F, S, T, N] or None, E [S, T, N, 2,
    2] or None): the reference's ``beamgain``/``elementgain`` precompute
    (predict_withbeam.c:476-510). ``freqs`` the host channel list."""
    af = E = None
    if dobeam in (DOBEAM_ARRAY, DOBEAM_FULL):
        af = torch.stack([array_factor(beam, ra_s, dec_s, float(f))
                          for f in np.atleast_1d(np.asarray(freqs))])
    if dobeam in (DOBEAM_ELEMENT, DOBEAM_FULL):
        E = element_jones(beam, ra_s, dec_s)
    return af, E
