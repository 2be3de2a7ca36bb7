"""Celestial coordinate transforms (port of ``sagecal_tpu/coords.py``).

Reference ``src/lib/Radio/transforms.c`` (xyz2llh:35, radec2azel:103,
jd2gmst:138, radec2azel_gmst:156, precession:202): WGS84 geodesy,
Vallado LST/az-el and the Capitaine et al. 2003 four-angle precession,
array at a time on tensors. Every function takes tensors (or Python
floats, where the JAX function takes scalars) and keeps their dtype and
device; :func:`jd2gmst_np` is the host's float64 GMST, because Julian
dates (~2.45e6 days) lose whole hours of sidereal angle in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ASEC2RAD = 4.848136811095359935899141e-6  # arcseconds -> radians
_J2000_JD = 2451545.0


def _t(x, like=None):
    """``x`` as a tensor (a Python or numpy scalar takes float64, or the
    dtype and device of ``like``)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(x, np.float64))


def xyz2llh(x, y, z):
    """ITRF Cartesian (m) -> geodetic (longitude, latitude, height) on
    WGS84, Bowring's closed form (transforms.c:35)."""
    x, y, z = _t(x), _t(y), _t(z)
    a = 6378137.0
    f = 1.0 / 298.257223563
    b = (1.0 - f) * a
    e2 = 2 * f - f * f
    ep2 = (a * a - b * b) / (b * b)
    p = torch.sqrt(x * x + y * y)
    lon = torch.atan2(y, x)
    theta = torch.atan(z * a / (p * b))
    st, ct = torch.sin(theta), torch.cos(theta)
    lat = torch.atan((z + ep2 * b * st ** 3) / (p - e2 * a * ct ** 3))
    slat, clat = torch.sin(lat), torch.cos(lat)
    r = a / torch.sqrt(1.0 - e2 * slat * slat)
    height = p / clat - r
    return lon, lat, height


def jd2gmst(time_jd):
    """Julian date (UT1) -> Greenwich mean sidereal angle in DEGREES: the
    truncated series of transforms.c:138, with its sign carried through
    the day-seconds modulus."""
    time_jd = _t(time_jd)
    t = (time_jd - _J2000_JD) / 36525.0
    theta = 67310.54841 + t * (
        (876600.0 * 3600.0 + 8640184.812866) + t * (0.093104 - 6.2e-5 * t))
    theta = torch.where(theta < 0, -torch.remainder(torch.abs(theta),
                                                    86400.0),
                        torch.remainder(theta, 86400.0))
    return torch.remainder(theta / 240.0, 360.0)


def jd2gmst_np(time_jd):
    """Host-side float64 GMST (degrees)."""
    time_jd = np.asarray(time_jd, np.float64)
    t = (time_jd - _J2000_JD) / 36525.0
    theta = 67310.54841 + t * (
        (876600.0 * 3600.0 + 8640184.812866) + t * (0.093104 - 6.2e-5 * t))
    theta = np.where(theta < 0, -(np.abs(theta) % 86400.0), theta % 86400.0)
    return (theta / 240.0) % 360.0


def radec2azel_gmst(ra, dec, longitude, latitude, theta_gmst_deg):
    """(ra, dec) [rad] -> (az, el) [rad] at a GMST angle in degrees
    (transforms.c:156, Vallado Algorithm 28). Arguments broadcast."""
    like = next((a for a in (ra, dec, longitude, latitude, theta_gmst_deg)
                 if isinstance(a, torch.Tensor)), None)
    ra, dec, longitude, latitude, theta_gmst_deg = (
        _t(a, like) for a in (ra, dec, longitude, latitude,
                              theta_gmst_deg))
    theta_lst = theta_gmst_deg + longitude * 180.0 / math.pi
    lha = torch.deg2rad(torch.remainder(theta_lst - ra * 180.0 / math.pi,
                                        360.0))
    slat, clat = torch.sin(latitude), torch.cos(latitude)
    sdec, cdec = torch.sin(dec), torch.cos(dec)
    slha, clha = torch.sin(lha), torch.cos(lha)
    el = torch.asin(slat * sdec + clat * cdec * clha)
    sel, cel = torch.sin(el), torch.cos(el)
    az = torch.atan2(-slha * cdec / cel, (sdec - sel * slat) / (cel * clat))
    az = torch.remainder(az, 2.0 * math.pi)
    return az, el


def radec2azel(ra, dec, longitude, latitude, time_jd):
    """(ra, dec) -> (az, el) at a Julian date (transforms.c:103)."""
    return radec2azel_gmst(ra, dec, longitude, latitude, jd2gmst(time_jd))


def precession_matrix(jd_tdb, dtype=torch.float64, device="cpu"):
    """J2000 -> mean equator and equinox of date, Capitaine et al. 2003
    (transforms.c:202 ``get_precession_params``): a 3x3 rotation tensor
    of ``dtype`` (the date's polynomial in float64 on the host, as the
    JAX function evaluates it from a Python float)."""
    t = (float(jd_tdb) - _J2000_JD) / 36525.0
    eps0_as = 84381.406
    psia = ((((-0.0000000951 * t + 0.000132851) * t - 0.00114045) * t
             - 1.0790069) * t + 5038.481507) * t
    omegaa = ((((0.0000003337 * t - 0.000000467) * t - 0.00772503) * t
               + 0.0512623) * t - 0.025754) * t + eps0_as
    chia = ((((-0.0000000560 * t + 0.000170663) * t - 0.00121197) * t
             - 2.3814292) * t + 10.556403) * t
    eps0 = eps0_as * ASEC2RAD
    psia, omegaa, chia = psia * ASEC2RAD, omegaa * ASEC2RAD, chia * ASEC2RAD
    sa, ca = math.sin(eps0), math.cos(eps0)
    sb, cb = math.sin(-psia), math.cos(-psia)
    sc, cc = math.sin(-omegaa), math.cos(-omegaa)
    sd, cd = math.sin(chia), math.cos(chia)
    # R3(chi_a) R1(-omega_a) R3(-psi_a) R1(eps_0), row-major 3x3
    return torch.tensor([
        [cd * cb - sb * sd * cc,
         cd * sb * ca + sd * cc * cb * ca - sa * sd * sc,
         cd * sb * sa + sd * cc * cb * sa + ca * sd * sc],
        [-sd * cb - sb * cd * cc,
         -sd * sb * ca + cd * cc * cb * ca - sa * cd * sc,
         -sd * sb * sa + cd * cc * cb * sa + ca * cd * sc],
        [sb * sc, -sc * cb * ca - sa * cc, -sc * cb * sa + cc * ca],
    ], dtype=dtype, device=device)


def precess_radec_std(ra0, dec0, pmat):
    """Precess (ra, dec) from J2000 by ``pmat`` (:func:`precession_matrix`)
    in the standard spherical convention: the production path
    ``precess_source_locations`` (data.cpp:1473), which the pipeline
    calls once a run under the beam (fullbatch_mode.cpp:325)."""
    ra0, dec0 = _t(ra0, pmat), _t(dec0, pmat)
    pos1 = torch.stack([torch.cos(ra0) * torch.cos(dec0),
                        torch.sin(ra0) * torch.cos(dec0),
                        torch.sin(dec0) * torch.ones_like(ra0)])
    pos2 = torch.einsum("ij,j...->i...", pmat.to(pos1.dtype), pos1)
    ra = torch.atan2(pos2[1], pos2[0])
    dec = torch.asin(torch.clamp(pos2[2], -1.0, 1.0))
    return ra, dec


def precess_radec(ra0, dec0, pmat):
    """Precess (ra, dec) from J2000 in the reference's colatitude-style
    convention (transforms.c:266-289, the ``precession`` path); the
    production code uses :func:`precess_radec_std`."""
    ra0, dec0 = _t(ra0, pmat), _t(dec0, pmat)
    pos1 = torch.stack([torch.cos(ra0) * torch.sin(dec0),
                        torch.sin(ra0) * torch.sin(dec0),
                        torch.cos(dec0) * torch.ones_like(ra0)])
    pos2 = pmat.to(pos1.dtype) @ pos1
    ra = torch.atan2(pos2[1], pos2[0])
    dec = torch.atan(torch.sqrt(pos2[0] ** 2 + pos2[1] ** 2) / pos2[2])
    return ra, dec


def radec_to_lmn(ra, dec, ra0, dec0):
    """Direction cosines relative to the phase centre (ra0, dec0), the
    sign convention of readsky.c:341-342 (``nn`` carries the -1)."""
    like = next((a for a in (ra, dec, ra0, dec0)
                 if isinstance(a, torch.Tensor)), None)
    ra, dec, ra0, dec0 = (_t(a, like) for a in (ra, dec, ra0, dec0))
    ll = torch.cos(dec) * torch.sin(ra - ra0)
    mm = torch.sin(dec) * torch.cos(dec0) \
        - torch.cos(dec) * torch.sin(dec0) * torch.cos(ra - ra0)
    nn = torch.sqrt(torch.clamp(1.0 - ll * ll - mm * mm, min=0.0)) - 1.0
    return ll, mm, nn
