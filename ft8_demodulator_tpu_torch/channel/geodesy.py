"""Coordinate conversions: geodetic / ECEF / ECI(TEME) / AER.

Self-contained replacements for the pymap3d calls the reference makes
(src/ft8_tools/channel/channel.py:11-14): WGS-84 ellipsoid, Greenwich mean
sidereal time by the Vallado polynomial (the same branch pymap3d uses
without astropy), simple GMST z-rotation between ECI and ECEF.  All
functions are vectorised over leading time axes.

A copy of ``ft8_demodulator_tpu/channel/geodesy.py`` with the same names and
behaviour, so that the port loads nothing of the JAX package
(``tests/test_torch_channel.py`` holds the two equal).
"""

from __future__ import annotations

import datetime
from typing import Iterable

import numpy as np

from .sgp4 import julian_date

__all__ = [
    "WGS84_A", "WGS84_F", "datetime_to_jd", "gmst_rad",
    "geodetic2ecef", "ecef2geodetic", "eci2ecef", "ecef2eci",
    "geodetic2eci", "eci2geodetic", "ecef2enu", "enu2aer", "eci2aer",
    "eci2ecef_velocity",
]

WGS84_A = 6378137.0                 # semi-major axis, m
WGS84_F = 1.0 / 298.257223563       # flattening
_E2 = WGS84_F * (2.0 - WGS84_F)     # first eccentricity squared


def datetime_to_jd(t: datetime.datetime | Iterable) -> np.ndarray:
    """datetime (or iterable of datetimes) -> Julian date (UT), float64."""
    if isinstance(t, datetime.datetime):
        return np.float64(julian_date(
            t.year, t.month, t.day, t.hour, t.minute,
            t.second + t.microsecond / 1e6))
    return np.array([datetime_to_jd(x) for x in t])


def gmst_rad(jd) -> np.ndarray:
    """Greenwich mean sidereal time (rad) — Vallado's polynomial.

    Matches pymap3d.sidereal.datetime2sidereal's non-astropy branch.
    """
    jd = np.asarray(jd, dtype=np.float64)
    tut1 = (jd - 2451545.0) / 36525.0
    gmst_sec = (67310.54841
                + (876600.0 * 3600.0 + 8640184.812866) * tut1
                + 0.093104 * tut1 ** 2
                - 6.2e-6 * tut1 ** 3)
    return np.mod(gmst_sec * (2.0 * np.pi / 86400.0), 2.0 * np.pi)


def geodetic2ecef(lat_deg, lon_deg, alt_m):
    """Geodetic -> ECEF (m)."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt_m, np.float64)
    n = WGS84_A / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def ecef2geodetic(xyz):
    """ECEF (m) -> (lat_deg, lon_deg, alt_m), Bowring's iteration."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - _E2))
    for _ in range(6):
        n = WGS84_A / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - _E2 * n / (n + alt)))
    n = WGS84_A / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return np.rad2deg(lat), np.rad2deg(lon), alt


def _rot_z(theta, vec):
    """Apply R_z(theta) @ vec for broadcastable theta (..., ) x vec (..., 3)."""
    c, s = np.cos(theta), np.sin(theta)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    return np.stack([c * x + s * y, -s * x + c * y, z], axis=-1)


def eci2ecef(r_eci, jd):
    """ECI(TEME) -> ECEF via GMST rotation (positions, m or km)."""
    return _rot_z(gmst_rad(jd), np.asarray(r_eci, np.float64))


def ecef2eci(r_ecef, jd):
    """ECEF -> ECI(TEME) (inverse GMST rotation)."""
    return _rot_z(-gmst_rad(jd), np.asarray(r_ecef, np.float64))


def eci2ecef_velocity(v_eci, jd):
    """Rotate a velocity vector ECI -> ECEF by GMST only.

    Deliberately omits the omega x r transport term to match the reference's
    eci2ecef_velocity (src/ft8_tools/channel/channel.py:311-319) — its
    Doppler fixtures embed this convention.
    """
    return _rot_z(gmst_rad(jd), np.asarray(v_eci, np.float64))


def geodetic2eci(lat_deg, lon_deg, alt_m, jd):
    return ecef2eci(geodetic2ecef(lat_deg, lon_deg, alt_m), jd)


def eci2geodetic(r_eci_m, jd):
    return ecef2geodetic(eci2ecef(r_eci_m, jd))


def ecef2enu(target_ecef, lat_deg, lon_deg, alt_m):
    """ECEF target -> local East-North-Up at the given geodetic origin."""
    origin = geodetic2ecef(lat_deg, lon_deg, alt_m)
    d = np.asarray(target_ecef, np.float64) - origin
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    e = -so * d[..., 0] + co * d[..., 1]
    n = -sl * co * d[..., 0] - sl * so * d[..., 1] + cl * d[..., 2]
    u = cl * co * d[..., 0] + cl * so * d[..., 1] + sl * d[..., 2]
    return np.stack([e, n, u], axis=-1)


def enu2aer(enu):
    """ENU -> (azimuth_deg, elevation_deg, slant_range)."""
    enu = np.asarray(enu, np.float64)
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    r = np.hypot(e, n)
    slant = np.hypot(r, u)
    az = np.mod(np.rad2deg(np.arctan2(e, n)), 360.0)
    el = np.rad2deg(np.arctan2(u, r))
    return az, el, slant


def eci2aer(r_eci_m, lat_deg, lon_deg, alt_m, jd):
    """ECI(TEME) position (m) -> (az_deg, el_deg, range_m) from a station."""
    ecef = eci2ecef(r_eci_m, jd)
    return enu2aer(ecef2enu(ecef, lat_deg, lon_deg, alt_m))
