"""Closed-form circular-orbit geometry model (no TLE required).

Analytic Doppler and pass-duration curves for a circular LEO orbit passing
a ground station — the reference's Test_GeoModel
(src/tests/channel/Test_GeoModel.py:30-33): handy for sanity-checking the
SGP4 chain and for parameter studies without element sets.

A copy of ``ft8_demodulator_tpu/channel/geomodel.py`` with the same names and
behaviour, so that the port loads nothing of the JAX package
(``tests/test_torch_channel.py`` holds the two equal).
"""

from __future__ import annotations

import numpy as np

__all__ = ["CircularOrbitModel"]

_R_EARTH = 6371e3          # mean earth radius, m
_MU = 3.986004418e14       # m^3/s^2
_OMEGA_EARTH = 7.2921159e-5  # rad/s (sidereal)
_C = 299792458.0


class CircularOrbitModel:
    """Satellite in a circular orbit of given altitude passing overhead.

    gamma_t0 is the central angle between station and the orbit track at
    closest approach, parameterised by the maximum elevation alpha_t0.
    """

    def __init__(self, altitude_m: float, max_elevation_deg: float = 90.0,
                 min_elevation_deg: float = 10.0):
        self.r = _R_EARTH + altitude_m
        self.alpha_t0 = np.deg2rad(max_elevation_deg)
        self.alpha_v = np.deg2rad(min_elevation_deg)
        # central angles at max elevation / at the visibility threshold
        self.gamma_t0 = np.arccos(_R_EARTH / self.r
                                  * np.cos(self.alpha_t0)) - self.alpha_t0
        self.gamma_v = np.arccos(_R_EARTH / self.r
                                 * np.cos(self.alpha_v)) - self.alpha_v
        # angular rate of the satellite relative to the rotating earth
        # (equatorial prograde approximation, as the reference uses)
        self.omega_orbit = np.sqrt(_MU / self.r ** 3)
        self.omega_rel = self.omega_orbit - _OMEGA_EARTH

    def pass_duration_s(self, max_elevation_deg: float | None = None) -> float:
        """Visibility window length above the min-elevation threshold."""
        gamma_t0 = self.gamma_t0
        if max_elevation_deg is not None:
            a = np.deg2rad(max_elevation_deg)
            gamma_t0 = np.arccos(_R_EARTH / self.r * np.cos(a)) - a
        return float(2.0 / self.omega_rel
                     * np.arccos(np.cos(self.gamma_v) / np.cos(gamma_t0)))

    def doppler_hz(self, t_s: np.ndarray, fc_hz: float) -> np.ndarray:
        """Doppler shift vs time (t=0 at closest approach).

        f_d = -fc/c * d(range)/dt with range from the spherical triangle
        (reference Test_GeoModel.py:30-33).
        """
        t = np.asarray(t_s, np.float64)
        dphi = self.omega_rel * t
        cg = np.cos(self.gamma_t0)
        rng = np.sqrt(_R_EARTH ** 2 + self.r ** 2
                      - 2.0 * self.r * _R_EARTH * cg * np.cos(dphi))
        ddot = (self.r * _R_EARTH * cg * np.sin(dphi) * self.omega_rel) / rng
        return -fc_hz / _C * ddot
