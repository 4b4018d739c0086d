"""LEO satellite channel: pass geometry, Doppler, ground-track utilities.

API-compatible redesign of the reference's Channel/GroundStation
(src/ft8_tools/channel/channel.py:19,34) on top of the in-repo SGP4
propagator and geodesy module (the sgp4/pymap3d/skyfield/folium dependencies
do not exist here).  The hot path — per-audio-sample Doppler sequences, 10^6
scalar SGP4 calls in the reference (channel.py:254-309) — is fully
vectorised: one batched propagation over the whole time grid.

Orbit propagation stays host-side NumPy by design (SURVEY §7.8); the Doppler
*application* to signals lives in channel.doppler
(float64 host-side phase + device rotate — see that module's docstring).

A copy of ``ft8_demodulator_tpu/channel/channel.py`` with the same names and
behaviour, so that the port loads nothing of the JAX package
(``tests/test_torch_channel.py`` holds the two equal).
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from . import geodesy as geo
from .sgp4 import Sgp4, parse_tle

__all__ = ["GroundStation", "Channel", "SPEED_OF_LIGHT"]

SPEED_OF_LIGHT = 299792458.0


class GroundStation:
    """A named geodetic position (API parity: channel.py:19)."""

    def __init__(self, name: str, latitude_deg: float, longitude_deg: float,
                 altitude_m: float):
        self.name = name
        self.latitude_deg = latitude_deg
        self.longitude_deg = longitude_deg
        self.altitude_m = altitude_m

    def get_ground_station_position_ecef(self, timestamp=None) -> np.ndarray:
        return geo.geodetic2ecef(self.latitude_deg, self.longitude_deg,
                                 self.altitude_m)

    def get_ground_station_position_eci(
            self, timestamp: datetime.datetime) -> np.ndarray:
        return geo.geodetic2eci(self.latitude_deg, self.longitude_deg,
                                self.altitude_m, geo.datetime_to_jd(timestamp))


class Channel:
    """Satellite-to-ground channel geometry from a TLE."""

    def __init__(self, groundStation: dict, satelliteTLE: dict):
        self.groundStation = GroundStation(
            groundStation["name"], groundStation["latitude_deg"],
            groundStation["longitude_deg"], groundStation["altitude_m"])
        self.satelliteTLE = satelliteTLE
        self.tle = parse_tle(satelliteTLE["TLE_line1"],
                             satelliteTLE["TLE_line2"])
        self.propagator = Sgp4(self.tle)

    # -- propagation helpers -------------------------------------------------

    def _tsince_minutes(self, jd) -> np.ndarray:
        return (np.asarray(jd, np.float64) - self.tle.epoch_jd) * 1440.0

    def _propagate_jd(self, jd):
        """jd (...,) -> (r_eci_km (...,3), v_eci_km_s (...,3))."""
        return self.propagator.propagate(self._tsince_minutes(jd))

    # -- Doppler -------------------------------------------------------------

    def normalized_doppler_by_ecef_jd(self, jd) -> np.ndarray:
        """Vectorised: -v_radial/c in the rotating frame convention of the
        reference (position rotated to ECEF; velocity rotated by GMST only,
        omitting the transport term — channel.py:40-60)."""
        jd = np.asarray(jd, np.float64)
        r, v = self._propagate_jd(jd)
        sat_ecef = geo.eci2ecef(r * 1e3, jd)
        vel_ecef = geo.eci2ecef_velocity(v * 1e3, jd)
        gs_ecef = self.groundStation.get_ground_station_position_ecef()
        los = sat_ecef - gs_ecef
        los_unit = los / np.linalg.norm(los, axis=-1, keepdims=True)
        v_radial = np.sum(los_unit * vel_ecef, axis=-1)
        return -v_radial / SPEED_OF_LIGHT

    def normalized_doppler_by_eci_jd(self, jd) -> np.ndarray:
        """Vectorised ECI-frame variant (channel.py:62-77)."""
        jd = np.asarray(jd, np.float64)
        r, v = self._propagate_jd(jd)
        gs_eci = geo.ecef2eci(
            self.groundStation.get_ground_station_position_ecef(), jd)
        los = r * 1e3 - gs_eci
        los_unit = los / np.linalg.norm(los, axis=-1, keepdims=True)
        v_radial = np.sum(los_unit * (v * 1e3), axis=-1)
        return -v_radial / SPEED_OF_LIGHT

    def calculate_normalized_doppler_frequency_shift_by_ecef(
            self, timestamp: datetime.datetime) -> float:
        return float(self.normalized_doppler_by_ecef_jd(
            geo.datetime_to_jd(timestamp)))

    def calculate_normalized_doppler_frequency_shift_by_eci(
            self, timestamp: datetime.datetime) -> float:
        return float(self.normalized_doppler_by_eci_jd(
            geo.datetime_to_jd(timestamp)))

    # -- elevation / ground track ---------------------------------------------

    def elevation_jd(self, jd) -> np.ndarray:
        jd = np.asarray(jd, np.float64)
        r, _ = self._propagate_jd(jd)
        _, el, _ = geo.eci2aer(r * 1e3, self.groundStation.latitude_deg,
                               self.groundStation.longitude_deg,
                               self.groundStation.altitude_m, jd)
        return el

    def calculate_elevation_groundStation_to_satellite(
            self, timestamp: datetime.datetime) -> float:
        return float(self.elevation_jd(geo.datetime_to_jd(timestamp)))

    def get_satellite_star_point(self, timestamp: datetime.datetime):
        """Sub-satellite geodetic point (lat_deg, lon_deg, alt_m)."""
        jd = geo.datetime_to_jd(timestamp)
        r, _ = self._propagate_jd(jd)
        lat, lon, alt = geo.eci2geodetic(r * 1e3, jd)
        return float(lat), float(lon), float(alt)

    def get_orbital_period(self) -> float:
        """Orbital period in minutes from the TLE mean motion
        (channel.py:97-110)."""
        mean_motion = float(self.satelliteTLE["TLE_line2"][52:63])
        return 24.0 * 60.0 / mean_motion

    # -- pass prediction -------------------------------------------------------

    def satellite_overhead_time_prediction(
            self, start_time: datetime.datetime,
            end_time: datetime.datetime,
            elevation_threshold_deg: float) -> list:
        """All passes above the elevation threshold in [start, end).

        Returns [(t_enter, duration_timedelta, max_elevation_deg), ...]
        sorted by max elevation descending (channel.py:112-150), found by a
        vectorised 1-minute scan refined on a 1-second grid — not the
        reference's per-second Python walk.
        """
        jd0 = float(geo.datetime_to_jd(start_time))
        total_min = (end_time - start_time).total_seconds() / 60.0
        if total_min <= 0:
            return []
        minutes = np.arange(0.0, total_min + 1.0)
        coarse = self.elevation_jd(jd0 + minutes / 1440.0)
        above = coarse > elevation_threshold_deg

        candidates = []
        i = 0
        while i < len(minutes):
            if not above[i]:
                i += 1
                continue
            # refine this pass on a 1 s grid, expanding one minute both ways
            lo = max(0.0, minutes[i] - 2.0)
            j = i
            while j + 1 < len(minutes) and above[j + 1]:
                j += 1
            hi = min(total_min, minutes[j] + 2.0)
            secs = np.arange(lo * 60.0, hi * 60.0 + 1.0)
            el = self.elevation_jd(jd0 + secs / 86400.0)
            mask = el > elevation_threshold_deg
            if mask.any():
                first = int(np.argmax(mask))
                last = int(len(mask) - 1 - np.argmax(mask[::-1]))
                t_enter = start_time + datetime.timedelta(
                    seconds=float(secs[first]))
                duration = datetime.timedelta(
                    seconds=float(secs[last] - secs[first]))
                candidates.append(
                    (t_enter, duration, float(el[first:last + 1].max())))
            i = j + 1
        candidates.sort(key=lambda c: c[2], reverse=True)
        return candidates

    # -- Doppler sequences ------------------------------------------------------

    def get_doppler_frequency_shift_sequence(
            self, start_time: datetime.datetime, signal_time_s: float,
            fs_Hz: int, fc_Hz: float, save_path: str | None = None
    ) -> np.ndarray:
        """Doppler shift (Hz) at every audio sample — one vectorised call.

        Replaces the reference's 10^6-iteration per-sample loop
        (channel.py:254-309).  Also computes the linear regression the
        downstream compensation stages consume, and saves the same artifact
        set (npy + info txt) when save_path is given.
        """
        from scipy import stats

        num_samples = int(signal_time_s * fs_Hz)
        jd0 = float(geo.datetime_to_jd(start_time))
        jd = jd0 + np.arange(num_samples) / fs_Hz / 86400.0
        doppler = self.normalized_doppler_by_ecef_jd(jd) * fc_Hz

        x = np.arange(num_samples)
        slope, intercept, r_value, p_value, std_err = stats.linregress(
            x, doppler)

        if save_path is not None:
            os.makedirs(save_path, exist_ok=True)
            np.save(os.path.join(save_path, "doppler_frequency_shift.npy"),
                    doppler)
            with open(os.path.join(save_path,
                                   "doppler_frequency_shift_info.txt"),
                      "w") as f:
                f.write("Doppler Frequency Shift Info\n")
                f.write("----------------------------------\n")
                f.write("Parameters\n")
                f.write(f"Start Time: {start_time}\n")
                f.write(f"Signal Time(s): {signal_time_s}\n")
                f.write(f"fs_Hz: {fs_Hz}\n")
                f.write(f"fc_Hz: {fc_Hz}\n")
                f.write("----------------------------------\n")
                f.write("Linear Regression Info\n")
                f.write(f"Slope: {slope}\n")
                f.write(f"Intercept: {intercept}\n")
                f.write(f"R-squared: {r_value}\n")
                f.write(f"P-value: {p_value}\n")
                f.write(f"Standard Error: {std_err}\n")
        return doppler

    # -- reporting / maps ---------------------------------------------------------

    def get_overhead_prediction_candidate_info(
            self, start_time: datetime.datetime,
            duration: datetime.timedelta, is_save_fig: bool = False,
            save_fig_path: str | None = None):
        """Per-second Doppler + elevation series for one pass; optionally
        writes the same info artifact as the reference (channel.py:191-252).
        Returns (normalized_doppler_seq, elevation_seq)."""
        n = int(duration.total_seconds())
        jd0 = float(geo.datetime_to_jd(start_time))
        jd = jd0 + np.arange(n) / 86400.0
        doppler = self.normalized_doppler_by_ecef_jd(jd)
        elevation = self.elevation_jd(jd)

        if is_save_fig and save_fig_path:
            os.makedirs(save_fig_path, exist_ok=True)
            with open(os.path.join(save_fig_path,
                                   "overhead_prediction_candidate_info.txt"),
                      "w") as f:
                f.write("Overhead Prediction Candidate Info\n")
                f.write("----------------------------------\n")
                f.write("Satellite Info\n")
                f.write(f"Satellite Name: {self.satelliteTLE['name']}\n")
                f.write(f"Satellite TLE Line 1: "
                        f"{self.satelliteTLE['TLE_line1']}\n")
                f.write(f"Satellite TLE Line 2: "
                        f"{self.satelliteTLE['TLE_line2']}\n")
                f.write("----------------------------------\n")
                f.write("Ground Station Info\n")
                f.write(f"Ground Station Name: {self.groundStation.name}\n")
                f.write(f"Ground Station Latitude: "
                        f"{self.groundStation.latitude_deg}\n")
                f.write(f"Ground Station Longitude: "
                        f"{self.groundStation.longitude_deg}\n")
                f.write(f"Ground Station Altitude: "
                        f"{self.groundStation.altitude_m}\n")
                f.write("----------------------------------\n")
                f.write("Overhead Prediction Candidate Info\n")
                f.write(f"Start Time: {start_time}\n")
                f.write(f"Duration: {duration}\n")
            self.get_satellite_star_point_map(
                start_time, n, datetime.timedelta(seconds=1),
                is_save_fig=True, save_fig_path=save_fig_path)
        return doppler, elevation

    def get_satellite_star_point_map(
            self, start_time: datetime.datetime, num_samples: int,
            delta_t: datetime.timedelta, max_num_draw_points: int = 100,
            is_save_fig: bool = False, save_fig_path: str | None = None):
        """Ground-track map.  folium is not available in this image, so the
        fallback writes a dependency-free SVG-in-HTML ground track with the
        station marked (same artifact name as the reference)."""
        jd0 = float(geo.datetime_to_jd(start_time))
        step_days = delta_t.total_seconds() / 86400.0
        jd = jd0 + np.arange(num_samples) * step_days
        r, _ = self._propagate_jd(jd)
        lat, lon, _ = geo.eci2geodetic(r * 1e3, jd)

        stride = max(1, num_samples // max_num_draw_points)
        pts = list(zip(lat[::stride], lon[::stride]))

        if is_save_fig and save_fig_path:
            os.makedirs(save_fig_path, exist_ok=True)
            path = os.path.join(save_fig_path, "satellite_star_point_map.html")
            with open(path, "w") as f:
                f.write(_ground_track_html(
                    pts, (self.groundStation.latitude_deg,
                          self.groundStation.longitude_deg)))
        return pts

    # backwards-compatible alias for the reference method name
    get_satellite_star_point_map_by_folium = get_satellite_star_point_map


def _ground_track_html(points, station) -> str:
    """Minimal equirectangular SVG ground-track page (no dependencies)."""
    def xy(lat, lon):
        return (lon + 180.0) / 360.0 * 1000.0, (90.0 - lat) / 180.0 * 500.0

    circles = "\n".join(
        f'<circle cx="{xy(la, lo)[0]:.1f}" cy="{xy(la, lo)[1]:.1f}" '
        f'r="2" fill="blue"/>' for la, lo in points)
    sx, sy = xy(*station)
    return f"""<!DOCTYPE html>
<html><head><title>Satellite ground track</title></head><body>
<svg viewBox="0 0 1000 500" style="width:100%;border:1px solid #888">
  <rect width="1000" height="500" fill="#eef"/>
  <line x1="500" y1="0" x2="500" y2="500" stroke="#ccc"/>
  <line x1="0" y1="250" x2="1000" y2="250" stroke="#ccc"/>
  {circles}
  <circle cx="{sx:.1f}" cy="{sy:.1f}" r="5" fill="red"/>
  <text x="{sx + 8:.1f}" y="{sy:.1f}" font-size="12">ground station</text>
</svg>
<p>Equirectangular ground track; red = ground station, blue = satellite.</p>
</body></html>
"""
