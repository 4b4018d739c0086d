"""Satellite channel: SGP4 propagation, geometry, Doppler ops."""

from .channel import Channel, GroundStation, SPEED_OF_LIGHT
from .doppler import (add_complex_awgn, apply_doppler,
                      apply_doppler_physical,
                      compensate_linear_doppler,
                      compensate_linear_doppler_physical, decimate)
from .sgp4 import TLE, Sgp4, parse_tle

__all__ = [
    "Channel", "GroundStation", "SPEED_OF_LIGHT",
    "TLE", "Sgp4", "parse_tle",
    "apply_doppler", "apply_doppler_physical",
    "compensate_linear_doppler", "compensate_linear_doppler_physical",
    "add_complex_awgn",
    "decimate",
]
