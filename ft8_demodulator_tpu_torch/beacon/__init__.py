"""Beacon receiver: drift detection and correction, known-payload detection
and coherent tracking."""

from .detect import (KnownDetection, TrackFix, detect_known_payload,
                     known_track_scores, track_known_payload)
from .drift import (apply_polynomial_drift, correct_frequency_drift,
                    detect_signal_continuity)

__all__ = ["apply_polynomial_drift", "correct_frequency_drift",
           "detect_signal_continuity", "KnownDetection", "TrackFix",
           "detect_known_payload", "known_track_scores",
           "track_known_payload"]
