"""Decode result structures.

The decoder returns a fixed-shape NamedTuple of tensors (SlotDecodeResult),
field for field the one of ``ft8_demodulator_tpu/demod/types.py``; the host
records (FT8Message, FT8DecodeStatus, FT8Decode) mirror the reference's
(FT8Message, FT8DecodeStatus, time, freq, score) tuples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


class SlotDecodeResult(NamedTuple):
    """Fixed-shape (K candidates) decode output of one slot; on the device."""

    success: torch.Tensor        # (K,) bool — ldpc ok, crc ok, candidate valid
    payload: torch.Tensor        # (K, 10) uint8 payload bytes
    crc: torch.Tensor            # (K,) int32 — calculated CRC (message hash)
    crc_extracted: torch.Tensor  # (K,) int32 — CRC bits carried in the frame
    ldpc_errors: torch.Tensor    # (K,) int32 — best syndrome weight seen
    abs_time: torch.Tensor       # (K,) int32 waterfall time index (may be <0)
    abs_freq: torch.Tensor       # (K,) int32 waterfall frequency index
    score: torch.Tensor          # (K,) float32 sync score
    candidate_valid: torch.Tensor  # (K,) bool — candidate passed min_score


@dataclass(frozen=True)
class FT8Message:
    """Decoded message payload (API parity with the reference)."""

    payload: bytes              # 10 bytes, 77-bit message MSB-first
    hash: int                   # CRC-14 reused as message hash


@dataclass(frozen=True)
class FT8DecodeStatus:
    """Per-candidate decode status (API parity with the reference)."""

    ldpc_errors: int = 0
    crc_extracted: int = 0
    crc_calculated: int = 0


@dataclass(frozen=True)
class FT8Decode:
    """One decoded message with its sync position."""

    message: FT8Message
    status: FT8DecodeStatus
    time_sec: float             # signal time of the frame start (seconds)
    freq_hz: float              # base tone frequency (Hz)
    score: float                # sync score
    snr_db: float | None = None  # est. SNR re 2500 Hz noise bandwidth
                                 # (WSJT-X convention); None if not computed

    def astuple(self):
        """(message, status, time, freq, score) — the reference's row shape."""
        return (self.message, self.status, self.time_sec, self.freq_hz,
                self.score)
