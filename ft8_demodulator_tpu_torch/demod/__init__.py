"""RX demodulation: the slot decoders, the host API and result types."""

from .decode import (SlotDecoder, decode_ft8_message, decode_slot,
                     decode_slots, decode_waterfall, estimate_snr,
                     finish_decode)
from .types import FT8Decode, FT8DecodeStatus, FT8Message, SlotDecodeResult

__all__ = [
    "SlotDecoder",
    "decode_ft8_message",
    "estimate_snr",
    "decode_slot",
    "decode_slots",
    "decode_waterfall",
    "finish_decode",
    "FT8Decode",
    "FT8DecodeStatus",
    "FT8Message",
    "SlotDecodeResult",
]
