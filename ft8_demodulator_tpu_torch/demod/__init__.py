"""RX demodulation: the STANDARD slot decoder and result types."""

from .decode import SlotDecoder, decode_slot, decode_slots, finish_decode
from .types import FT8Decode, FT8DecodeStatus, FT8Message, SlotDecodeResult

__all__ = [
    "SlotDecoder",
    "decode_slot",
    "decode_slots",
    "finish_decode",
    "FT8Decode",
    "FT8DecodeStatus",
    "FT8Message",
    "SlotDecodeResult",
]
