"""RX demodulation: the slot decoders, the stacked (beacon) decoders and
session, the host API and result types."""

from .beacon_session import BeaconSession
from .decode import (SlotDecoder, decode_ft8_message, decode_slot,
                     decode_slots, decode_waterfall, estimate_snr,
                     finish_decode)
from .stack import decode_ft8_stacked, decode_slot_stacked
from .types import FT8Decode, FT8DecodeStatus, FT8Message, SlotDecodeResult

__all__ = [
    "BeaconSession",
    "SlotDecoder",
    "decode_ft8_message",
    "estimate_snr",
    "decode_ft8_stacked",
    "decode_slot",
    "decode_slots",
    "decode_slot_stacked",
    "decode_waterfall",
    "finish_decode",
    "FT8Decode",
    "FT8DecodeStatus",
    "FT8Message",
    "SlotDecodeResult",
]
