"""FT8 protocol layer: constants, GF(2) CRC/LDPC algebra, tone framing and
the message text codec."""

from . import constants
from .encode import (bits_to_payload, check_crc, codeword_to_tones, crc14,
                     crc_generator, encode_codeword, encode_tones,
                     frame_tones, payload_to_bits)
from .message import (UnsupportedMessageError, ap_hypotheses, hash_callsign,
                      is_standard_callsign, pack_free_text, pack_message,
                      pack_telemetry, remember_callsign, unpack_message)

__all__ = [
    "constants",
    "UnsupportedMessageError",
    "ap_hypotheses",
    "hash_callsign",
    "is_standard_callsign",
    "pack_free_text",
    "pack_message",
    "pack_telemetry",
    "remember_callsign",
    "unpack_message",
    "bits_to_payload",
    "check_crc",
    "codeword_to_tones",
    "crc_generator",
    "crc14",
    "encode_codeword",
    "encode_tones",
    "frame_tones",
    "payload_to_bits",
]
