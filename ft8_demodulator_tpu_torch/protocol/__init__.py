"""FT8 protocol layer: constants, GF(2) CRC/LDPC algebra, tone framing."""

from . import constants
from .encode import (codeword_to_tones, crc14, encode_codeword, encode_tones,
                     frame_tones, payload_to_bits)

__all__ = [
    "constants",
    "codeword_to_tones",
    "crc14",
    "encode_codeword",
    "encode_tones",
    "frame_tones",
    "payload_to_bits",
]
