"""FT8 encode path: payload bytes -> CRC -> LDPC codeword -> 79 tone ids.

The whole bit pipeline is linear over GF(2): encode is one integer product
with the (174, 77) matrix ``C.ENCODE_MATRIX``, a mod 2 and a Gray-map
gather.  Every function is batched over leading dimensions and runs on the
device of its input.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .tables import device_table

__all__ = [
    "payload_to_bits",
    "bits_to_payload",
    "crc14",
    "encode_codeword",
    "codeword_to_tones",
    "frame_tones",
    "encode_tones",
    "crc_generator",
    "check_crc",
]


def _gf2_matvec(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(..., n) 0/1 bits times the (m, n) 0/1 matrix, mod 2 -> (..., m).

    Integer arithmetic (exact), as a broadcast multiply-reduce: the card
    has no integer matmul.
    """
    return (bits.unsqueeze(-2) * mat).sum(-1) % 2


def _msb_weights(nbits: int, device) -> torch.Tensor:
    return 2 ** torch.arange(nbits - 1, -1, -1, device=device)


def payload_to_bits(payload: torch.Tensor) -> torch.Tensor:
    """(..., 10) uint8 payload bytes -> (..., 77) int64 bits, MSB first.

    The low 3 bits of byte 9 are outside the 77-bit payload and are ignored.
    """
    payload = payload.to(torch.int64)
    shifts = torch.arange(7, -1, -1, device=payload.device)
    bits = (payload.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*payload.shape[:-1], 80)[..., : C.PAYLOAD_BITS]


def bits_to_payload(bits77: torch.Tensor) -> torch.Tensor:
    """(..., 77) bits -> (..., 10) uint8 bytes, MSB first, 3 zero pad bits."""
    bits80 = torch.nn.functional.pad(bits77.to(torch.int64), (0, 3))
    groups = bits80.reshape(*bits77.shape[:-1], 10, 8)
    return (groups * _msb_weights(8, bits77.device)).sum(-1).to(torch.uint8)


def crc14(bits77: torch.Tensor) -> torch.Tensor:
    """CRC-14 of the 77-bit payload (computed over 82 bits incl. 5 zeros).

    Returns the checksum as an int64 per leading index.
    """
    crc_bits = _gf2_matvec(bits77.to(torch.int64),
                           device_table("CRC_MATRIX_77", bits77.device))
    return (crc_bits * _msb_weights(C.CRC_BITS, bits77.device)).sum(-1)


def encode_codeword(bits77: torch.Tensor) -> torch.Tensor:
    """(..., 77) payload bits -> (..., 174) codeword bits.

    codeword = [payload77 | crc14 | parity83], one GF(2) product.
    """
    return _gf2_matvec(bits77.to(torch.int64),
                       device_table("ENCODE_MATRIX", bits77.device))


def codeword_to_tones(codeword: torch.Tensor) -> torch.Tensor:
    """(..., 174) codeword bits -> (..., 58) Gray-coded 8-FSK tone ids."""
    groups = codeword.reshape(*codeword.shape[:-1], C.NUM_DATA_SYMBOLS, 3)
    vals = groups[..., 0] * 4 + groups[..., 1] * 2 + groups[..., 2]
    return device_table("GRAY_MAP", codeword.device)[vals]


def frame_tones(data_tones: torch.Tensor) -> torch.Tensor:
    """(..., 58) data tones -> (..., 79) frame with 3 Costas blocks."""
    dev = data_tones.device
    data_idx = device_table("FRAME_DATA_INDEX", dev).clamp(min=0)
    gathered = data_tones[..., data_idx]
    return torch.where(device_table("FRAME_IS_COSTAS", dev, torch.bool),
                       device_table("FRAME_COSTAS_TONE", dev), gathered)


def encode_tones(payload: torch.Tensor) -> torch.Tensor:
    """(..., 10) payload bytes -> (..., 79) tone ids (the full TX symbol map)."""
    return frame_tones(codeword_to_tones(encode_codeword(
        payload_to_bits(payload))))


# -- reference-API helpers (host numpy) --------------------------------------

def crc_generator(payload: np.ndarray) -> np.ndarray:
    """payload 10 bytes -> a91 12 bytes = payload77 | crc14 | 5 pad zeros."""
    bits77 = C.bytes_to_bits(np.asarray(payload, dtype=np.uint8),
                             C.PAYLOAD_BITS)
    crc = (C.CRC_MATRIX_77 @ bits77) % 2
    bits96 = np.zeros(96, dtype=np.uint8)
    bits96[: C.PAYLOAD_BITS] = bits77
    bits96[C.PAYLOAD_BITS: C.LDPC_K] = crc
    return C.bits_to_bytes(bits96)


def check_crc(a91: np.ndarray) -> bool:
    """True iff the CRC embedded in a91 matches the payload's CRC."""
    bits = C.bytes_to_bits(np.asarray(a91, dtype=np.uint8), C.LDPC_K)
    crc = (C.CRC_MATRIX_77 @ bits[: C.PAYLOAD_BITS]) % 2
    return bool((crc == bits[C.PAYLOAD_BITS: C.LDPC_K]).all())
