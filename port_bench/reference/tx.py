"""The benchmark's frozen FT8 transmitter: payload bytes -> tones -> audio.

Independent of the program: the traffic is made here, so a later change to
the program's own TX cannot change what the benchmark sends.

* :func:`encode_tones`: (..., 10) payload bytes -> (..., 79) tone ids
  (77-bit payload, CRC-14, LDPC(174,91) parity, Gray map, three Costas
  arrays), one GF(2) product with ``ENCODE_MATRIX``.
* :func:`passband`: tone ids and carriers -> real GFSK audio (BT 2, the
  WSJT-X pulse alignment, raised-cosine ramps over sps/8 samples), the
  phase accumulated in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C

__all__ = ["encode_tones", "passband"]

_GFSK_BT = 2.0


def encode_tones(payload: torch.Tensor) -> torch.Tensor:
    """(..., 10) uint8 payload bytes -> (..., 79) int64 tone ids.  The low 3
    bits of byte 9 lie outside the 77-bit payload and are ignored."""
    dev = payload.device
    shifts = torch.arange(7, -1, -1, device=dev)
    bits = ((payload.to(torch.int64)[..., None] >> shifts) & 1)
    bits = bits.reshape(*payload.shape[:-1], 80)[..., : C.PAYLOAD_BITS]
    enc = torch.as_tensor(C.ENCODE_MATRIX, dtype=torch.int64, device=dev)
    codeword = (bits[..., None, :] * enc).sum(-1) % 2            # (..., 174)
    groups = codeword.reshape(*codeword.shape[:-1], C.NUM_DATA_SYMBOLS, 3)
    vals = groups[..., 0] * 4 + groups[..., 1] * 2 + groups[..., 2]
    gray = torch.as_tensor(C.GRAY_MAP, dtype=torch.int64, device=dev)
    data = gray[vals]                                            # (..., 58)
    idx = torch.as_tensor(np.maximum(C.FRAME_DATA_INDEX, 0), device=dev)
    costas = torch.as_tensor(C.FRAME_COSTAS_TONE, dtype=torch.int64,
                             device=dev)
    return torch.where(torch.as_tensor(C.FRAME_IS_COSTAS, device=dev),
                       costas, data[..., idx])


def _pulse(sps: int, device) -> torch.Tensor:
    """(3, sps) Gaussian frequency pulse, cut into its three symbol-length
    segments: 0.5 (erf(k bt (t + 1/2)) - erf(k bt (t - 1/2))), k =
    pi sqrt(2 / ln 2)."""
    k = np.pi * np.sqrt(2.0 / np.log(2.0)) * _GFSK_BT
    t = (torch.arange(3 * sps, dtype=torch.float64, device=device)
         - 1.5 * sps) / sps
    g = 0.5 * (torch.special.erf(k * (t + 0.5))
               - torch.special.erf(k * (t - 0.5)))
    return g.reshape(3, sps)


def passband(tones: torch.Tensor, f0_hz: torch.Tensor, fs: float,
             sps: int) -> torch.Tensor:
    """(S, 79) tone ids, (S,) carriers in Hz -> (S, 79 sps) float32 real
    GFSK audio of unit amplitude, sin of the accumulated phase."""
    dev = tones.device
    w0, w1, w2 = _pulse(sps, dev)
    t = tones.to(torch.float64)
    te = torch.cat([t[:, :1], t, t[:, -1:]], dim=-1)              # (S, 81)
    track = (te[:, 0:79, None] * w2 + te[:, 1:80, None] * w1
             + te[:, 2:81, None] * w0).reshape(t.shape[0], -1)
    inc = (f0_hz.to(torch.float64)[:, None]
           + track * C.TONE_SPACING_HZ) / fs              # cycles / sample
    cycles = torch.cumsum(inc, dim=-1) - inc                      # exclusive
    wave = torch.sin(2.0 * np.pi * torch.remainder(cycles, 1.0))
    n = wave.shape[-1]
    nramp = sps // 8
    i = torch.arange(n, dtype=torch.float64, device=dev)
    ramp = torch.ones_like(i)
    ramp = torch.where(i < nramp, 0.5 * (1.0 - torch.cos(8.0 * np.pi * i / sps)),
                       ramp)
    ramp = torch.where(i >= n - nramp,
                       0.5 * (1.0 + torch.cos(8.0 * np.pi * (n - 1 - i) / sps)),
                       ramp)
    return (wave * ramp).to(torch.float32)
