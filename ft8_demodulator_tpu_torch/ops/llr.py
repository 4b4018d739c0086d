"""Soft-symbol log-likelihood extraction from the time-major dB waterfall.

Port of the Hann path of ``ft8_demodulator_tpu/ops/llr.py``: per candidate,
gather the (58 data symbols x 8 tones) dB window, reorder it through the
Gray map, emit 174 max-of-4 LLRs and normalise each vector to variance 24.
The JAX package routes the reads through one-hot matmuls (a TPU
workaround); here they are index gathers, which select the same cells
exactly.  Out-of-range symbols contribute zero LLRs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..protocol import constants as C

__all__ = ["extract_llrs_tf", "normalize_llrs"]

# Bit b of symbol value j (MSB first) — selects the max-of-4 groups.
_BIT_SET = np.array(
    [[(j >> (2 - b)) & 1 for j in range(8)] for b in range(3)], dtype=bool
)


def _llr_from_powers(s2: torch.Tensor) -> torch.Tensor:
    """(..., 8) Gray-ordered powers -> (..., 3) bit LLRs (max-of-4 contrast)."""
    out = []
    for b in range(3):
        pos = s2[..., np.flatnonzero(_BIT_SET[b])].amax(dim=-1)
        neg = s2[..., np.flatnonzero(~_BIT_SET[b])].amax(dim=-1)
        out.append(pos - neg)
    return torch.stack(out, dim=-1)


def extract_llrs_tf(mag_tf: torch.Tensor, abs_time: torch.Tensor,
                    abs_freq: torch.Tensor, time_osr: int, freq_osr: int,
                    num_blocks: int, gray_map=None) -> torch.Tensor:
    """Waterfall (..., T, F) + candidates (..., K) -> LLRs (..., K, 174).

    abs_time may be negative (pre-roll): time indices are clamped into the
    grid for the gather and the symbols outside the waterfall are masked to
    LLR 0.  ``gray_map``: (8,) int tensor (``C.GRAY_MAP``); None builds it.
    """
    tau, phi = time_osr, freq_osr
    num_frames, num_freqs = mag_tf.shape[-2:]
    lead = mag_tf.shape[:-2]
    dev = mag_tf.device
    if gray_map is None:
        gray_map = torch.as_tensor(C.GRAY_MAP, device=dev)
    sym = torch.as_tensor(C.DATA_SYMBOL_POSITIONS, dtype=torch.int64,
                          device=dev)
    abs_time = abs_time.to(torch.int64)
    abs_freq = abs_freq.to(torch.int64)
    k = abs_time.shape[-1]

    # (..., K, 58) frame and (..., K, 8) bin of every Gray-ordered cell
    t_idx = (abs_time[..., None] + sym * tau).clamp(0, num_frames - 1)
    f_idx = abs_freq[..., None] + gray_map.to(torch.int64) * phi
    flat = (t_idx[..., :, None] * num_freqs + f_idx[..., None, :])
    s2 = torch.gather(mag_tf.reshape(*lead, num_frames * num_freqs), -1,
                      flat.reshape(*lead, k * 58 * 8)
                      ).reshape(*lead, k, 58, 8)

    block_idx = torch.div(abs_time, tau, rounding_mode="floor")[..., None] \
        + sym
    valid = (block_idx >= 0) & (block_idx < num_blocks)

    llr = _llr_from_powers(s2)                            # (..., K, 58, 3)
    llr = torch.where(valid[..., None], llr, 0.0)
    return normalize_llrs(llr.reshape(*lead, k, C.LDPC_N))


def normalize_llrs(llr: torch.Tensor) -> torch.Tensor:
    """Scale each 174-vector to variance 24."""
    mean = llr.mean(dim=-1, keepdim=True)
    var = ((llr - mean) ** 2).mean(dim=-1, keepdim=True)
    return llr * torch.sqrt(24.0 / torch.clamp(var, min=1e-30))
