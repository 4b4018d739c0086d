"""Soft-symbol log-likelihood extraction.

Port of ``ft8_demodulator_tpu/ops/llr.py``: the Hann path and the
block-geometry matched-filter (MF) paths.  Per candidate, gather the (58
data symbols x 8 tones) window, reorder it through the Gray map, emit 174
max-of-4 LLRs and normalise each vector to variance 24.

* :func:`extract_llrs_tf` reads the time-major dB waterfall, and
  :func:`extract_llrs` the frequency-major one; symbols outside it
  contribute zero LLRs.
* :func:`extract_llrs_matched_grid` reads the boxcar power grid of the
  dual-output waterfall (row j = window start j - (tau-1)); symbol rows
  outside the grid read power 0, which gives equal dB on all 8 tones and
  so zero LLRs.
* :func:`extract_llrs_matched_blocks` assembles the boxcar symbol DFTs
  from the slot's block spectra (blocks outside the slot are zero).

The JAX package routes the reads through one-hot matmuls (a TPU
workaround); here they are index gathers, which select the same cells
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..protocol import constants as C

__all__ = ["extract_llrs", "extract_llrs_tf", "extract_llrs_matched_grid",
           "extract_llrs_matched_blocks", "normalize_llrs"]

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


def extract_llrs(mag: torch.Tensor, abs_time: torch.Tensor,
                 abs_freq: torch.Tensor, time_osr: int, freq_osr: int,
                 num_blocks: int, gray_map=None) -> torch.Tensor:
    """Frequency-major waterfall (..., F, T) + candidates (..., K) -> LLRs
    (..., K, 174): :func:`extract_llrs_tf` on the transposed view (the
    gathers select the same cells)."""
    return extract_llrs_tf(mag.transpose(-1, -2), abs_time, abs_freq,
                           time_osr, freq_osr, num_blocks, gray_map)


def normalize_llrs(llr: torch.Tensor) -> torch.Tensor:
    """Scale each 174-vector to variance 24."""
    mean = llr.mean(dim=-1, keepdim=True)
    var = ((llr - mean) ** 2).mean(dim=-1, keepdim=True)
    return llr * torch.sqrt(24.0 / torch.clamp(var, min=1e-30))


# ---------------------------------------------------------------------------
# matched-filter LLRs (block geometry)
# ---------------------------------------------------------------------------

def _powers_to_llrs(powers: torch.Tensor, gray_map=None) -> torch.Tensor:
    """(..., K, 58, 8) linear symbol powers in tone order -> (..., K, 174)
    normalised LLRs."""
    if gray_map is None:
        gray_map = torch.as_tensor(C.GRAY_MAP, device=powers.device)
    s2 = (10.0 * torch.log10(1e-12 + powers))[..., gray_map.to(torch.int64)]
    llr = _llr_from_powers(s2)
    return normalize_llrs(llr.reshape(*powers.shape[:-2], C.LDPC_N))


def extract_llrs_matched_grid(box_tf: torch.Tensor, abs_time: torch.Tensor,
                              abs_freq: torch.Tensor, time_osr: int,
                              freq_osr: int, gray_map=None) -> torch.Tensor:
    """Boxcar power grid (..., R, F) + candidates (..., K) -> MF LLRs
    (..., K, 174).

    Row j of ``box_tf`` is the boxcar symbol DFT power whose window starts
    at block j - (time_osr - 1) (``ops/waterfall.py`` ``_block_boxcar_tf``
    or the dual-output kernel's second output), so symbol s of a candidate
    at abs_time reads row abs_time + s * time_osr + time_osr - 1.  Rows
    outside the grid read power 0.
    """
    tau, phi = time_osr, freq_osr
    nbrows, num_freqs = box_tf.shape[-2:]
    lead = box_tf.shape[:-2]
    dev = box_tf.device
    sym = torch.as_tensor(C.DATA_SYMBOL_POSITIONS, dtype=torch.int64,
                          device=dev)
    tone = torch.arange(8, device=dev)
    k = abs_time.shape[-1]
    t_idx = abs_time.to(torch.int64)[..., None] + sym * tau + (tau - 1)
    valid = (t_idx >= 0) & (t_idx < nbrows)                 # (..., K, 58)
    f_idx = abs_freq.to(torch.int64)[..., None] + tone * phi  # (..., K, 8)
    flat = (t_idx.clamp(0, nbrows - 1)[..., :, None] * num_freqs
            + f_idx[..., None, :])
    powers = torch.gather(box_tf.reshape(*lead, nbrows * num_freqs), -1,
                          flat.reshape(*lead, k * 58 * 8)
                          ).reshape(*lead, k, 58, 8)
    powers = torch.where(valid[..., None], powers, 0.0)
    return _powers_to_llrs(powers, gray_map)


def _mf_block_powers(spec: torch.Tensor, abs_time: torch.Tensor,
                     abs_freq: torch.Tensor, time_osr: int,
                     freq_osr: int) -> torch.Tensor:
    """Complex block spectra (..., nb, Kx) + candidates (..., K) ->
    per-candidate boxcar symbol powers (..., K, 58, 8), tone order.

    A symbol is time_osr contiguous hop blocks, and with hop = sps/tau and
    nfft = phi*sps the per-block delay is a pure phase of period phi*tau:

        X_sym(bin) = sum_s  e^{-2pi i s bin/(phi*tau)} * P_{b0+s}[bin]

    with P read at extended column bin + phi; blocks outside [0, nb) are
    zero.
    """
    tau, phi = time_osr, freq_osr
    m = phi * tau
    nb, kx = spec.shape[-2:]
    lead = spec.shape[:-2]
    dev = spec.device
    sym = torch.as_tensor(C.DATA_SYMBOL_POSITIONS, dtype=torch.int64,
                          device=dev)
    s = torch.arange(tau, device=dev)
    tone = torch.arange(8, device=dev)

    # (..., K, 8) bins and (..., K, 58, tau) block rows of every symbol
    bins = abs_freq.to(torch.int64)[..., None] + tone * phi
    rows = abs_time.to(torch.int64)[..., None, None] + sym[:, None] * tau + s
    valid = (rows >= 0) & (rows < nb)
    flat = (rows.clamp(0, nb - 1)[..., None] * kx
            + (bins + phi)[..., None, None, :]).reshape(*lead, -1)
    wr, wi = (torch.where(valid[..., None], torch.gather(
        part.reshape(*lead, nb * kx), -1, flat).reshape(valid.shape + (8,)),
        0.0) for part in (spec.real, spec.imag))

    # combine phases e^{-2pi i s bin / m}: (..., K, 1, tau, 8)
    ang = (-2.0 * np.pi / m) * torch.remainder(
        bins[..., None, :] * s[:, None], m).to(torch.float32)
    cc = torch.cos(ang)[..., None, :, :]
    ss = torch.sin(ang)[..., None, :, :]
    xr = (wr * cc - wi * ss).sum(-2)                     # (..., K, 58, 8)
    xi = (wr * ss + wi * cc).sum(-2)
    return xr * xr + xi * xi


def extract_llrs_matched_blocks(spec: torch.Tensor, abs_time: torch.Tensor,
                                abs_freq: torch.Tensor, time_osr: int,
                                freq_osr: int, gray_map=None) -> torch.Tensor:
    """Matched-filter LLRs from the slot's complex block spectra
    (..., nb, Kx) (``ops/waterfall.py`` ``_block_spectrum``): (..., K,
    174)."""
    return _powers_to_llrs(_mf_block_powers(spec, abs_time, abs_freq,
                                            time_osr, freq_osr), gray_map)
