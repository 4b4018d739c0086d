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
  from the slot's block spectra (blocks outside the slot are zero);
  :func:`extract_llrs_matched_blocks_stacked` averages those symbol powers
  over R slot-aligned repeats of one transmission before forming LLRs
  (noncoherent combining), as :func:`extract_llrs_matched_stacked` does
  for the direct form.
* :func:`extract_llrs_matched` evaluates the boxcar symbol DFTs straight
  from the audio (any geometry), :func:`extract_llrs_matched_refined` the
  same on a sub-grid of (dt, df) offsets around each candidate, and
  :func:`extract_llrs_coherent` projects the complex symbol correlations
  onto each candidate's carrier-phase track (branch variants).

The JAX package routes the reads through one-hot matmuls (a TPU
workaround); here they are index gathers, which select the same cells
exactly.  On a CUDA tensor the Hann and boxcar-grid routes are one launch
of the kernel K8 (``ops/llr_cuda.py``, ``csrc/llr_gather.cu``): the same
LLRs before scaling bit for bit, the scale within a few ulp.  The direct
forms' tone DFTs and the coherent path's small correlation products are
float64 matrix products rounded once to float32
(the JAX package's HIGH precision, whatever the order of the sums and
whether the card would use TF32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..protocol import constants as C
from ..protocol.tables import device_table
from .llr_cuda import llr_kernel
from .subtract import _linspace_f32

__all__ = ["extract_llrs", "extract_llrs_tf", "extract_llrs_matched",
           "extract_llrs_matched_grid", "extract_llrs_matched_blocks",
           "extract_llrs_matched_blocks_stacked",
           "extract_llrs_matched_stacked", "extract_llrs_matched_refined",
           "extract_llrs_coherent", "extract_llrs_coherent_stacked",
           "normalize_llrs"]

# Bit b of symbol value j (MSB first) — selects the max-of-4 groups.
_BIT_SET = np.array(
    [[(j >> (2 - b)) & 1 for j in range(8)] for b in range(3)], dtype=bool
)


@functools.lru_cache(maxsize=8)
def _bit_index_sets(device: torch.device
                    ) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """Per bit, the Gray-ordered positions with the bit set and clear (the
    max-of-4 index sets) on ``device``, built once."""
    return tuple((torch.as_tensor(np.flatnonzero(_BIT_SET[b]), device=device),
                  torch.as_tensor(np.flatnonzero(~_BIT_SET[b]),
                                  device=device))
                 for b in range(3))


def _llr_from_powers(s2: torch.Tensor) -> torch.Tensor:
    """(..., 8) Gray-ordered powers -> (..., 3) bit LLRs (max-of-4 contrast)."""
    return torch.stack([s2[..., pos_i].amax(dim=-1)
                        - s2[..., neg_i].amax(dim=-1)
                        for pos_i, neg_i in _bit_index_sets(s2.device)],
                       dim=-1)


def extract_llrs_tf(mag_tf: torch.Tensor, abs_time: torch.Tensor,
                    abs_freq: torch.Tensor, time_osr: int, freq_osr: int,
                    num_blocks: int) -> torch.Tensor:
    """Waterfall (..., T, F) + candidates (..., K) -> LLRs (..., K, 174).

    abs_time may be negative (pre-roll): time indices are clamped into the
    grid for the gather and the symbols outside the waterfall are masked to
    LLR 0.  A CUDA tensor takes K8 (``ops/llr_cuda.py``), one launch; a CPU
    tensor the plain version (:func:`_hann_llrs_plain`,
    :func:`normalize_llrs`).
    """
    if mag_tf.device.type == "cuda":
        return llr_kernel(mag_tf, abs_time, abs_freq, time_osr, freq_osr,
                          num_blocks, False,
                          device_table("GRAY_MAP", mag_tf.device))
    return normalize_llrs(_hann_llrs_plain(mag_tf, abs_time, abs_freq,
                                           time_osr, freq_osr, num_blocks))


def _hann_llrs_plain(mag_tf: torch.Tensor, abs_time: torch.Tensor,
                     abs_freq: torch.Tensor, time_osr: int, freq_osr: int,
                     num_blocks: int) -> torch.Tensor:
    """Plain version of K8's Hann route: the LLRs (..., K, 174) of
    :func:`extract_llrs_tf` before the variance-24 scaling."""
    tau, phi = time_osr, freq_osr
    num_frames, num_freqs = mag_tf.shape[-2:]
    lead = mag_tf.shape[:-2]
    dev = mag_tf.device
    sym = device_table("DATA_SYMBOL_POSITIONS", dev)
    abs_time = abs_time.to(torch.int64)
    abs_freq = abs_freq.to(torch.int64)
    k = abs_time.shape[-1]

    # (..., K, 58) frame and (..., K, 8) bin of every Gray-ordered cell
    t_idx = (abs_time[..., None] + sym * tau).clamp(0, num_frames - 1)
    f_idx = abs_freq[..., None] + device_table("GRAY_MAP", dev) * phi
    flat = (t_idx[..., :, None] * num_freqs + f_idx[..., None, :])
    s2 = torch.gather(mag_tf.reshape(*lead, num_frames * num_freqs), -1,
                      flat.reshape(*lead, k * 58 * 8)
                      ).reshape(*lead, k, 58, 8)

    block_idx = torch.div(abs_time, tau, rounding_mode="floor")[..., None] \
        + sym
    valid = (block_idx >= 0) & (block_idx < num_blocks)

    llr = _llr_from_powers(s2)                            # (..., K, 58, 3)
    llr = torch.where(valid[..., None], llr, 0.0)
    return llr.reshape(*lead, k, C.LDPC_N)


def extract_llrs(mag: torch.Tensor, abs_time: torch.Tensor,
                 abs_freq: torch.Tensor, time_osr: int, freq_osr: int,
                 num_blocks: int) -> torch.Tensor:
    """Frequency-major waterfall (..., F, T) + candidates (..., K) -> LLRs
    (..., K, 174): :func:`extract_llrs_tf` on the transposed view (the
    gathers select the same cells)."""
    return extract_llrs_tf(mag.transpose(-1, -2), abs_time, abs_freq,
                           time_osr, freq_osr, num_blocks)


def normalize_llrs(llr: torch.Tensor) -> torch.Tensor:
    """Scale each 174-vector to variance 24."""
    return llr * _llr_scale(llr)[..., None]


def _llr_scale(llr: torch.Tensor) -> torch.Tensor:
    """(..., 174) -> (...,) the factor that scales each vector to variance
    24 (K8's is a few ulp apart: its sums run in another order)."""
    mean = llr.mean(dim=-1, keepdim=True)
    var = ((llr - mean) ** 2).mean(dim=-1)
    return torch.sqrt(24.0 / torch.clamp(var, min=1e-30))


# ---------------------------------------------------------------------------
# matched-filter LLRs (block geometry)
# ---------------------------------------------------------------------------

def _powers_to_llrs(powers: torch.Tensor) -> torch.Tensor:
    """(..., K, 58, 8) linear symbol powers in tone order -> (..., K, 174)
    normalised LLRs."""
    return normalize_llrs(_powers_to_bit_llrs(powers))


def _powers_to_bit_llrs(powers: torch.Tensor) -> torch.Tensor:
    """(..., K, 58, 8) linear symbol powers in tone order -> (..., K, 174)
    LLRs before the variance-24 scaling."""
    s2 = (10.0 * torch.log10(1e-12 + powers))[
        ..., device_table("GRAY_MAP", powers.device)]
    llr = _llr_from_powers(s2)
    return llr.reshape(*powers.shape[:-2], C.LDPC_N)


def extract_llrs_matched_grid(box_tf: torch.Tensor, abs_time: torch.Tensor,
                              abs_freq: torch.Tensor, time_osr: int,
                              freq_osr: int) -> torch.Tensor:
    """Boxcar power grid (..., R, F) + candidates (..., K) -> MF LLRs
    (..., K, 174).

    Row j of ``box_tf`` is the boxcar symbol DFT power whose window starts
    at block j - (time_osr - 1) (``ops/waterfall.py`` ``_block_boxcar_tf``
    or the dual-output kernel's second output), so symbol s of a candidate
    at abs_time reads row abs_time + s * time_osr + time_osr - 1.  Rows
    outside the grid read power 0.  A CUDA tensor takes K8
    (``ops/llr_cuda.py``), one launch; a CPU tensor the plain version
    (:func:`_grid_llrs_plain`, :func:`normalize_llrs`).
    """
    if box_tf.device.type == "cuda":
        return llr_kernel(box_tf, abs_time, abs_freq, time_osr, freq_osr, 0,
                          True, device_table("GRAY_MAP", box_tf.device))
    return normalize_llrs(_grid_llrs_plain(box_tf, abs_time, abs_freq,
                                           time_osr, freq_osr))


def _grid_llrs_plain(box_tf: torch.Tensor, abs_time: torch.Tensor,
                     abs_freq: torch.Tensor, time_osr: int, freq_osr: int
                     ) -> torch.Tensor:
    """Plain version of K8's boxcar route: the LLRs (..., K, 174) of
    :func:`extract_llrs_matched_grid` before the variance-24 scaling."""
    tau, phi = time_osr, freq_osr
    nbrows, num_freqs = box_tf.shape[-2:]
    lead = box_tf.shape[:-2]
    dev = box_tf.device
    sym = device_table("DATA_SYMBOL_POSITIONS", dev)
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
    return _powers_to_bit_llrs(powers)


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
    sym = device_table("DATA_SYMBOL_POSITIONS", dev)
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
                                freq_osr: int) -> torch.Tensor:
    """Matched-filter LLRs from the slot's complex block spectra
    (..., nb, Kx) (``ops/waterfall.py`` ``_block_spectrum``): (..., K,
    174)."""
    return _powers_to_llrs(_mf_block_powers(spec, abs_time, abs_freq,
                                            time_osr, freq_osr))


def extract_llrs_matched_blocks_stacked(spec: torch.Tensor,
                                        abs_time: torch.Tensor,
                                        abs_freq: torch.Tensor,
                                        time_osr: int, freq_osr: int
                                        ) -> torch.Tensor:
    """Repeat-stacked matched-filter LLRs from (R, nb, Kx) complex block
    spectra of R slot-aligned repeats of one transmission: the per-tone
    symbol powers are averaged over the repeats in the linear domain (the
    sufficient statistic of noncoherent FSK under independent noise), then
    form the (K, 174) LLRs."""
    r = spec.shape[0]
    pw = _mf_block_powers(spec, abs_time.expand(r, -1),
                          abs_freq.expand(r, -1), time_osr, freq_osr)
    return _powers_to_llrs(pw.mean(0))


# ---------------------------------------------------------------------------
# matched-filter LLRs straight from the audio (any geometry)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _mf_tone_matrices(sps: int) -> tuple[np.ndarray, np.ndarray]:
    """(sps, 8) cos/sin of the integer-tone boxcar DFT
    e^{-2pi i tone n/sps}."""
    n = np.arange(sps)[:, None]
    tone = np.arange(8)[None, :]
    ang = -2.0 * np.pi * ((n * tone) % sps) / sps
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _mf_mix_tables(sps: int, phi: int) -> tuple[np.ndarray, np.ndarray]:
    """(sps*phi,) cos/sin lookup for e^{-2pi i q n/(sps*phi)} mixes."""
    ang = -2.0 * np.pi * np.arange(sps * phi) / (sps * phi)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _tone_block(tc: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """(..., sps, 8) cos/sin -> the (..., 2*sps, 16) float64 matrix M with
    [xr, xi] @ M = [xr@tc - xi@ts, xr@ts + xi@tc] (real, imaginary part of
    the complex product)."""
    tc, ts = np.float64(tc), np.float64(ts)
    return np.concatenate([np.concatenate([tc, ts], -1),
                           np.concatenate([-ts, tc], -1)], -2)


def _refine_tone_matrices(sps: int, phi: int, nf: int
                          ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The refined search's nf (sps, 8) cos/sin tone matrices: the integer
    tones shifted by the df bin centres of one candidate row."""
    f_fr = [(i + 0.5) / nf - 0.5 for i in range(nf)]
    n_ = np.arange(sps)[:, None]
    tone = np.arange(8)[None, :]
    mats = []
    for df in f_fr:
        ang = -2.0 * np.pi * n_ * (tone / sps + df / (sps * phi))
        mats.append((np.cos(ang).astype(np.float32),
                     np.sin(ang).astype(np.float32)))
    return mats


class _MFTables(NamedTuple):
    """The direct matched filter's constants on one device."""

    mix_cos: torch.Tensor     # (sps*phi,) float32
    mix_sin: torch.Tensor
    tones: torch.Tensor       # (2*sps, 16) float64 block of the integer tones


@functools.lru_cache(maxsize=16)
def _mf_tables(sps: int, phi: int, device: torch.device) -> _MFTables:
    """The constants of (sps, phi) on ``device``, built once."""
    t = lambda a: torch.as_tensor(a, device=device)
    return _MFTables(*map(t, _mf_mix_tables(sps, phi)),
                     t(_tone_block(*_mf_tone_matrices(sps))))


@functools.lru_cache(maxsize=8)
def _costas(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The frame positions of the 21 Costas symbols and their tones, int64
    on ``device``, built once."""
    pos = np.flatnonzero(C.FRAME_IS_COSTAS)
    return (torch.as_tensor(pos, dtype=torch.int64, device=device),
            torch.as_tensor(C.FRAME_COSTAS_TONE[pos], dtype=torch.int64,
                            device=device))


@functools.lru_cache(maxsize=16)
def _refine_tables(sps: int, hop: int, phi: int, nt: int, nf: int,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The refined search's (2*sps, nf*16) float64 tone blocks and its nt
    dt offsets (int64 samples) on ``device``, built once."""
    blocks = torch.as_tensor(np.concatenate(
        [_tone_block(tc, ts) for tc, ts in
         _refine_tone_matrices(sps, phi, nf)], -1), device=device)
    t_fr = [(i + 0.5) / nt - 0.5 for i in range(nt)]
    dts = torch.as_tensor([int(round(f * hop)) for f in t_fr],
                          dtype=torch.int64, device=device)
    return blocks, dts


def _tone_dft(xr: torch.Tensor, xi: torch.Tensor,
              block: torch.Tensor) -> torch.Tensor:
    """Mixed windows (..., sps) x2 -> [re, im] tone correlations (...,
    block columns) float32: the products summed in float64 and rounded
    once."""
    return (torch.cat([xr, xi], -1).double() @ block).float()


def _analytic(wave: torch.Tensor) -> torch.Tensor:
    """Real (..., n) -> its analytic signal, complex64 (..., n): one FFT,
    the negative frequencies zeroed and the positive ones doubled."""
    n = wave.shape[-1]
    spec = torch.fft.fft(wave.to(torch.complex64), dim=-1)
    weight = torch.zeros(n, dtype=torch.float32, device=wave.device)
    weight[0] = 1.0
    weight[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        weight[n // 2] = 1.0
    return torch.fft.ifft(spec * weight, dim=-1)


def _padded(wave: torch.Tensor, sps: int, is_complex: bool):
    """Audio (..., n) real or (..., n, 2) [re, im] -> (real, imaginary or
    None) float32 (..., n + 2*79*sps), 79 symbols of zeros on each side:
    windows past either end read zeros."""
    n_sig = C.NUM_SYMBOLS * sps
    pad = lambda x: torch.nn.functional.pad(x.to(torch.float32),
                                            (n_sig, n_sig))
    if is_complex:
        return pad(wave[..., 0]), pad(wave[..., 1])
    return pad(wave), None


def _windows(xp: torch.Tensor, starts: torch.Tensor, positions: torch.Tensor,
             sps: int) -> torch.Tensor:
    """Padded audio (R..., L) + window starts (S..., K) (sample of symbol
    0 in ``xp``, clipped so that the 79 symbols lie inside) + symbol
    positions (P,) -> (R..., S..., K, P, sps): one gather of whole symbols
    from a strided view (an index per symbol, not per sample)."""
    n_sig = C.NUM_SYMBOLS * sps
    starts = starts.clamp(0, xp.shape[-1] - n_sig)
    rows = starts[..., None] + positions * sps            # (S..., K, P)
    return xp.unfold(-1, sps, 1)[..., rows, :]


def _mixes(abs_freq: torch.Tensor, sps: int, phi: int, tables: _MFTables):
    """Per-candidate (K, sps) cos/sin of e^{-2pi i q n/(sps*phi)}, q the
    candidate's row, by modular lookup."""
    m = sps * phi
    q = torch.remainder(abs_freq.to(torch.int64), m)
    tab = torch.remainder(q[:, None] * torch.arange(sps, device=q.device), m)
    return tables.mix_cos[tab], tables.mix_sin[tab]


def _mix(wr, wi, mc, ms):
    """Windows (..., K, P, sps) times the candidates' (K, sps) mixes."""
    mc, ms = mc[:, None, :], ms[:, None, :]
    if wi is None:
        return wr * mc, wr * ms
    return wr * mc - wi * ms, wr * ms + wi * mc


def _tone_corr(xp, starts: torch.Tensor, rows: torch.Tensor, mixes,
               block: torch.Tensor, sps: int) -> torch.Tensor:
    """Padded audio (real, imaginary or None) (R..., L) + window starts
    (S..., K) + symbol positions ``rows`` (P,) int64 + the candidates' (K,
    sps) mixes -> [re, im] tone correlations (R..., S..., K, P, block
    columns)."""
    wr = _windows(xp[0], starts, rows, sps)
    wi = None if xp[1] is None else _windows(xp[1], starts, rows, sps)
    return _tone_dft(*_mix(wr, wi, *mixes), block)


def _mf_direct_powers(wave: torch.Tensor, abs_time: torch.Tensor,
                      abs_freq: torch.Tensor, sps: int, hop: int,
                      freq_osr: int, is_complex: bool) -> torch.Tensor:
    """Audio (R..., n[, 2]) -> per-candidate boxcar symbol powers (R...,
    K, 58, 8)."""
    dev = wave.device
    tables = _mf_tables(sps, freq_osr, dev)
    starts = abs_time.to(dev, torch.int64) * hop + C.NUM_SYMBOLS * sps
    y = _tone_corr(_padded(wave, sps, is_complex), starts,
                   device_table("DATA_SYMBOL_POSITIONS", dev),
                   _mixes(abs_freq.to(dev), sps, freq_osr, tables),
                   tables.tones, sps)
    re, im = y[..., :8], y[..., 8:]
    return re * re + im * im


def extract_llrs_matched(wave: torch.Tensor, abs_time: torch.Tensor,
                         abs_freq: torch.Tensor, sps: int, hop: int,
                         freq_osr: int,
                         is_complex: bool = False) -> torch.Tensor:
    """Matched-filter LLRs straight from the audio: (K, 174), normalised.

    Each of the 58 data symbols is a rectangular window of exactly one
    symbol (sps samples) at the candidate's start (abs_time * hop), mixed
    down by the candidate's row (``abs_freq`` in 1/freq_osr tone steps, an
    (sps*freq_osr)-entry lookup) and correlated with the 8 integer tones.
    ``wave``: (n,) real or (n, 2) [re, im] with ``is_complex``.  Samples
    before or past the audio read zero.
    """
    return _powers_to_llrs(_mf_direct_powers(
        wave, abs_time, abs_freq, sps, hop, freq_osr, is_complex))


def extract_llrs_matched_stacked(waves: torch.Tensor, abs_time: torch.Tensor,
                                 abs_freq: torch.Tensor, sps: int, hop: int,
                                 freq_osr: int,
                                 is_complex: bool = False) -> torch.Tensor:
    """Repeat-stacked matched-filter LLRs straight from (R, n[, 2]) audio:
    the direct form of :func:`extract_llrs_matched_blocks_stacked` for the
    geometries the block decomposition does not cover."""
    return _powers_to_llrs(_mf_direct_powers(
        waves, abs_time, abs_freq, sps, hop, freq_osr, is_complex).mean(0))


def extract_llrs_matched_refined(wave: torch.Tensor, abs_time: torch.Tensor,
                                 abs_freq: torch.Tensor, sps: int, hop: int,
                                 freq_osr: int, is_complex: bool = False,
                                 nt: int = 5, nf: int = 3
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Matched-filter LLRs with a per-candidate sub-grid (dt, df) offset
    search: (llrs_base, llrs_refined), each (K, 174).

    The offsets are the nt x nf bin centres of one candidate cell (dt in
    samples, ``int(round(.))`` of fractions of a hop; df in fractions of a
    row, folded into the tone matrices).  Each offset is scored on the 21
    Costas symbols by the linear-power contrast (on-tone power minus the
    8-tone mean, summed); each candidate takes its first best offset
    (``best`` = argmax over dt-major offsets) for the 58 data symbols.
    ``llrs_base`` is the (0, 0) offset: callers decode it first and retry
    the failures with ``llrs_refined``.
    """
    if nt % 2 == 0 or nf % 2 == 0:
        raise ValueError("nt/nf must be odd so the (0, 0) base offset is "
                         "a grid point (it feeds llrs_base)")
    dev = wave.device
    phi = freq_osr
    k = abs_freq.shape[0]
    tables = _mf_tables(sps, phi, dev)
    blocks, dts = _refine_tables(sps, hop, phi, nt, nf, dev)
    xp = _padded(wave, sps, is_complex)
    s0 = abs_time.to(dev, torch.int64) * hop + C.NUM_SYMBOLS * sps
    mixes = _mixes(abs_freq.to(dev), sps, phi, tables)
    tone_corr = lambda starts, rows, block: _tone_corr(xp, starts, rows,
                                                       mixes, block, sps)

    # stage 1: every offset scored on the 21 Costas symbols
    costas_pos, tone = _costas(dev)
    y = tone_corr(s0 + dts[:, None], costas_pos, blocks)
    y = y.reshape(nt, k, len(costas_pos), nf, 16).transpose(2, 3)
    pw = y[..., :8] ** 2 + y[..., 8:] ** 2                # (nt, K, nf, 21, 8)
    on = pw[..., torch.arange(len(costas_pos), device=dev), tone]
    scores = (on - pw.mean(-1)).sum(-1)                   # (nt, K, nf)
    best = torch.argmax(scores.transpose(1, 2).reshape(nt * nf, k), dim=0)
    dt_best = dts[best // nf]
    df_idx = best % nf

    sym = device_table("DATA_SYMBOL_POSITIONS", dev)
    centre = blocks[:, (nf // 2) * 16: (nf // 2 + 1) * 16]
    y0 = tone_corr(s0, sym, centre)
    base = _powers_to_llrs(y0[..., :8] ** 2 + y0[..., 8:] ** 2)
    yb = tone_corr(s0 + dt_best, sym, blocks)
    yb = yb.reshape(k, len(sym), nf, 16)[torch.arange(k, device=dev), :,
                                         df_idx]          # (K, 58, 16)
    return base, _powers_to_llrs(yb[..., :8] ** 2 + yb[..., 8:] ** 2)


# ---------------------------------------------------------------------------
# coherent matched-filter LLRs
# ---------------------------------------------------------------------------

class _CoherentTables(NamedTuple):
    """The coherent track search's constants of one (hop, freq_osr,
    num_branches) on one device."""

    costas_rows: torch.Tensor  # (21,) int64 frame positions of the Costas
    costas_tone: torch.Tensor  # (21,) int64 their tones
    costas_pos: torch.Tensor   # (21,) float32 the positions
    frame_rows: torch.Tensor   # (79,) int64 every frame position
    dts: torch.Tensor          # (9,) int64 the dt grid over +-hop/2
    deltas: torch.Tensor       # (D,) float32 the coarse df grid
    spec_block: torch.Tensor   # (42, 2D) float64 its Costas ramps
    step: torch.Tensor         # (B,) float32 the branches' df offsets
    fine_d: torch.Tensor       # (11,) float32 the fine df grid
    fine_t: torch.Tensor       # (5,) float32 the fine dt grid


@functools.lru_cache(maxsize=16)
def _coherent_tables(hop: int, phi: int, num_branches: int,
                     device: torch.device) -> _CoherentTables:
    """The coherent search's constants on ``device``, built once."""
    rows, tone = _costas(device)
    cpos = rows.to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    half_row = 0.5 / phi + 0.02
    n_coarse = int(np.ceil(2 * half_row * 4 * C.NUM_SYMBOLS)) | 1
    deltas = _linspace_f32(f32(-half_row), f32(half_row), n_coarse)
    ramp = (-2.0 * np.pi * deltas[:, None]) * cpos[None, :]    # (D, 21)
    rc, rs = torch.cos(ramp), torch.sin(ramp)
    order = [0, 1, -1, 2, -2, 3, -3][:num_branches]
    return _CoherentTables(
        costas_rows=rows, costas_tone=tone, costas_pos=cpos,
        frame_rows=torch.arange(C.NUM_SYMBOLS, device=device),
        dts=torch.as_tensor(np.round(np.linspace(-hop // 2, hop // 2, 9))
                            .astype(np.int64), device=device),
        deltas=deltas,
        spec_block=torch.cat([torch.cat([rc.T, rs.T], 1),
                              torch.cat([-rs.T, rc.T], 1)], 0).double(),
        step=torch.tensor([m * (1.0 / 36.0) for m in order],
                          dtype=torch.float32, device=device),
        fine_d=_linspace_f32(f32(-0.016), f32(0.016), 11),
        fine_t=_linspace_f32(f32(-0.06), f32(0.06), 5))


def extract_llrs_coherent(wave: torch.Tensor, abs_time: torch.Tensor,
                          abs_freq: torch.Tensor, sps: int, hop: int,
                          freq_osr: int, is_complex: bool = False,
                          num_branches: int = 5) -> torch.Tensor:
    """Coherent matched-filter LLR variants: (B, K, 174), B =
    ``num_branches``, the centre branch first.

    FT8's modulation index is 1, so the complex one-symbol tone
    correlations of a transmission share one carrier-phase track theta +
    2pi df s (+ 2pi dt k for a fractional timing offset).  The track is
    estimated from the 21 Costas cells: a 9-step dt grid over +-hop/2
    (best by the coarse-df coherence metric), a coarse df grid for the
    centre branch, then per branch (1/36 cycle/symbol apart: the Costas
    blocks sit 36 symbols apart) an 11 x 5 fine (df, dt) grid and a phase.
    Each branch projects the 79 symbols onto its track, clamps at 0 and
    forms LLRs from the linear powers.  Real input is first made analytic
    by one FFT (its negative-frequency image forms a second coherent
    track).
    """
    return extract_llrs_coherent_stacked(
        wave[None], abs_time, abs_freq, sps, hop, freq_osr, is_complex,
        num_branches)


def extract_llrs_coherent_stacked(waves: torch.Tensor, abs_time: torch.Tensor,
                                  abs_freq: torch.Tensor, sps: int, hop: int,
                                  freq_osr: int, is_complex: bool = False,
                                  num_branches: int = 5) -> torch.Tensor:
    """Coherent LLR variants from R slot-aligned repeats (R, n[, 2]) of one
    transmission: the track search sums the repeats' coherence metrics,
    each repeat gets its own phase, and the projected powers are summed
    over the repeats.  R = 1 is :func:`extract_llrs_coherent`."""
    dev = waves.device
    phi = freq_osr
    k = abs_freq.shape[0]
    tables = _mf_tables(sps, phi, dev)
    ct = _coherent_tables(hop, phi, num_branches, dev)
    n_sig = C.NUM_SYMBOLS * sps
    n_costas = len(ct.costas_rows)
    c_idx = torch.arange(n_costas, device=dev)
    two_pi = 2.0 * np.pi

    if not is_complex:
        waves = torch.view_as_real(_analytic(waves))
    xp = _padded(waves, sps, True)                        # (R, L) x2

    mixes = _mixes(abs_freq.to(dev), sps, phi, tables)
    # the per-symbol mix restarts its phase at every window, leaving a
    # residual phase step of 2pi (abs_freq mod phi)/phi per symbol; the
    # division is XLA's multiply by fl32(1/phi)
    q_frac = torch.remainder(abs_freq.to(dev, torch.int64), phi).to(
        torch.float32) * np.float32(1.0 / phi)
    s0 = abs_time.to(dev, torch.int64) * hop + n_sig

    def complex_syms(dt, pos):
        """Window offsets dt (broadcast to (..., K)) + symbol positions
        (P,) -> (R, ..., K, P, 8) complex tone correlations, the base-row
        phase step removed."""
        y = _tone_corr(xp, s0 + dt, pos, mixes, tables.tones, sps)
        re, im = y[..., :8], y[..., 8:]
        ang0 = (-two_pi * q_frac[:, None]) * pos.to(torch.float32)
        cos0 = torch.cos(ang0)[..., None]
        sin0 = torch.sin(ang0)[..., None]
        return re * cos0 - im * sin0, re * sin0 + im * cos0

    def costas_z(re, im):
        """On-track Costas values (..., 21) from (..., 21, 8)."""
        return re[..., c_idx, ct.costas_tone], im[..., c_idx, ct.costas_tone]

    # stage 1: the dt grid, scored by the coarse-df coherence metric
    n_coarse = ct.deltas.shape[0]

    def spectrum(zr, zi):
        """Coherence spectrum summed over the repeats: (R, ..., 21) ->
        (..., D)."""
        s = (torch.cat([zr, zi], -1).double() @ ct.spec_block).float()
        sr, si = s[..., :n_coarse], s[..., n_coarse:]
        return (sr * sr + si * si).sum(0)

    re, im = complex_syms(ct.dts[:, None], ct.costas_rows)
    mets = spectrum(*costas_z(re, im)).amax(-1)           # (9, K)
    dt_sel = ct.dts[torch.argmax(mets, dim=0)]

    # the 79 symbols at each candidate's dt; stage 2: the centre branch
    re79, im79 = complex_syms(dt_sel, ct.frame_rows)
    zr79, zi79 = costas_z(re79[..., ct.costas_rows, :],
                          im79[..., ct.costas_rows, :])
    d_centre = ct.deltas[torch.argmax(spectrum(zr79, zi79), dim=-1)]  # (K,)

    # stages 3-4: every branch's fine (df, dt) track and projection
    fine_t = ct.fine_t
    t2 = fine_t.shape[0]
    d_all = (d_centre[None, :] + ct.step[:, None])[..., None] \
        + ct.fine_d                                       # (B, K, F)
    angf = ((-two_pi * d_all)[..., None, None] * ct.costas_pos) \
        - (two_pi * fine_t)[:, None] * ct.costas_tone.to(torch.float32)
    angf = angf.reshape(*d_all.shape[:2], -1, n_costas)  # (B, K, F*T2, 21)
    cf, sf = torch.cos(angf), torch.sin(angf)
    w = torch.cat([torch.cat([cf, -sf], -1), torch.cat([sf, cf], -1)],
                  2).double()                             # (B, K, 2X, 42)
    z = torch.einsum("rkc,bkxc->rbkx", torch.cat([zr79, zi79], -1).double(),
                     w).float()
    x = angf.shape[2]
    zrr, zii = z[..., :x], z[..., x:]                     # (R, B, K, X)
    idx = torch.argmax((zrr * zrr + zii * zii).sum(0), dim=-1)       # (B, K)
    d_fin = torch.gather(d_all, 2, (idx // t2)[..., None])[..., 0]
    t_fin = fine_t[idx % t2]
    pick = lambda a: torch.gather(
        a, 3, idx[None, ..., None].expand(a.shape[0], -1, -1, 1))[..., 0]
    th = torch.atan2(pick(zii), pick(zrr))                # (R, B, K)
    s79 = torch.arange(C.NUM_SYMBOLS, dtype=torch.float32, device=dev)
    tone8 = torch.arange(8, dtype=torch.float32, device=dev)
    track = th[..., None, None] \
        + (two_pi * d_fin)[..., None, None] * s79[:, None] \
        + (two_pi * t_fin)[..., None, None] * tone8       # (R, B, K, 79, 8)
    proj = re79[:, None] * torch.cos(track) + im79[:, None] * torch.sin(track)
    proj = torch.clamp(proj, min=0.0)
    powers = (proj * proj).sum(0)[
        :, :, device_table("DATA_SYMBOL_POSITIONS", dev)]  # (B, K, 58, 8)
    llr = _llr_from_powers(powers[..., device_table("GRAY_MAP", dev)])
    return normalize_llrs(llr.reshape(ct.step.shape[0], k, C.LDPC_N))
