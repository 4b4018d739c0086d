"""The plain reference decoder's front half: waterfall -> sync -> top-K ->
LLRs, in plain PyTorch.

A frozen copy of the program's plain versions (the functions its CUDA
kernels are tested against), with every constant built here again:

* the waterfall is the block STFT (hop blocks, one DFT product, the phase
  combine of ``time_osr`` blocks, the periodic Hann window as a 3-tap
  stencil in frequency), |X|^2 / sum(win)^2 in dB, time-major.  Its DFT
  runs at one of four precisions (:data:`PRECISIONS`): the batch route's
  stated bf16 operands with float32 sums, the host API's stated float64
  sums rounded once to float32, and the controls one step below each
  (fp8 e4m3 operands; float32 sums).  From the power on, everything runs
  in ``dtype``: float32, the configurations' stated precision, or bfloat16
  in the control;
* the boxcar (no window) symbol-DFT power grid of the matched filter;
* the Costas sync score: the mean over the valid comparisons of
  [dB(Costas cell) - dB(neighbour cell)], -inf where none is valid;
* top-K over the score grid, ties to the lowest (freq, time) flat index;
* Hann LLRs (max-of-4 contrasts of the Gray-ordered dB cells) and matched
  filter LLRs (from the boxcar grid, or from the block spectra), each
  vector scaled to variance 24.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import constants as C

__all__ = ["PRECISIONS", "Geometry", "geometry", "SearchGrid", "search_grid",
           "block_spectra", "db_grid_tf", "boxcar_grid_tf", "sync_scores_tf",
           "find_candidates_tf", "llrs_hann_tf", "llrs_mf_grid",
           "llrs_mf_blocks"]

# DFT precision -> (operand dtype or None, accumulation dtype)
PRECISIONS = {
    "bf16": (torch.bfloat16, torch.float32),
    "fp8": (torch.float8_e4m3fn, torch.float32),
    "float64": (None, torch.float64),
    "float32": (None, torch.float32),
}
_DB_FLOOR = 1e-12
PRE_ROLL_SYMBOLS = 10
_ROW_SLACK = 12


class Geometry(NamedTuple):
    fs: float
    nperseg: int
    hop: int
    nfft: int
    time_osr: int
    freq_osr: int
    num_freq_bins: int

    def num_frames(self, n: int) -> int:
        return max(0, (n - self.nperseg) // self.hop + 1)


def geometry(fs: float, bins_per_tone: int, steps_per_symbol: int
             ) -> Geometry:
    nperseg = int(C.SYMBOL_PERIOD_S * fs)
    nfft = int(fs / C.TONE_SPACING_HZ * bins_per_tone)
    return Geometry(float(fs), nperseg, nperseg // steps_per_symbol, nfft,
                    steps_per_symbol, bins_per_tone, nfft // 2)


class SearchGrid(NamedTuple):
    time_osr: int
    freq_osr: int
    num_blocks: int
    t_start: int
    num_times: int
    num_freqs: int


def search_grid(num_freq_bins: int, num_frames: int, time_osr: int,
                freq_osr: int) -> SearchGrid:
    """Start times from 10 symbols before the slot to num_blocks - 59
    symbols; base frequencies leaving room for the 8 tones."""
    num_blocks = num_frames // time_osr
    t_start = -PRE_ROLL_SYMBOLS * time_osr
    t_stop = (num_blocks - C.NUM_DATA_SYMBOLS - 1) * time_osr
    return SearchGrid(time_osr, freq_osr, num_blocks, t_start,
                      max(0, t_stop - t_start),
                      max(0, num_freq_bins - 7 * freq_osr))


# ---------------------------------------------------------------------------
# waterfall
# ---------------------------------------------------------------------------

def _dft_matrices(p: Geometry) -> tuple[np.ndarray, np.ndarray]:
    """(hop, F + 2 phi) cos/sin of the hop-block DFT; column c is bin
    c - phi (the halo feeds the Hann stencil)."""
    n = np.arange(p.hop)[:, None]
    k = np.arange(-p.freq_osr, p.num_freq_bins + p.freq_osr)[None, :]
    ang = -2.0 * np.pi * ((n * k) % p.nfft) / p.nfft
    return np.cos(ang), np.sin(ang)


def _combine_phases(p: Geometry, device) -> torch.Tensor:
    """(tau, F + 2 phi) complex64 e^{-2 pi i s k / (phi tau)}: block s of a
    frame lies s hops later."""
    s = np.arange(p.time_osr)[:, None]
    k = np.arange(-p.freq_osr, p.num_freq_bins + p.freq_osr)[None, :]
    period = p.freq_osr * p.time_osr
    ang = -2.0 * np.pi * ((s * k) % period) / period
    return torch.complex(torch.as_tensor(np.cos(ang).astype(np.float32)),
                         torch.as_tensor(np.sin(ang).astype(np.float32))
                         ).to(device)


def block_spectra(waves: torch.Tensor, p: Geometry, num_frames: int,
                  precision: str) -> torch.Tensor:
    """Real (..., n) -> complex64 hop-block spectra (..., nb, F + 2 phi),
    nb = num_frames + tau - 1, the DFT at ``precision``."""
    operand, acc = PRECISIONS[precision]
    nb = num_frames + p.time_osr - 1
    blocks = waves[..., : nb * p.hop].reshape(*waves.shape[:-1], nb, p.hop)
    # float32 constants at every precision, as the program's tables are
    cos_m, sin_m = (torch.as_tensor(m.astype(np.float32), device=waves.device)
                    for m in _dft_matrices(p))
    if operand is not None:
        # round the operands, then multiply exactly enough in float32
        rnd = lambda x: x.to(torch.float32).to(operand).to(torch.float32)
        blocks, cos_m, sin_m = rnd(blocks), rnd(cos_m), rnd(sin_m)
    else:
        blocks, cos_m, sin_m = (x.to(acc) for x in (blocks, cos_m, sin_m))
    return torch.complex((blocks @ cos_m).float(), (blocks @ sin_m).float())


def _db_scale(p: Geometry) -> float:
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(p.nperseg) / p.nperseg)
    return 1.0 / float(np.sum(win) ** 2)


def db_grid_tf(spec: torch.Tensor, p: Geometry, num_frames: int,
               dtype=torch.float32) -> torch.Tensor:
    """Block spectra -> (..., T, F) dB grid of the Hann-windowed frames,
    from the power on in ``dtype``."""
    w = _combine_phases(p, spec.device)
    u = spec[..., 0:num_frames, :] * w[0]
    for s in range(1, p.time_osr):
        u = u + spec[..., s: s + num_frames, :] * w[s]
    phi = p.freq_osr
    k0, k1 = phi, phi + p.num_freq_bins
    x = (0.5 * u[..., k0:k1] - 0.25 * u[..., k0 - phi: k1 - phi]
         - 0.25 * u[..., k0 + phi: k1 + phi])
    power = (x.real * x.real + x.imag * x.imag).to(dtype)
    return 10.0 * torch.log10(_DB_FLOOR + power * _db_scale(p))


def boxcar_grid_tf(spec: torch.Tensor, p: Geometry, num_frames: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Block spectra -> (..., T + 2 (tau - 1), F) boxcar symbol-DFT power;
    row j's window starts at block j - (tau - 1) (zero blocks outside)."""
    tau, phi = p.time_osr, p.freq_osr
    k0, k1 = phi, phi + p.num_freq_bins
    rows = num_frames + 2 * (tau - 1)
    w = _combine_phases(p, spec.device)[:, k0:k1]
    zeros = spec.new_zeros((*spec.shape[:-2], tau - 1, k1 - k0))
    padded = torch.cat([zeros, spec[..., k0:k1], zeros], dim=-2)
    u = padded[..., 0:rows, :] * w[0]
    for s in range(1, tau):
        u = u + padded[..., s: s + rows, :] * w[s]
    return (u.real * u.real + u.imag * u.imag).to(dtype)


# ---------------------------------------------------------------------------
# sync and top-K
# ---------------------------------------------------------------------------

def _cell_masks(g: SearchGrid) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(21, num_times) validity of each Costas cell, of its comparison with
    the previous symbol and with the next one."""
    base = np.floor_divide(g.t_start + np.arange(g.num_times), g.time_osr)
    cell = np.zeros((C.NUM_COSTAS_SEQS * C.COSTAS_LEN, g.num_times), bool)
    prev, nxt = np.zeros_like(cell), np.zeros_like(cell)
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            ba = base + m * C.SYNC_SEQ_STRIDE + k
            cell[i] = (ba >= 0) & (ba < g.num_blocks)
            if k > 0:
                prev[i] = cell[i] & (ba > 0)
            if k < C.COSTAS_LEN - 1:
                nxt[i] = cell[i] & (ba + 1 < g.num_blocks)
    return cell, prev, nxt


def _scores_impl(mag_tf: torch.Tensor, g: SearchGrid, masks) -> torch.Tensor:
    tau, phi = g.time_osr, g.freq_osr
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times + (C.NUM_SYMBOLS - 1) * tau
                - mag_tf.shape[-2])
    padded = F.pad(mag_tf, (0, 0, left, right))

    def cell(b: int, tone: int) -> torch.Tensor:
        start = left + g.t_start + b * tau
        return padded[..., start: start + g.num_times,
                      tone * phi: tone * phi + g.num_freqs]

    cell_m, prev_m, next_m = (m.to(mag_tf.dtype)[:, :, None] for m in masks)
    total = mag_tf.new_zeros((*mag_tf.shape[:-2], g.num_times, g.num_freqs))
    count = mag_tf.new_zeros((g.num_times, 1))
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            tone = int(C.COSTAS_PATTERN[k])
            cur = cell(b, tone)
            contrib = torch.zeros_like(cur)
            n_freq = 0
            if tone > 0:
                contrib += cur - cell(b, tone - 1)
                n_freq += 1
            if tone < 7:
                contrib += cur - cell(b, tone + 1)
                n_freq += 1
            total += cell_m[i] * contrib
            count += cell_m[i] * float(n_freq)
            if k > 0:
                total += prev_m[i] * (cur - cell(b - 1, tone))
                count += prev_m[i]
            if k < C.COSTAS_LEN - 1:
                total += next_m[i] * (cur - cell(b + 1, tone))
                count += next_m[i]
    inv = 1.0 / torch.clamp(count, min=1.0)
    return torch.where(count > 0, total * inv, -torch.inf)


def sync_scores_tf(mag_tf: torch.Tensor, g: SearchGrid) -> torch.Tensor:
    """(..., T, F) dB grid -> (..., num_times, num_freqs) sync scores.  A
    grid with a pre-roll whose main part needs no right padding is scored in
    two pieces (the pre-roll on a short leading slice), the program's
    order of float32 sums."""
    masks = [torch.as_tensor(m, device=mag_tf.device) for m in _cell_masks(g)]
    main_cols = g.num_times + g.t_start
    right = main_cols + (C.NUM_SYMBOLS - 1) * g.time_osr - mag_tf.shape[-2]
    if g.t_start < 0 and main_cols > 0 and right <= 0:
        split = -g.t_start
        w_pre = min(mag_tf.shape[-2], (C.NUM_SYMBOLS - 1) * g.time_osr)
        pre = _scores_impl(mag_tf[..., :w_pre, :],
                           g._replace(num_times=split),
                           [m[:, :split] for m in masks])
        main = _scores_impl(mag_tf, g._replace(t_start=0,
                                               num_times=main_cols),
                            [m[:, split:] for m in masks])
        return torch.cat([pre, main], dim=-2)
    return _scores_impl(mag_tf, g, masks)


def _top_k_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def find_candidates_tf(scores_tf: torch.Tensor, g: SearchGrid, k: int,
                       min_score: float):
    """(..., num_times, num_freqs) scores -> (abs_time, abs_freq, score,
    valid), each (..., k): the k best cells at or above ``min_score``
    (ties to the lowest f * num_times + t), screened over the k + 12
    frequency rows with the largest maxima."""
    masked = torch.where(scores_tf >= min_score, scores_tf, -torch.inf)
    num_times, num_freqs = masked.shape[-2:]
    lead = masked.shape[:-2]
    rows_needed = k + _ROW_SLACK
    if num_freqs <= rows_needed or num_freqs * num_times == 0:
        vals, idx = _top_k_stable(masked.transpose(-1, -2).reshape(*lead, -1),
                                  k)
    else:
        _, rows = _top_k_stable(masked.amax(dim=-2), rows_needed)
        sub = torch.gather(masked, -1, rows.unsqueeze(-2).expand(
            *lead, num_times, rows_needed))
        vals, i2 = _top_k_stable(sub.transpose(-1, -2).reshape(*lead, -1), k)
        idx = torch.gather(rows, -1, i2 // num_times) * num_times \
            + i2 % num_times
    abs_freq = (idx // g.num_times).to(torch.int32)
    abs_time = (g.t_start + idx % g.num_times).to(torch.int32)
    return abs_time, abs_freq, vals, torch.isfinite(vals)


# ---------------------------------------------------------------------------
# LLRs
# ---------------------------------------------------------------------------

_BIT_SET = np.array([[(j >> (2 - b)) & 1 for j in range(8)] for b in range(3)],
                    dtype=bool)


def _llr_from_powers(s2: torch.Tensor) -> torch.Tensor:
    """(..., 8) Gray-ordered dB powers -> (..., 3) max-of-4 bit LLRs."""
    return torch.stack([
        s2[..., np.flatnonzero(_BIT_SET[b])].amax(dim=-1)
        - s2[..., np.flatnonzero(~_BIT_SET[b])].amax(dim=-1)
        for b in range(3)], dim=-1)


def _normalize(llr: torch.Tensor) -> torch.Tensor:
    mean = llr.mean(dim=-1, keepdim=True)
    var = ((llr - mean) ** 2).mean(dim=-1, keepdim=True)
    return llr * torch.sqrt(24.0 / torch.clamp(var, min=1e-30))


def _gray(device) -> torch.Tensor:
    return torch.as_tensor(C.GRAY_MAP, dtype=torch.int64, device=device)


def _symbols(device) -> torch.Tensor:
    return torch.as_tensor(C.DATA_SYMBOL_POSITIONS, dtype=torch.int64,
                           device=device)


def llrs_hann_tf(mag_tf: torch.Tensor, abs_time: torch.Tensor,
                 abs_freq: torch.Tensor, g: SearchGrid) -> torch.Tensor:
    """(..., T, F) dB grid, (..., K) candidates -> (..., K, 174) LLRs;
    symbols outside the grid give LLR 0."""
    tau, phi = g.time_osr, g.freq_osr
    num_frames, num_freqs = mag_tf.shape[-2:]
    lead = mag_tf.shape[:-2]
    dev = mag_tf.device
    sym = _symbols(dev)
    abs_time, abs_freq = abs_time.to(torch.int64), abs_freq.to(torch.int64)
    k = abs_time.shape[-1]
    t_idx = (abs_time[..., None] + sym * tau).clamp(0, num_frames - 1)
    f_idx = abs_freq[..., None] + _gray(dev) * phi
    flat = t_idx[..., :, None] * num_freqs + f_idx[..., None, :]
    s2 = torch.gather(mag_tf.reshape(*lead, -1), -1,
                      flat.reshape(*lead, -1)).reshape(*lead, k, 58, 8)
    block = torch.div(abs_time, tau, rounding_mode="floor")[..., None] + sym
    valid = (block >= 0) & (block < g.num_blocks)
    llr = torch.where(valid[..., None], _llr_from_powers(s2), 0.0)
    return _normalize(llr.reshape(*lead, k, C.LDPC_N))


def _powers_to_llrs(powers: torch.Tensor) -> torch.Tensor:
    """(..., K, 58, 8) linear powers in tone order -> (..., K, 174)."""
    s2 = (10.0 * torch.log10(1e-12 + powers))[..., _gray(powers.device)]
    return _normalize(_llr_from_powers(s2).reshape(*powers.shape[:-2],
                                                   C.LDPC_N))


def llrs_mf_grid(box_tf: torch.Tensor, abs_time: torch.Tensor,
                 abs_freq: torch.Tensor, g: SearchGrid) -> torch.Tensor:
    """Boxcar grid (..., R, F), candidates (..., K) -> MF LLRs (..., K,
    174); symbol s reads row abs_time + s tau + tau - 1, power 0 outside."""
    tau, phi = g.time_osr, g.freq_osr
    nbrows, num_freqs = box_tf.shape[-2:]
    lead = box_tf.shape[:-2]
    dev = box_tf.device
    k = abs_time.shape[-1]
    t_idx = abs_time.to(torch.int64)[..., None] + _symbols(dev) * tau \
        + (tau - 1)
    valid = (t_idx >= 0) & (t_idx < nbrows)
    f_idx = abs_freq.to(torch.int64)[..., None] \
        + torch.arange(8, device=dev) * phi
    flat = t_idx.clamp(0, nbrows - 1)[..., :, None] * num_freqs \
        + f_idx[..., None, :]
    powers = torch.gather(box_tf.reshape(*lead, -1), -1,
                          flat.reshape(*lead, -1)).reshape(*lead, k, 58, 8)
    return _powers_to_llrs(torch.where(valid[..., None], powers, 0.0))


def llrs_mf_blocks(spec: torch.Tensor, abs_time: torch.Tensor,
                   abs_freq: torch.Tensor, g: SearchGrid,
                   dtype=torch.float32) -> torch.Tensor:
    """Block spectra (nb, Kx), candidates (K,) -> MF LLRs (K, 174): each
    symbol's boxcar DFT combined from its tau blocks (zero outside), the
    powers on in ``dtype``."""
    tau, phi = g.time_osr, g.freq_osr
    m = phi * tau
    nb, kx = spec.shape[-2:]
    dev = spec.device
    s = torch.arange(tau, device=dev)
    bins = abs_freq.to(torch.int64)[:, None] + torch.arange(8, device=dev) \
        * phi                                                    # (K, 8)
    rows = abs_time.to(torch.int64)[:, None, None] \
        + _symbols(dev)[:, None] * tau + s                      # (K, 58, tau)
    valid = (rows >= 0) & (rows < nb)
    flat = (rows.clamp(0, nb - 1)[..., None] * kx
            + (bins + phi)[:, None, None, :]).reshape(-1)
    wr, wi = (torch.where(valid[..., None],
                          part.reshape(-1)[flat].reshape(valid.shape + (8,)),
                          0.0) for part in (spec.real, spec.imag))
    ang = (-2.0 * np.pi / m) * torch.remainder(
        bins[:, None, :] * s[:, None], m).to(torch.float32)      # (K, tau, 8)
    cc, ss = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    xr = (wr * cc - wi * ss).sum(-2)
    xi = (wr * ss + wi * cc).sum(-2)
    return _powers_to_llrs((xr * xr + xi * xi).to(dtype))
