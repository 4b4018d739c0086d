"""Costas sync scoring and candidate search.

Port of ``ft8_demodulator_tpu/ops/sync.py``, both layouts: each of the <=84
(Costas cell, comparison) terms is a statically offset 2-D slice of the
padded dB grid, added in the reference's order, so float32 scores are
bit-identical to the JAX stencil on the CPU.  The frequency-major
functions (:func:`sync_scores`, :func:`find_candidates`, on (..., F, T)
grids) run the time-major ones on the transposed view: the stencil is
elementwise and the flat candidate index is f * num_times + t in both.
Candidate selection reproduces ``lax.top_k``'s tie order: with stable
sorts on the CPU (:func:`find_candidates_plain`), with the kernel K9
(``ops/topk_cuda.py``) on the card.  Every function takes leading batch
dimensions, but for :func:`sync_scores_z`, the linear-power Costas z
statistic of the repeat-stacked decoder, which takes one (F, T) grid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..protocol import constants as C
from ..utils.profiling import host_wait
from .topk_cuda import topk_kernel

__all__ = ["SearchGrid", "search_grid", "sync_scores", "sync_scores_tf",
           "sync_scores_z", "find_candidates", "find_candidates_tf",
           "find_candidates_plain", "cell_mask_tensors"]

# The reference scans start times from 10 symbols before the slot up to
# num_blocks - 59 symbols.
PRE_ROLL_SYMBOLS = 10
_MIN_TAIL_SYMBOLS = C.NUM_DATA_SYMBOLS + 1  # 59
# Extra candidate rows screened beyond max_candidates (tie slack).
_ROW_SLACK = 12


class SearchGrid(NamedTuple):
    """Static geometry of the candidate search over one waterfall."""

    time_osr: int
    freq_osr: int
    num_blocks: int
    t_start: int        # first abs_time scanned (negative: pre-roll)
    num_times: int      # abs_time values scanned
    num_freqs: int      # abs_freq values scanned


def search_grid(num_freq_bins: int, num_frames: int, time_osr: int,
                freq_osr: int) -> SearchGrid:
    num_blocks = num_frames // time_osr
    t_start = -PRE_ROLL_SYMBOLS * time_osr
    t_stop = num_blocks * time_osr - _MIN_TAIL_SYMBOLS * time_osr
    num_times = max(0, t_stop - t_start)
    num_freqs = max(0, num_freq_bins - 7 * freq_osr)
    return SearchGrid(time_osr, freq_osr, num_blocks, t_start,
                      num_times, num_freqs)


def _cell_masks(g: SearchGrid) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-(cell, t) validity masks, shape (21, num_times) each (host consts).

    The masks only depend on base = floor(abs_time / time_osr), never on
    frequency.
    """
    t = g.t_start + np.arange(g.num_times)
    base = np.floor_divide(t, g.time_osr)
    cell = np.zeros((C.NUM_COSTAS_SEQS * C.COSTAS_LEN, g.num_times), bool)
    prev = np.zeros_like(cell)
    nxt = np.zeros_like(cell)
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            ba = base + b
            cell[i] = (ba >= 0) & (ba < g.num_blocks)
            if k > 0:
                prev[i] = cell[i] & (ba > 0)
            if k < C.COSTAS_LEN - 1:
                nxt[i] = cell[i] & (ba + 1 < g.num_blocks)
    return cell, prev, nxt


@functools.lru_cache(maxsize=16)
def cell_mask_tensors(g: SearchGrid,
                      device: torch.device) -> tuple[torch.Tensor, ...]:
    """(cell, prev, next) bool (21, num_times) mask tensors, cached."""
    return tuple(torch.as_tensor(m, device=device) for m in _cell_masks(g))


def _sub_grid(g: SearchGrid, t_start: int, num_times: int) -> SearchGrid:
    return SearchGrid(g.time_osr, g.freq_osr, g.num_blocks, t_start,
                      num_times, g.num_freqs)


def sync_scores_tf(mag_tf: torch.Tensor, g: SearchGrid) -> torch.Tensor:
    """Time-major waterfall (..., T, F) -> scores (..., num_times, num_freqs).

    score(t, f) = mean over valid comparisons of
    [power(costas cell) - power(neighbour cell)]; -inf where no comparison
    is in bounds.  Grids with a pre-roll (t_start < 0) whose main part
    needs no right padding are scored in two pieces, the pre-roll columns
    on a short leading slice and the main columns on the unpadded grid, as
    the JAX stencil does.
    """
    masks = cell_mask_tensors(g, mag_tf.device)
    main_cols = g.num_times + g.t_start
    main_right_pad = main_cols + (C.NUM_SYMBOLS - 1) * g.time_osr \
        - mag_tf.shape[-2]
    if g.t_start < 0 and main_cols > 0 and main_right_pad <= 0:
        w_pre = min(mag_tf.shape[-2], (C.NUM_SYMBOLS - 1) * g.time_osr)
        split = -g.t_start
        pre = _sync_scores_tf_impl(mag_tf[..., :w_pre, :],
                                   _sub_grid(g, g.t_start, split),
                                   [m[:, :split] for m in masks])
        main = _sync_scores_tf_impl(mag_tf, _sub_grid(g, 0, main_cols),
                                    [m[:, split:] for m in masks])
        return torch.cat([pre, main], dim=-2)
    return _sync_scores_tf_impl(mag_tf, g, masks)


def sync_scores(mag: torch.Tensor, g: SearchGrid) -> torch.Tensor:
    """Frequency-major waterfall (..., F, T) -> scores (..., num_freqs,
    num_times), with the pre-roll split of :func:`sync_scores_tf`.

    The same terms in the same order per cell as the JAX ``sync_scores``;
    XLA turns its division by the count (broadcast along frequency here)
    into a reciprocal multiply in this layout too, so the scores are
    bit-identical to it.
    """
    return sync_scores_tf(mag.transpose(-1, -2), g).transpose(-1, -2)


def _sync_scores_tf_impl(mag_tf: torch.Tensor, g: SearchGrid,
                         masks) -> torch.Tensor:
    tau, phi = g.time_osr, g.freq_osr
    num_frames = mag_tf.shape[-2]
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times
                + (C.NUM_SYMBOLS - 1) * tau - num_frames)
    padded = F.pad(mag_tf, (0, 0, left, right))

    def cell_power(b: int, tone: int) -> torch.Tensor:
        start = left + g.t_start + b * tau
        return padded[..., start: start + g.num_times,
                      tone * phi: tone * phi + g.num_freqs]

    cell_m, prev_m, next_m = (m.to(torch.float32)[:, :, None] for m in masks)
    lead = mag_tf.shape[:-2]
    total = mag_tf.new_zeros((*lead, g.num_times, g.num_freqs))
    count = mag_tf.new_zeros((g.num_times, 1))

    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            tone = int(C.COSTAS_PATTERN[k])
            cur = cell_power(b, tone)

            freq_contrib = torch.zeros_like(cur)
            n_freq = 0
            if tone > 0:
                freq_contrib += cur - cell_power(b, tone - 1)
                n_freq += 1
            if tone < 7:
                freq_contrib += cur - cell_power(b, tone + 1)
                n_freq += 1
            total += cell_m[i] * freq_contrib
            count += cell_m[i] * float(n_freq)

            if k > 0:
                total += prev_m[i] * (cur - cell_power(b - 1, tone))
                count += prev_m[i]
            if k < C.COSTAS_LEN - 1:
                total += next_m[i] * (cur - cell_power(b + 1, tone))
                count += next_m[i]

    # one reciprocal per time row, then a multiply: XLA rewrites the JAX
    # stencil's division by the broadcast count this way, and the scores
    # stay bit-identical to it
    inv = 1.0 / torch.clamp(count, min=1.0)
    return torch.where(count > 0, total * inv, -torch.inf)


def sync_scores_z(linpow: torch.Tensor, g: SearchGrid) -> torch.Tensor:
    """Linear power grid (F, T) -> normalised Costas detection z (nF, nT).

    Each of the 21 Costas cells contributes its linear on-tone power minus
    the exact 8-tone mean at that symbol; the sum is normalised to unit
    noise variance (var(P) of the whole grid; each contrast has variance
    (7/8) var(P) under noise only, so z ~ N(0, 1) there).  -inf where no
    cell is in bounds.  The terms are added in the JAX function's order.
    """
    tau, phi = g.time_osr, g.freq_osr
    padded, s8, left = _pad_and_tone_sum(linpow, g)
    cell_m = cell_mask_tensors(g, linpow.device)[0].to(torch.float32)
    total = linpow.new_zeros((g.num_freqs, g.num_times))
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            b = m * C.SYNC_SEQ_STRIDE + k
            start = left + g.t_start + b * tau
            total = total + cell_m[i] * (
                _cells(padded, int(C.COSTAS_PATTERN[k]) * phi, start, g)
                - _cells(s8, 0, start, g) * 0.125)
    return _z_normalise(total, linpow,
                        _cell_masks(g)[0].sum(0).astype(np.float32))


def _cells(grid: torch.Tensor, row: int, col: int,
           g: SearchGrid) -> torch.Tensor:
    """The (num_freqs, num_times) window of ``grid`` at (row, col), the
    start clamped into the grid as ``lax.dynamic_slice`` clamps it."""
    row = min(max(row, 0), grid.shape[-2] - g.num_freqs)
    col = min(max(col, 0), grid.shape[-1] - g.num_times)
    return grid[..., row: row + g.num_freqs, col: col + g.num_times]


def _pad_and_tone_sum(linpow: torch.Tensor, g: SearchGrid):
    """Pad the linear grid for a track scan and build the 8-tone row sum
    S8(f, t) = sum_j P(f + j*phi, t) over the frequency rows the grid
    scans.  Returns (padded, s8, left pad)."""
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times
                + (C.NUM_SYMBOLS - 1) * g.time_osr - linpow.shape[-1])
    padded = F.pad(linpow, (left, right))
    s8 = linpow.new_zeros((g.num_freqs, padded.shape[-1]))
    for j in range(8):
        s8 = s8 + padded[j * g.freq_osr: j * g.freq_osr + g.num_freqs]
    return padded, s8, left


def _z_normalise(total: torch.Tensor, linpow: torch.Tensor,
                 count: np.ndarray) -> torch.Tensor:
    """Contrast sum -> unit-noise-variance z: each contrast has variance
    (7/8) var(P) under noise only, var(P) the grid's population variance
    (``jnp.var`` divides by N: ``correction=0``).  ``count``: valid
    contrasts per time column (host)."""
    cell_var = torch.var(linpow, correction=0)
    with host_wait("ft8.sync_z.wait"):
        cnt = torch.as_tensor(count, device=linpow.device)
    sigma = torch.sqrt(cell_var * 0.875 * torch.clamp(cnt, min=1.0))
    return torch.where(cnt > 0, total / sigma, -torch.inf)


def _top_k_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (lax.top_k's
    order; torch.topk promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def find_candidates_tf(scores_tf: torch.Tensor, g: SearchGrid,
                       max_candidates: int, min_score: float):
    """Top-K candidates over a time-major (..., num_times, num_freqs) grid.

    Returns (abs_time, abs_freq, score, valid), each (..., K), sorted by
    descending score.  Exact row-max screening: at most K distinct
    frequency rows can hold the top K, so the K + 12 rows with the largest
    maxima are screened (ties to the lowest frequency) and the flat top-K
    runs over those rows in screen order, as the JAX function does: ties
    go to the lower screen rank, then the earlier time, not to the lower
    (freq, time) flat index.  A grid of no more than K + 12 frequencies
    takes the flat top-K over f * num_times + t, ties to the lowest.  Cells
    below min_score are -inf and yield valid = False.  On a CUDA tensor
    the kernel K9 (``ops/topk_cuda.py``) selects, one launch a call; the
    plain route (:func:`find_candidates_plain`) is what it computes.
    """
    if scores_tf.device.type == "cuda":
        return topk_kernel(scores_tf, g.num_times, g.t_start, max_candidates,
                           min_score)
    return find_candidates_plain(scores_tf, g, max_candidates, min_score)


def find_candidates_plain(scores_tf: torch.Tensor, g: SearchGrid,
                          max_candidates: int, min_score: float):
    """:func:`find_candidates_tf` in PyTorch on any device: what K9
    computes, and the route of a CPU tensor."""
    masked = torch.where(scores_tf >= min_score, scores_tf, -torch.inf)
    num_times, num_freqs = masked.shape[-2:]
    lead = masked.shape[:-2]
    rows_needed = max_candidates + _ROW_SLACK
    if num_freqs <= rows_needed or num_freqs * num_times == 0:
        flat = masked.transpose(-1, -2).reshape(*lead, -1)
        vals, idx = _top_k_stable(flat, max_candidates)
    else:
        row_max = masked.amax(dim=-2)                        # (..., F)
        _, rows = _top_k_stable(row_max, rows_needed)        # (..., R)
        sub = torch.gather(
            masked, -1, rows.unsqueeze(-2).expand(*lead, num_times,
                                                  rows_needed))
        flat = sub.transpose(-1, -2).reshape(*lead, -1)      # (..., R*T)
        vals, i2 = _top_k_stable(flat, max_candidates)
        idx = torch.gather(rows, -1, i2 // num_times) * num_times \
            + i2 % num_times
    abs_freq = (idx // g.num_times).to(torch.int32)
    abs_time = (g.t_start + idx % g.num_times).to(torch.int32)
    return abs_time, abs_freq, vals, torch.isfinite(vals)


def find_candidates(scores: torch.Tensor, g: SearchGrid, max_candidates: int,
                    min_score: float):
    """Top-K candidates over a frequency-major (..., num_freqs, num_times)
    grid, as the JAX ``find_candidates``: the row screen takes the
    frequency rows with the largest maxima over time, and the flat index
    is f * num_times + t with ties to the lowest, exactly as
    :func:`find_candidates_tf` on the transposed grid."""
    return find_candidates_tf(scores.transpose(-1, -2), g, max_candidates,
                              min_score)
