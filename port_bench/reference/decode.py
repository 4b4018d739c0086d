"""The plain reference decoder: the two entries the benchmark's window
drives, with the same semantics and none of the program's code.

* :func:`decode_slots`: batched 15-s slots -> every candidate's (time,
  freq, score, valid) and decode, as ``decode_slots`` computes them: the
  waterfall (dB grid, and with ``mf_first`` the boxcar grid) -> sync ->
  top-K -> Hann or matched-filter LLRs -> BP -> CRC (-> OSD);
* :func:`decode_capture`: one capture -> the rows ``decode_ft8_message``
  reports for one pass without crops: the float64 waterfall -> sync ->
  top-K -> Hann LLRs -> BP (+ OSD), with ``use_mf`` the matched-filter
  retry of the failed candidates from the block spectra, then the SNR
  estimate, the implausible-SNR drop and the de-duplication by payload.

``precision`` is the DFT's (:data:`front.PRECISIONS`).  Run under
:func:`exact_float32` so that no float32 product runs in TF32.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from . import front, ldpc
from .tx import encode_tones

__all__ = ["SlotDecode", "Row", "exact_float32", "decode_slots",
           "decode_capture"]


class SlotDecode(NamedTuple):
    """(B, K) candidate rows: on the device."""

    abs_time: torch.Tensor
    abs_freq: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor
    success: torch.Tensor
    payload: torch.Tensor      # (B, K, 10) uint8
    scores: torch.Tensor       # (B, num_times, num_freqs): the whole grid
    grid: front.SearchGrid


class Row(NamedTuple):
    """One reported decode, as the host API's row carries it."""

    payload: bytes
    time_s: float
    freq_hz: float
    score: float
    snr_db: float


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products in full float32 (TF32 off) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def decode_slots(waves: torch.Tensor, fs: float, cfg: dict, mf_first: bool,
                 precision: str = "bf16", dtype=torch.float32,
                 tb: ldpc.Tables | None = None) -> SlotDecode:
    """(B, n) float32 slots -> :class:`SlotDecode`.  ``cfg``: the
    configuration's bins_per_tone, steps_per_symbol, max_candidates,
    min_score, max_iterations, use_osd.  ``precision``: the DFT's;
    ``dtype``: everything's from the power on (scores float32 out)."""
    p = front.geometry(fs, cfg["bins_per_tone"], cfg["steps_per_symbol"])
    nf = p.num_frames(waves.shape[-1])
    g = front.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    tb = tb or ldpc.tables(waves.device)
    spec = front.block_spectra(waves, p, nf, precision)
    mag = front.db_grid_tf(spec, p, nf, dtype)
    scores = front.sync_scores_tf(mag, g)
    t, f, s, valid = front.find_candidates_tf(scores, g, cfg["max_candidates"],
                                              float(cfg["min_score"]))
    if mf_first:
        llrs = front.llrs_mf_grid(front.boxcar_grid_tf(spec, p, nf, dtype), t,
                                  f, g)
    else:
        llrs = front.llrs_hann_tf(mag, t, f, g)
    b, k = t.shape
    dec = ldpc.finish_decode(llrs.reshape(b * k, C.LDPC_N), valid.reshape(-1),
                             cfg["max_iterations"], cfg["use_osd"], tb)
    return SlotDecode(t, f, s.float(), valid, dec.success.reshape(b, k),
                      dec.payload.reshape(b, k, C.PAYLOAD_BYTES),
                      scores.float(), g)


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _snr_db(mag_tf: torch.Tensor, payload: torch.Tensor, abs_time, abs_freq,
            g: front.SearchGrid) -> torch.Tensor:
    """(K,) SNR in dB re 2,500 Hz: the mean on-track cell power of each
    re-encoded payload over the grid's median power (divided by ln 2's
    median-to-mean ratio of an exponential, Wilson-Hilferty)."""
    num_frames, num_freqs = mag_tf.shape
    tau, phi = g.time_osr, g.freq_osr
    dev = mag_tf.device
    tones = encode_tones(payload)
    t_idx = abs_time.to(torch.int64)[:, None] \
        + torch.arange(C.NUM_SYMBOLS, device=dev) * tau
    f64 = abs_freq.to(torch.int64)
    valid = (t_idx >= 0) & (t_idx < num_frames) \
        & (f64 + 7 * phi < num_freqs)[:, None]
    on_db = mag_tf[t_idx.clamp(0, num_frames - 1),
                   (f64[:, None] + tones * phi).clamp(0, num_freqs - 1)]
    w = valid.to(torch.float32)
    s_hat = (10.0 ** (on_db / 10.0) * w).sum(-1) / torch.clamp(w.sum(-1),
                                                               min=1.0)
    noise = 10.0 ** (_median(mag_tf) / 10.0) / (1.0 - 1.0 / 9.0) ** 3
    r = s_hat / torch.clamp(noise, min=1e-30)
    return 10.0 * torch.log10(torch.clamp(r - 1.0, min=1e-6) * 3.75e-3)


def decode_capture(wave: np.ndarray, fs: float, cfg: dict, device,
                   precision: str = "float64", dtype=torch.float32,
                   min_snr_db: float = -26.0) -> list[Row]:
    """One real capture (numpy) -> its rows, in candidate order.
    ``precision``: the DFT's; ``dtype``: everything's from the power on."""
    p = front.geometry(fs, cfg["bins_per_tone"], cfg["steps_per_symbol"])
    x = torch.as_tensor(np.asarray(wave, np.float32), device=device)
    nf = p.num_frames(x.shape[-1])
    g = front.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    tb = ldpc.tables(device)
    spec = front.block_spectra(x, p, nf, precision)
    mag = front.db_grid_tf(spec, p, nf, dtype)
    t, f, s, valid = front.find_candidates_tf(
        front.sync_scores_tf(mag, g), g, cfg["max_candidates"],
        float(cfg["min_score"]))
    dec = ldpc.finish_decode(front.llrs_hann_tf(mag, t, f, g), valid,
                             cfg["max_iterations"], cfg["use_osd"], tb)
    if cfg["use_mf"]:
        retry = ldpc.finish_decode(front.llrs_mf_blocks(spec, t, f, g, dtype),
                                   valid,
                                   cfg["max_iterations"], cfg["use_osd"], tb)
        take = ~dec.success & retry.success
        dec = ldpc.Decoded(dec.success | retry.success,
                           torch.where(take[:, None], retry.payload,
                                       dec.payload),
                           torch.where(take, retry.crc, dec.crc),
                           torch.where(take, retry.ldpc_errors,
                                       dec.ldpc_errors))
    snr = _snr_db(mag, dec.payload, t, f, g).float().cpu().numpy()
    hop_s = C.SYMBOL_PERIOD_S / p.time_osr
    step_hz = C.TONE_SPACING_HZ / p.freq_osr
    success, payload = dec.success.cpu().numpy(), dec.payload.cpu().numpy()
    t, f, s = t.cpu().numpy(), f.cpu().numpy(), s.float().cpu().numpy()
    rows, seen = [], set()
    for k in np.flatnonzero(success):
        if min_snr_db is not None and float(snr[k]) < min_snr_db:
            continue
        pl = bytes(payload[k].tolist())
        if pl in seen:
            continue
        seen.add(pl)
        rows.append(Row(pl, float(t[k]) * hop_s, float(f[k]) * step_hz,
                        float(s[k]),
                        round(min(max(float(snr[k]), -30.0), 30.0), 1)))
    return rows
