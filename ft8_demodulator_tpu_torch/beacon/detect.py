"""Known-payload beacon detection and coherent tracking.

Port of ``ft8_demodulator_tpu/beacon/detect.py``.  When the payload is
known, all 79 symbols of its tone track are sync: the detector correlates
the waterfall's linear power with the full track (~10 log10(79/21) dB of
detection reach over the Costas cells alone) and needs no decode.  At grid
point (t, f), with per-cell linear powers P,

    D(t, f) = sum_s [ P(f + track[s] phi, t + s tau)
                      - (1/8) sum_j P(f + j phi, t + s tau) ]

is normalised to unit noise variance, z = D / sqrt(0.875 count var(P)).
R slot-aligned repeats average their linear grids first (noise-floor
equalised, as the stacked decoder does): z grows ~sqrt(R).

``track_known_payload`` verifies the track fully coherently at a
predicted position (the satellite model's frequency and the slot timing,
or the previous cycle's fix): the best (dt, df) of the normalised coherent
energy over a small search box.

Both host entry points run on the card unless the caller asks for the
CPU; their stages run in range ``ft8.detect``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.gfsk import _payload_tones
from ..ops.llr import _analytic
from ..ops.sync import SearchGrid, _cells, _pad_and_tone_sum, _top_k_stable, \
    _z_normalise, search_grid
from ..ops.waterfall import WaterfallParams, waterfall_params
from ..protocol import constants as C
from ..utils.device import entry_device
from ..utils.profiling import span

__all__ = ["KnownDetection", "TrackFix", "known_track_scores",
           "detect_known_payload", "track_known_payload"]


class KnownDetection(NamedTuple):
    """One detection of the known track."""

    time_sec: float
    freq_hz: float
    z: float          # unit-variance detection score (noise only: ~N(0,1))


def _track_masks(g: SearchGrid) -> tuple[np.ndarray, np.ndarray]:
    """(79, num_times) per-cell validity + (num_times,) counts (host)."""
    t = g.t_start + np.arange(g.num_times)
    base = np.floor_divide(t, g.time_osr)
    s = np.arange(C.NUM_SYMBOLS)[:, None]
    valid = (base[None, :] + s >= 0) & (base[None, :] + s < g.num_blocks)
    return valid, valid.sum(axis=0)


def known_track_scores(linpow: torch.Tensor, track, g: SearchGrid
                       ) -> torch.Tensor:
    """Linear power grid (F, T) + known track (79,) tone ids -> z grid
    (num_freqs, num_times).

    The stencil of ``ops/sync.py sync_scores_z`` over all 79 symbols, the
    on-track row of symbol s offset by track[s] * freq_osr; the terms are
    added in the JAX function's order, and the z normalisation is the
    same.  The 79 tone ids are read to the host once.
    """
    tones = [int(v) for v in torch.as_tensor(track).reshape(-1).tolist()]
    padded, s8, left = _pad_and_tone_sum(linpow, g)
    valid, count = _track_masks(g)
    valid_t = torch.as_tensor(valid, dtype=torch.float32,
                              device=linpow.device)
    total = linpow.new_zeros((g.num_freqs, g.num_times))
    for s in range(C.NUM_SYMBOLS):
        start = left + g.t_start + s * g.time_osr
        total = total + valid_t[s] * (
            _cells(padded, tones[s] * g.freq_osr, start, g)
            - _cells(s8, 0, start, g) * 0.125)
    return _z_normalise(total, linpow, count)


def _detect_grid(waves: torch.Tensor, track, p: WaterfallParams,
                 num_frames: int, is_complex: bool, top_k: int):
    """(R, n[, 2]) repeats -> the top_k (z, abs_time, abs_freq) of the
    known-track z grid over the stacked linear power."""
    from ..demod.stack import _stacked_power_and_spec

    linpow, _, _ = _stacked_power_and_spec(waves, p, num_frames, is_complex,
                                           equalize=waves.shape[0] > 1)
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    z = known_track_scores(linpow, track, g)
    vals, idx = _top_k_stable(z.reshape(-1), top_k)
    return vals, g.t_start + idx % g.num_times, idx // g.num_times


def detect_known_payload(waves, sample_rate: float, payload,
                         bins_per_tone: int = 2, steps_per_symbol: int = 2,
                         top_k: int = 4, min_z: float = 6.0,
                         device: str | torch.device = "cuda"
                         ) -> list[KnownDetection]:
    """Find a known transmission's (time, frequency) without decoding.

    ``waves``: (n,) or (R, n) real or complex, or (R, n, 2) [re, im]; R
    slot-aligned repeats average their linear power grids.  ``payload``:
    the known 10-byte payload.  Returns the detections with z >= min_z,
    strongest first (ties to the lowest (freq, time) index).
    """
    from ..demod.stack import as_device_stack

    device = entry_device(device)
    wave_d, is_complex = as_device_stack(waves, device)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if wave_d.shape[1] < p.nperseg:
        return []
    num_frames = p.num_frames(wave_d.shape[1])
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    if g.num_times <= 0 or g.num_freqs <= 0:
        return []
    with span("ft8.detect"):
        track = _payload_tones(payload, device)
        top_k = min(top_k, g.num_times * g.num_freqs)
        zs, ts, fs_ = (a.cpu().numpy() for a in _detect_grid(
            wave_d, track, p, num_frames, is_complex, top_k))
    hop_seconds = C.SYMBOL_PERIOD_S / p.time_osr
    freq_step = C.TONE_SPACING_HZ / p.freq_osr
    return [KnownDetection(time_sec=float(t) * hop_seconds,
                           freq_hz=float(f) * freq_step, z=float(z))
            for z, t, f in zip(zs, ts, fs_) if float(z) >= min_z]


# ---------------------------------------------------------------------------
# coherent tracking with a position prior

class TrackFix(NamedTuple):
    """One coherent verification of the known track at a predicted spot."""

    detected: bool
    stat: float       # normalised coherent energy (noise-only mean ~6.5)
    time_sec: float   # refined start time
    freq_hz: float    # refined base-tone frequency (incl. sub-bin df)


def _linspace_folded(half: float, num: int) -> np.ndarray:
    """``jnp.linspace(-half, half, num)`` as a jitted function with static
    endpoints computes it, in float32: XLA turns i / div into i *
    fl32(1/div) and folds stop * fl32(1/div) into one constant:
    start * (1 - i r) + i fl32(stop r), the last value exactly ``stop``."""
    div = num - 1
    i = np.arange(div, dtype=np.float32)
    start, stop = np.float32(-half), np.float32(half)
    r = np.float32(1.0 / div)
    out = start * (np.float32(1.0) - i * r) + i * np.float32(stop * r)
    return np.append(out, stop).astype(np.float32)


def _track_stat(wave: torch.Tensor, track: torch.Tensor, start0: int,
                f0_cps: float, sps: int, is_complex: bool,
                df_half_cps: float = 0.096):
    """Max over (dt, df) of the normalised coherent track energy: (stat,
    dt samples, df cycles/symbol) 0-d tensors.

    ``wave``: (n,) real or (n, 2) [re, im]; ``track`` (79,) tone ids;
    ``start0``: sample of symbol 0; ``f0_cps``: base-tone frequency in
    cycles per sample.  The 79 symbols integrate fully coherently: per dt
    step (9 over +-sps/2) the on-track symbol correlations, the hint's
    per-symbol phase step removed, against a df ramp grid of
    ``df_half_cps`` (~4 points per coherence lobe), normalised by the
    median symbol power / ln 2.  Sums of products are float64, rounded to
    float32 where the JAX function's values are float32; picks are first
    maxima.
    """
    dev = wave.device
    if is_complex:
        x = torch.view_as_complex(wave.to(torch.float32).contiguous())
    else:
        x = _analytic(wave)
    n_sig = C.NUM_SYMBOLS * sps
    xp = torch.nn.functional.pad(x, (n_sig, n_sig))
    f32 = np.float32
    two_pi = f32(-2.0 * np.pi)
    f0 = torch.tensor(f0_cps, dtype=torch.float32, device=dev)
    ns = torch.arange(sps, dtype=torch.float32, device=dev)
    # the division by sps is XLA's multiply by fl32(1/sps)
    freqs = f0 + track.to(torch.float32) * f32(1.0 / sps)          # (79,)
    ang = (two_pi * freqs)[:, None] * ns[None, :]                  # (79, sps)
    mix = torch.polar(torch.ones_like(ang), ang).to(torch.complex128)

    h = (sps // 8) * 4
    dts = torch.arange(-h, h + 1, sps // 16, device=dev)
    t_sym = torch.arange(C.NUM_SYMBOLS, dtype=torch.float32, device=dev)
    # the mix restarts its phase at each window, leaving the hint's
    # residual step of frac(f0 * sps) cycles per symbol: removed up front
    step0 = torch.remainder(f0 * f32(sps), 1.0)
    ang_hint = (two_pi * step0) * t_sym
    hint = torch.polar(torch.ones_like(ang_hint), ang_hint)         # (79,)
    n_df = int(np.ceil(2 * df_half_cps * 4 * C.NUM_SYMBOLS)) | 1
    dfs = torch.as_tensor(_linspace_folded(df_half_cps, n_df), device=dev)
    ramp = (two_pi * dfs)[:, None] * t_sym[None, :]                 # (D, 79)
    rot = torch.polar(torch.ones_like(ramp), ramp).to(torch.complex128)

    starts = torch.clamp(start0 + n_sig + dts, 0, xp.shape[0] - n_sig)
    idx = starts[:, None, None] + torch.arange(
        C.NUM_SYMBOLS, device=dev)[:, None] * sps + ns.to(torch.int64)
    win = xp[idx].to(torch.complex128)                     # (9, 79, sps)
    z0 = (win * mix).sum(-1).to(torch.complex64)           # (9, 79)
    z = z0 * hint
    zr, zi = z.real, z.imag
    power = zr * zr + zi * zi
    noise = torch.sort(power, dim=-1).values[:, C.NUM_SYMBOLS // 2] \
        * f32(1.0 / 0.6931)
    s = (z.to(torch.complex128) @ rot.T).to(torch.complex64)       # (9, D)
    e = s.real * s.real + s.imag * s.imag
    i = torch.argmax(e, dim=-1)                            # first maxima
    stats = e.gather(1, i[:, None])[:, 0] / (
        C.NUM_SYMBOLS * torch.clamp(noise, min=1e-30))
    j = torch.argmax(stats)
    return stats[j], dts[j], dfs[i[j]]


def track_known_payload(wave, sample_rate: float, payload,
                        time_hint_s: float, freq_hint_hz: float,
                        threshold: float = 15.0,
                        freq_tolerance_hz: float = 0.6,
                        device: str | torch.device = "cuda") -> TrackFix:
    """Coherent beacon tracking at a predicted position (host API).

    With the payload known and a position prior, all 79 track symbols
    integrate fully coherently over the local (+-half symbol,
    +-``freq_tolerance_hz``) box.  ``wave``: (n,) real or complex, or
    (n, 2) [re, im].  ``threshold`` is on the normalised coherent energy
    (noise only: mean ~6.5).  Returns the refined (time, frequency) fix,
    rounded as the JAX function rounds it.
    """
    device = entry_device(device)
    wave = np.asarray(wave)
    is_complex = bool(np.iscomplexobj(wave))
    if is_complex:
        wave = np.stack([wave.real, wave.imag], -1)
    elif wave.ndim == 2 and wave.shape[-1] == 2:
        is_complex = True
    wave_d = torch.as_tensor(wave.astype(np.float32), device=device)
    sps = waterfall_params(sample_rate, 2, 2).nperseg
    start0 = int(round(time_hint_s * sample_rate))
    with span("ft8.detect"):
        stat, dt, df = _track_stat(
            wave_d, _payload_tones(payload, device), start0,
            float(np.float32(float(freq_hint_hz) / sample_rate)), sps,
            is_complex, df_half_cps=float(freq_tolerance_hz)
            * C.SYMBOL_PERIOD_S)
    stat = float(stat)
    t_fix = (start0 + int(dt)) / sample_rate
    f_fix = freq_hint_hz + float(df) / C.SYMBOL_PERIOD_S
    return TrackFix(detected=stat >= threshold, stat=round(stat, 2),
                    time_sec=round(t_fix, 4), freq_hz=round(f_fix, 2))
