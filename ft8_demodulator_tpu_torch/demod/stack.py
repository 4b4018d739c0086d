"""Cross-transmission (beacon) stacking decoder.

Port of ``ft8_demodulator_tpu/demod/stack.py``.  A beacon transmits the
same payload every 15-s cycle, so R slot-aligned captures are R
independent noncoherent looks at one transmission.  For noncoherent FSK
under independent noise the summed per-tone energy is the sufficient
statistic: the decoder averages linear waterfall powers over the repeats
for the candidate search and averages matched-filter symbol powers for the
LLRs, then decodes once.  R > 1 repeats are noise-floor equalised first
(receiver gain changes between cycles) and dead (silent) repeats weigh 0.

Repeats must be slot-aligned and frequency-stable to a fraction of a tone;
on a drifting channel drift-correct each repeat first
(``beacon.correct_frequency_drift``) and stack the complex results, which
arrive as (R, n) complex or (R, n, 2) [re, im].

R > 1 stacks score candidates with the linear-power Costas z statistic
(``ops/sync.py sync_scores_z``, range ``ft8.sync_z``); R == 1 keeps the
reference dB stencil (the frequency-major stencil kernel, ``ft8.sync``).
The stacked power and spectra run in range ``ft8.stack``, the ring's upload
and the live-repeat read in ``ft8.stack.wait``; the coherent retry counts
the candidates it ran (``coherent.rows``) and those it decoded that the
first pass did not (``coherent.accepted``), on the card while a profiler
records.  The BP, CRC and OSD tables and the LLR constants come from the
per-device caches of ``ops/`` (``protocol/tables.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.llr import (extract_llrs, extract_llrs_coherent_stacked,
                       extract_llrs_matched_blocks_stacked,
                       extract_llrs_matched_stacked)
from ..ops.sync import find_candidates, search_grid, sync_scores_z
from ..ops.sync_cuda import sync_scores_kernel
from ..ops.waterfall import (_DB_FLOOR, WaterfallParams, _as_complex,
                             _block_power, _block_spectrum, _db_scale,
                             _pick_backend, _power_spectrum, frame_signal,
                             waterfall_params)
from ..protocol import constants as C
from ..utils.device import entry_device
from ..utils.profiling import count_on_card, host_wait, recording, span
from .decode import (_format_results, _merge_results, _refine_rows,
                     ap_arrays, ap_retry_llrs, estimate_snr, finish_decode,
                     variant_retry)
from .types import FT8Decode, SlotDecodeResult

__all__ = ["decode_slot_stacked", "decode_ft8_stacked", "as_device_stack"]


def _row_median(x: torch.Tensor) -> torch.Tensor:
    """Per-row median of (R, N), the mean of the two middle values for an
    even N (``jnp.median``; ``torch.median`` takes the lower)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5


def _stacked_power_and_spec(waves: torch.Tensor, p: WaterfallParams,
                            num_frames: int, is_complex: bool,
                            equalize: bool = False):
    """(R, n[, 2]) repeats -> (mean linear power grid (F, T), per-repeat
    complex block spectra (R, nb, Kx) or None, per-repeat weights (R,) or
    None).

    Block spectra are returned where the block backend applies, so that
    the matched filter reuses them.  ``equalize`` weights each repeat by
    1 / its noise floor (the median of its linear power grid: a
    transmission fills a few of ~200 rows, so the median does not see it
    at any SNR), normalised to mean 1; a repeat whose floor is below 1e-9
    of the loudest (recorded silence, a ring not yet full) weighs 0, so
    the stack is the mean over the live repeats.  The spectra carry
    sqrt(weight), and the weights are returned for the audio consumers.
    """
    x = _as_complex(waves) if is_complex else waves
    backend = _pick_backend(p, None)
    if backend == "block":
        spec = _block_spectrum(x, p, num_frames)
        power = _block_power(spec, p, num_frames)          # (R, T, K)
    else:
        spec = None
        power = _power_spectrum(frame_signal(x, p.nperseg, p.hop,
                                             num_frames), p, backend)
    weights = None
    if equalize:
        noise = _row_median(power.reshape(power.shape[0], -1))    # (R,)
        dead = noise <= 1e-9 * noise.max()
        w = torch.where(dead, 0.0, 1.0 / torch.clamp(noise, min=1e-30))
        weights = w / torch.clamp(w.mean(), min=1e-30)
        power = power * weights[:, None, None]
        if spec is not None:
            spec = spec * torch.sqrt(weights)[:, None, None]
    return ((power.mean(0) * _db_scale(p)).transpose(0, 1).contiguous(),
            spec, weights)


def _decode_slot_stacked_with_mag(waves: torch.Tensor, p: WaterfallParams,
                                  num_frames: int, max_candidates: int,
                                  min_score: float, max_iterations: int,
                                  is_complex: bool, use_osd: bool,
                                  use_mf: bool, ap_values=None, ap_mask=None,
                                  coherent: bool = False, min_z=2.0):
    """:func:`decode_slot_stacked`'s core; also returns the stacked dB grid
    (F, T) for the SNR estimate.

    R > 1: the linear Costas z statistic thresholded by ``min_z``; R == 1:
    the reference dB stencil and ``min_score``.  ``ap_values`` /
    ``ap_mask`` (V, 77): optional a-priori hypotheses clamped into the
    matched-filter LLRs.  R > 1 repeats are equalised, and the same
    weights scale the audio of the coherent retry.
    """
    r = waves.shape[0]
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    with span("ft8.stack"):
        power, spec, weights = _stacked_power_and_spec(
            waves, p, num_frames, is_complex, equalize=r > 1)
        if weights is not None:
            waves = waves * torch.sqrt(weights).reshape(
                (r,) + (1,) * (waves.ndim - 1))
        mag = 10.0 * torch.log10(_DB_FLOOR + power)
    if r > 1:
        with span("ft8.sync_z"):
            scores = sync_scores_z(power, g)
        thresh = min_z
    else:
        with span("ft8.sync"):
            scores = sync_scores_kernel(mag, g)
        thresh = min_score
    with span("ft8.top_k"):
        abs_time, abs_freq, score, cand_valid = find_candidates(
            scores, g, max_candidates, thresh)
    with span("ft8.llrs"):
        if not use_mf:
            llrs = extract_llrs(mag, abs_time, abs_freq, p.time_osr,
                                p.freq_osr, g.num_blocks)
        elif spec is not None:
            llrs = extract_llrs_matched_blocks_stacked(
                spec, abs_time, abs_freq, p.time_osr, p.freq_osr)
        else:
            llrs = extract_llrs_matched_stacked(
                waves, abs_time, abs_freq, p.nperseg, p.hop, p.freq_osr,
                is_complex)
    res = finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                        max_iterations, use_osd)
    if coherent:
        # per-repeat carrier phases, one (dt, df) search over the repeats,
        # the projected powers summed noncoherently
        with span("ft8.coherent"):
            cllrs = extract_llrs_coherent_stacked(
                waves, abs_time, abs_freq, p.nperseg, p.hop, p.freq_osr,
                is_complex)
        retry = variant_retry(cllrs, res, max_iterations, use_osd)
        if recording():
            count_on_card("coherent.rows", res.candidate_valid)
            count_on_card("coherent.accepted", ~res.success & retry.success)
        res = _merge_results(res, retry)
    if ap_values is not None:
        with span("ft8.ap"):
            res = _merge_results(res, ap_retry_llrs(
                llrs, res, ap_values, ap_mask, max_iterations, use_osd))
    return res, mag


def decode_slot_stacked(waves, p: WaterfallParams,
                        num_frames: int, max_candidates: int = 20,
                        min_score: float = 10.0, max_iterations: int = 20,
                        is_complex: bool = False,
                        use_osd: bool = False,
                        use_mf: bool = True,
                        coherent: bool = False,
                        min_z: float = 2.0,
                        device: str | torch.device = "cuda"
                        ) -> SlotDecodeResult:
    """R slot-aligned repeats (R, n[, 2]) of one transmission -> decode
    (K rows), on the device of ``waves`` (host repeats go to ``device``
    through :func:`as_device_stack`).

    Per-repeat spectra, linear-power averaging, candidate search on the
    stacked grid (R > 1: the linear Costas z statistic thresholded by
    ``min_z``; R == 1: the reference dB stencil and ``min_score``),
    repeat-averaged matched-filter LLRs (``use_mf``, the default) or Hann
    LLRs from the stacked dB grid, BP (+ OSD), CRC, and with ``coherent``
    the stacked coherent retry.  With R == 1 and ``use_mf`` the JAX
    function equals ``decode_slot(mf_first=True)`` row for row.
    """
    if not isinstance(waves, torch.Tensor):
        waves, is_complex = as_device_stack(waves, device)
    res, _ = _decode_slot_stacked_with_mag(
        waves, p, num_frames, max_candidates, min_score, max_iterations,
        is_complex, use_osd, use_mf, coherent=coherent, min_z=float(min_z))
    return res


@span("ft8.stack")
def as_device_stack(waves, device: str | torch.device = "cuda"
                    ) -> tuple[torch.Tensor, bool]:
    """Host repeats -> ((R, n[, 2]) float32 tensor on ``device``,
    is_complex).

    Accepts (R, n) real, (R, n) complex, or (R, n, 2) [re, im] float;
    (n,), (n, 2) and complex (n,) single captures gain a leading R = 1
    axis.  Complex repeats come back as (R, n, 2) [re, im].
    """
    device = entry_device(device)
    waves = np.asarray(waves)
    is_complex = bool(np.iscomplexobj(waves))
    if waves.ndim == 1 or (waves.ndim == 2 and not is_complex
                           and waves.shape[-1] == 2):
        waves = waves[None]
    if is_complex:
        if waves.ndim != 2:
            raise ValueError("complex waves must be (R, n) or (n,)")
        waves = np.stack([waves.real, waves.imag], axis=-1)
    elif waves.ndim == 3 and waves.shape[-1] == 2:
        is_complex = True
    elif waves.ndim != 2:
        raise ValueError("waves must be (R, n) real, (R, n) complex, or "
                         "(R, n, 2) [re, im]: R slot-aligned repeats")
    waves = waves.astype(np.float32)
    with host_wait("ft8.stack.wait"):
        return torch.as_tensor(waves, device=device), is_complex


def decode_ft8_stacked(waves, sample_rate: float,
                       bins_per_tone: int = 2, steps_per_symbol: int = 2,
                       max_candidates: int = 20, min_score: float = 10.0,
                       max_iterations: int = 20,
                       use_osd: bool = False,
                       use_mf: bool = True,
                       deduplicate: bool = True,
                       ap: bool | str = False,
                       coherent: bool = False,
                       min_z: float = 2.0,
                       refine_fixes: bool = False,
                       device: str | torch.device = "cuda"
                       ) -> list[FT8Decode]:
    """Decode one repeated transmission from R stacked slots (host API).

    ``waves``: (R, n) real, (R, n) complex, or (R, n, 2) [re, im], R
    slot-aligned captures of the same transmission; the decode runs on
    ``device`` (the card unless the caller asks for the CPU).  Returns
    FT8Decode rows as ``decode_ft8_message`` does, times and frequencies
    relative to the common slot.  ``ap`` takes the a-priori hypotheses of
    ``decode_ft8_message``; ``min_z`` thresholds R > 1 stacks, ``min_score``
    R == 1.  The SNR is the per-repeat SNR over the live (non-silent)
    repeats, and the plausibility gate deepens by 5 log10(R live).
    ``refine_fixes`` replaces each row's grid-quantised time and frequency
    with a coherent known-payload fix on the newest live repeat.
    """
    device = entry_device(device)
    wave_d, is_complex = as_device_stack(waves, device)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if wave_d.shape[1] < p.nperseg:
        return []
    ap_values, ap_mask = ap_arrays(ap, device) if ap else (None, None)
    num_frames = p.num_frames(wave_d.shape[1])
    res, mag = _decode_slot_stacked_with_mag(
        wave_d, p, num_frames, max_candidates, float(min_score),
        max_iterations, is_complex, use_osd, use_mf, ap_values, ap_mask,
        coherent, min_z=float(min_z))
    # the live repeats: silent rows weigh 0 in the combiner, so the SNR's
    # median correction and the gate scale with the repeats that count
    with host_wait("ft8.stack.wait"):
        live = torch.nonzero(wave_d.flatten(1).any(1)).flatten().tolist()
    r_stack = max(1, len(live))
    snr = estimate_snr(mag, res.payload, res.abs_time, res.abs_freq,
                       p.time_osr, p.freq_osr, stack_r=r_stack)
    freq_step = C.TONE_SPACING_HZ / p.freq_osr
    rows = _format_results(res, C.SYMBOL_PERIOD_S / p.time_osr, freq_step,
                           0.0, 0.0, deduplicate, snr_db=snr,
                           min_snr_db=-26.0 - 5.0 * np.log10(r_stack))
    if refine_fixes and rows:
        newest = live[-1] if live else wave_d.shape[0] - 1
        rows = _refine_rows(rows, wave_d[newest].cpu().numpy(), sample_rate,
                            freq_step, device)
    return rows
