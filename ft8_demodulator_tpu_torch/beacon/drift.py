"""Frequency-drift correction for FT8 beacons through a satellite channel.

Port of ``ft8_demodulator_tpu/beacon/drift.py``, the reference's 4-stage
corrector:

  1. coarse detect: per-column argmax of the complex waterfall; the
     sliding-window linear-fit residual variance as a continuity metric;
     the longest continuous segment wins;
  2. degree-1 fit of the argmax-frequency track -> linear drift rate;
     chirp de-rotation exp(-j 2 pi k t^2 / 2);
  3. fine time sync: the de-rotated argmax track correlated with a
     GFSK-shaped template of the three Costas sequences;
  4. degree-2 fit over the three sync windows; phase-integral compensation
     exp(-j 2 pi (k t^2/2 + a t^3/3)).

The waterfalls and the rotations run on the device
(:func:`correct_drift_tensor`, complex64 in and out); the two argmax tracks
are read back, and the fits and correlations are host numpy, copied from
the JAX module.  :func:`correct_frequency_drift` wraps that core with one
upload and one read-back; ``BeaconSession`` uploads the real cycle and
forms its analytic signal on the device (:func:`analytic_signal`).  The
corrector is range ``ft8.drift``, host work included, its copies between
host and card ``ft8.drift.wait``.  Counters: ``drift.cycles`` (calls),
``drift.locked`` (calls that found a continuous segment) and
``drift.copy_bytes`` (the bytes of those copies).  The rotation's cycle
count is float64 on the device, each operation numpy's, reduced mod 1
before the float32 rotate.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from ..ops.gfsk import gauss_window
from ..ops.waterfall import waterfall_complex, waterfall_params
from ..protocol import constants as C
from ..utils.device import entry_device
from ..utils.profiling import count, host_wait, span

logger = logging.getLogger(__name__)

__all__ = ["DEFAULT_PARAMS", "detect_signal_continuity",
           "correct_frequency_drift", "apply_polynomial_drift"]

DEFAULT_PARAMS: dict = {
    "nsync_sym": 7,
    "ndata_sym": 58,
    "debug_plots": False,
    "window_size_factor": 4,      # window = factor * steps_per_symbol
    "max_variance_factor": 0.0001,  # threshold = factor * freq_bins^2
    "fit_middle_percent": 100,
    "bins_per_tone": 2,
    "steps_per_symbol": 2,
    "poly_degree": 2,
    "precise_sync": True,
}


# ---------------------------------------------------------------------------
# stage 1: continuity detection (host)
# ---------------------------------------------------------------------------

def _sliding_residual_variance(y: np.ndarray, window: int) -> np.ndarray:
    """Residual variance of a per-window linear fit, all windows at once:
    var = (Syy_c - Sxy_c^2 / Sxx) / W with centred sliding sums."""
    w = window
    x = np.arange(w, dtype=np.float64)
    sxx = np.sum((x - x.mean()) ** 2)
    ones = np.ones(w)
    s_y = np.convolve(y, ones, mode="valid")
    s_yy = np.convolve(y * y, ones, mode="valid")
    # sliding dot with x requires the kernel reversed for convolve
    s_xy = np.convolve(y, x[::-1], mode="valid")
    syy_c = s_yy - s_y * s_y / w
    sxy_c = s_xy - x.mean() * s_y
    var = (syy_c - sxy_c * sxy_c / sxx) / w
    return np.maximum(var, 0.0)


def detect_signal_continuity(max_freq_indices: np.ndarray,
                             window_size: int = 8,
                             max_variance: float = 10.0):
    """(segments, continuity_metric): metric[i] = -variance of the linear
    fit over indices [i, i+window); segments are maximal runs where the
    metric exceeds -max_variance."""
    y = np.asarray(max_freq_indices, dtype=np.float64)
    if len(y) < window_size:
        return [], np.zeros(len(y))
    metric = -_sliding_residual_variance(y, window_size)
    is_signal = metric > -max_variance

    segments = []
    in_seg = False
    start = 0
    for i, flag in enumerate(is_signal):
        if flag and not in_seg:
            in_seg, start = True, i
        elif not flag and in_seg:
            in_seg = False
            if i - start >= 1:
                segments.append((start, i))
    if in_seg:
        segments.append((start, len(max_freq_indices) - 1))
    logger.debug("Detected signal segments: %s", segments)
    return segments, metric


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``: one of the corrector's copies."""
    with host_wait("ft8.drift.wait"):
        x = torch.as_tensor(a, device=device)
    count("drift.copy_bytes", a.nbytes)
    return x


def to_host(x: torch.Tensor) -> np.ndarray:
    """Tensor -> host array: one of the corrector's copies."""
    with host_wait("ft8.drift.wait"):
        a = x.cpu().numpy()
    count("drift.copy_bytes", a.nbytes)
    return a


@functools.lru_cache(maxsize=4)
def _hilbert_weights(n: int, device: torch.device) -> torch.Tensor:
    """scipy.signal.hilbert's spectrum weights: 1 at DC (and Nyquist for
    even n), 2 on the positive bins, 0 on the negative ones."""
    h = torch.zeros(n, dtype=torch.float64, device=device)
    h[0] = 1.0
    h[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        h[n // 2] = 1.0
    return h


def analytic_signal(x: torch.Tensor) -> torch.Tensor:
    """Real (n,) -> its analytic signal, complex128 on ``x``'s device:
    ``scipy.signal.hilbert``'s algorithm (the float64 FFT, the negative
    frequencies zeroed and the positive ones doubled, the inverse FFT)."""
    spec = torch.fft.fft(x.to(torch.float64))
    return torch.fft.ifft(spec * _hilbert_weights(x.shape[-1], x.device))


@functools.lru_cache(maxsize=4)
def _time_axis(n: int, fs: float, device: torch.device):
    """(t, 2, 3): t = arange(n) / fs in float64 on ``device``, and the
    phase's divisors as float64 device scalars.  On the card a division
    by a host number is a product with its reciprocal, which is not
    numpy's division; by a device scalar it is the division."""
    f64 = functools.partial(torch.tensor, dtype=torch.float64, device=device)
    t = torch.arange(n, dtype=torch.float64, device=device) / f64(fs)
    return t, f64(2.0), f64(3.0)


def _phase_cycles(n: int, rate_hz_per_s: float, acc_hz_per_s2: float,
                  fs: float, device: torch.device) -> torch.Tensor:
    """The drift's float64 cycle count k t^2/2 + a t^3/3 reduced mod 1,
    float32 on ``device``: numpy's separate operations in numpy's order,
    so equal to the host formula bit for bit."""
    t, two, three = _time_axis(n, float(fs), device)
    phase = (float(rate_hz_per_s) * t * t / two
             + float(acc_hz_per_s2) * t * t * t / three)
    return (phase - torch.floor(phase)).to(torch.float32)


def _apply_phase_cycles(wave: torch.Tensor, cyc: torch.Tensor
                        ) -> torch.Tensor:
    """Complex64 samples times exp(-j 2 pi cyc)."""
    ang = np.float32(-2.0 * np.pi) * cyc
    return wave * torch.polar(torch.ones_like(ang), ang)


def apply_polynomial_drift(wave_ri, rate_hz_per_s: float,
                           acc_hz_per_s2: float, fs: float,
                           device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """y = x * exp(-j 2 pi (k t^2/2 + a t^3/3)), the drift phase integral
    (acc = 0 for the linear stage), on ``device``.

    ``wave_ri``: (n, 2) [re, im] (returned so, float32) or complex
    (returned complex64), numpy or a tensor.  The cumulative phase reaches
    ~1e6 cycles on long, fast captures, where float32 loses a sizeable
    fraction of a cycle: the cycle count is float64 on the device, reduced
    mod 1 before the float32 rotate.
    """
    device = entry_device(device)
    x = torch.as_tensor(wave_ri, device=device)
    as_pair = not x.is_complex()
    z = torch.view_as_complex(x.to(torch.float32).contiguous()) if as_pair \
        else x.to(torch.complex64)
    cyc = _phase_cycles(z.shape[-1], rate_hz_per_s, acc_hz_per_s2, fs,
                        z.device)
    out = _apply_phase_cycles(z, cyc)
    return torch.view_as_real(out) if as_pair else out


def _argmax_track(wave: torch.Tensor, fs: float, bins_per_tone: int,
                  steps_per_symbol: int):
    """Per-frame argmax (first maximum) of the positive-frequency complex
    waterfall of complex64 ``wave``: (track (T,) numpy, freq bins,
    geometry)."""
    p = waterfall_params(fs, bins_per_tone, steps_per_symbol)
    num_frames = p.num_frames(wave.shape[-1])
    mag = waterfall_complex(wave, p, num_frames)
    return to_host(torch.argmax(mag, dim=0)), mag.shape[0], p


# ---------------------------------------------------------------------------
# the corrector
# ---------------------------------------------------------------------------

def _polyfit(x: np.ndarray, y: np.ndarray, degree: int) -> np.ndarray:
    """Least-squares polynomial fit; returns coefficients [c0, c1, ...]."""
    v = np.vander(x, degree + 1, increasing=True)
    coefs, *_ = np.linalg.lstsq(v, y, rcond=None)
    return coefs


@span("ft8.drift")
def correct_frequency_drift(wave_complex, fs: float,
                            sym_bin: float = C.TONE_SPACING_HZ,
                            sym_t: float = C.SYMBOL_PERIOD_S,
                            params: dict | None = None,
                            return_model: bool = False,
                            device: str | torch.device = "cuda"):
    """Estimate and remove frequency drift from a complex capture, on
    ``device`` (the card unless the caller asks for the CPU).

    Returns (corrected_wave, drift_rate_per_sample) as numpy, the input's
    convention (complex64, or stacked (n, 2) [re, im] float32).
    ``return_model`` appends the fitted model: ``f_center_hz`` (mean
    frequency of the detected track after the linear stage),
    ``sync_time_s`` (stage-3 fine time sync), ``rate_hz_per_s`` /
    ``acc_hz_per_s2`` (stage-4 polynomial) and ``segment_s`` (detected
    span); fields are None on the failure paths that fall back to earlier
    stages.  The work is :func:`correct_drift_tensor`'s, between one
    upload of the capture as complex64 and one read-back.
    """
    device = entry_device(device)
    wave_in = np.asarray(wave_complex)
    complex_in = np.iscomplexobj(wave_in)
    if complex_in:
        ri = np.stack([wave_in.real, wave_in.imag], -1).astype(np.float32)
    else:
        ri = wave_in.astype(np.float32)
    z = torch.view_as_complex(to_device(ri, device))
    zc, rate, model = correct_drift_tensor(z, fs, sym_bin, sym_t, params)
    r = to_host(zc if complex_in else torch.view_as_real(zc))
    return (r, rate, model) if return_model else (r, rate)


def correct_drift_tensor(z: torch.Tensor, fs: float,
                         sym_bin: float = C.TONE_SPACING_HZ,
                         sym_t: float = C.SYMBOL_PERIOD_S,
                         params: dict | None = None):
    """:func:`correct_frequency_drift` on a complex64 (n,) tensor, on its
    device: (the corrected complex64 tensor there, the drift rate per
    sample, the model).  Its copies are the two argmax tracks' read-backs;
    the caller times it inside its own ``ft8.drift`` span."""
    p = dict(DEFAULT_PARAMS)
    if params:
        p.update(params)
    device = z.device
    count("drift.cycles")

    model: dict = {"f_center_hz": None, "sync_time_s": None,
                   "rate_hz_per_s": None, "acc_hz_per_s2": None,
                   "segment_s": None}

    bins_per_tone = p["bins_per_tone"]
    steps_per_symbol = p["steps_per_symbol"]
    window_size = p["window_size_factor"] * steps_per_symbol

    # ---- stage 1: coarse detection on the argmax track
    track, freq_bins, wfp = _argmax_track(z, fs, bins_per_tone,
                                          steps_per_symbol)
    max_variance = p["max_variance_factor"] * freq_bins ** 2
    segments, _metric = detect_signal_continuity(track, window_size,
                                                 max_variance)
    count("drift.locked", int(bool(segments)))
    if not segments:
        logger.warning("No continuous signal segments detected, "
                       "returning original signal")
        return z, 0.0, model

    start_idx, end_idx = max(segments, key=lambda s: s[1] - s[0])

    freq_step = sym_bin / wfp.freq_osr
    time_step = sym_t / wfp.time_osr
    model["segment_s"] = (start_idx * time_step, end_idx * time_step)
    max_freqs = track.astype(np.float64) * freq_step
    time_axis = np.arange(len(max_freqs)) * time_step

    # ---- stage 2: linear drift fit + first chirp compensation
    seg_t = time_axis[start_idx:end_idx]
    seg_f = max_freqs[start_idx:end_idx]
    if p["fit_middle_percent"] < 100:
        trim = int(len(seg_t) * (100 - p["fit_middle_percent"]) / 2 / 100)
        if trim > 0 and 2 * trim < len(seg_t):
            seg_t, seg_f = seg_t[trim:-trim], seg_f[trim:-trim]
    coefs = _polyfit(seg_t, seg_f, 1)
    f_shift_rate = float(coefs[1]) if len(coefs) > 1 else 0.0

    z_linear = apply_polynomial_drift(z, f_shift_rate, 0.0, float(fs),
                                      device)

    if not p["precise_sync"]:
        return z_linear, f_shift_rate / fs, model

    # ---- stage 3: fine time sync on the de-rotated track
    track2, _, _ = _argmax_track(z_linear, fs, bins_per_tone,
                                 steps_per_symbol)
    max_freqs2 = track2.astype(np.float64) * freq_step

    time_osr = wfp.time_osr
    nsync = p["nsync_sym"]
    ndata = p["ndata_sym"]
    sync_seq = (C.COSTAS_PATTERN.astype(np.float64) + 1)
    sync_seq = sync_seq - sync_seq.mean()
    samples_per_sym = time_osr * 2
    t_pulse = np.linspace(-1.0, 1.0, samples_per_sym + 1)
    gfsk_shape = gauss_window(
        2.0, torch.as_tensor(t_pulse, dtype=torch.float32)).numpy()

    one_seq = np.zeros((nsync - 1) * time_osr + samples_per_sym + 1)
    for s in range(nsync):
        one_seq[s * time_osr: s * time_osr + samples_per_sym + 1] += \
            gfsk_shape * sync_seq[s]
    template = np.zeros((3 * nsync + ndata - 1) * time_osr + 1
                        + samples_per_sym)
    for i in range(3):
        o = i * (nsync + ndata // 2) * time_osr
        template[o: o + len(one_seq)] = one_seq

    # mask the track to the detected segment (reference end fix-up)
    seg_end = end_idx + window_size - 2
    masked = np.zeros_like(max_freqs2)
    masked[start_idx:seg_end] = max_freqs2[start_idx:seg_end]
    model["f_center_hz"] = float(masked[start_idx:seg_end].mean())
    masked[start_idx:seg_end] -= masked[start_idx:seg_end].mean()

    corr = np.correlate(masked, template, mode="full")
    peak = int(np.argmax(corr))
    sync_block = peak - (len(template) - 1) + samples_per_sym // 2
    model["sync_time_s"] = sync_block * time_step
    model["rate_hz_per_s"] = f_shift_rate   # refined below if stage 4 runs

    # ---- stage 4: high-order fit over the three sync windows only; a
    # negative sync_block (the peak at the very start of the capture) is
    # clamped, or the window lengths diverge
    reg_x, reg_y = [], []
    for i in range(3):
        s = i * (nsync + ndata // 2) * time_osr + sync_block
        e = min(s + (nsync - 1) * time_osr, len(masked))
        s = max(s, 0)
        if s < e:
            reg_x.append(np.arange(s, e) * time_step)
            reg_y.append(masked[s:e])
    reg_x = np.concatenate(reg_x) if reg_x else np.array([])
    reg_y = np.concatenate(reg_y) if reg_y else np.array([])

    if len(reg_x) < 10:
        logger.warning("Not enough sync points found, using linear fit")
        return z_linear, f_shift_rate / fs, model

    degree = p["poly_degree"]
    if len(reg_x) <= degree + 1:
        logger.warning("Not enough data for high-order fitting")
        return z_linear, f_shift_rate / fs, model
    if degree not in (1, 2):
        logger.warning("poly_degree must be 1 or 2, using linear fit")
        return z_linear, f_shift_rate / fs, model

    cf = _polyfit(reg_x, reg_y, degree)
    rate_final = float(cf[1]) if len(cf) > 1 else 0.0
    acc_final = float(cf[2]) if len(cf) > 2 else 0.0
    model["rate_hz_per_s"] = rate_final + f_shift_rate
    model["acc_hz_per_s2"] = acc_final

    z_final = apply_polynomial_drift(z_linear, rate_final, acc_final,
                                     float(fs), device)

    logger.info("Final drift parameters: rate=%.4f Hz/s acc=%.4e Hz/s^2 "
                "sync_time=%.3f s", rate_final, acc_final,
                sync_block * time_step)

    # the reported rate: secant slope of the final fit plus the linear
    # stage, as the reference reports it
    first = np.polyval(cf[::-1], reg_x[0])
    last = np.polyval(cf[::-1], reg_x[-1])
    rate_real = (first - last) / (reg_x[0] - reg_x[-1]) + f_shift_rate
    return z_final, rate_real / fs, model
