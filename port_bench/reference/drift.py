"""The plain reference of the beacon receiver's front: the analytic signal
and the upstream's 4-stage frequency-drift corrector, in plain PyTorch and
numpy.

It follows the description of Rintazero/ft8_demodulator's
``ft8_beacon_receiver/frequency_correction.py`` (``correct_frequency_drift``):

1. coarse detection: the per-frame argmax (first maximum) of the complex
   waterfall's positive frequencies; the residual variance of a linear
   least-squares fit over each sliding window of ``4 * time_osr`` frames
   as the continuity metric; runs under ``1e-4 * bins^2`` are segments, and
   the longest (the first of equals) wins;
2. a degree-1 fit of the segment's track (Hz against s) gives the linear
   rate k, removed as the chirp exp(-j 2 pi k t^2 / 2);
3. fine time sync: the de-rotated cycle's track, kept on the segment (to
   ``window - 2`` frames past its end) and mean-removed, correlated with a
   template of the three Costas arrays (tone + 1, mean-removed, each symbol
   a GFSK pulse of BT 2 over two symbols), the peak giving the sync frame;
4. a degree-2 fit over the three Costas windows (7 symbols each from the
   sync frame, 36 symbols apart) whose rate and acceleration are removed
   as exp(-j 2 pi (k t^2/2 + a t^3/3)).

A cycle without a segment, or with fewer than 10 points in the Costas
windows, keeps what the earlier stages gave.

Stage 3 takes a hint: another side's segment and sync frame.  Where the
segment is this one's and the hinted frame's correlation falls short of
the maximum by no more than a float32 pulse can move two frames' sums
(:data:`PULSE_TOL` a pulse value), the frame is a tie and this side takes
it (``Model.tied``); any other hint is not taken.

The waterfall is the block STFT of ``front.py`` on complex samples (two
DFT products of the real and imaginary parts).  ``dtype`` float32 is what
the configuration states: the DFT's products summed in float64 and
rounded once to float32, the power, dB and rotation in float32, the
rotation's cycle count float64 on the host reduced mod 1 first.  bfloat16
(the control) rounds the analytic samples, the spectra, the power, the dB
grid, the rotation's angle and the rotated samples to bfloat16.

Departures from the upstream: the analytic signal comes from
``torch.fft`` in float64 (the upstream calls ``scipy.signal.hilbert``,
the same transform); the least-squares fits solve the Vandermonde system
(the upstream uses scikit-learn's LinearRegression on polynomial
features, the same estimate); the run left open at the end of the metric
closes at the track's last frame, as the upstream's loop closes it; debug
plots are left out.  The GFSK pulse is the upstream's, in float64
(``torch.special.erf``).  Where the corrector fits noise, the masked,
bin-quantised track makes near-ties of the template correlation, which a
pulse that differs in the last place (a float32 erf) may break towards
another frame: hence the hint.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from . import front

__all__ = ["Model", "analytic", "rounded", "complex_block_spectra",
           "power_tf", "argmax_track", "segments", "rotate", "correct"]

WINDOW_FACTOR = 4
MAX_VARIANCE_FACTOR = 1e-4
NSYNC, NDATA = 7, 58
# how far a GFSK pulse value may move when it is evaluated in float32: its
# two erf values' rounding and that of their float32 arguments (up to ~6,
# where erf' ~ 1), each a few ulps of 1, with room
PULSE_TOL = 2.0 ** -20


class Model(NamedTuple):
    """What the corrector found in one cycle (None where it stopped
    earlier)."""

    segment: tuple[int, int] | None   # frames [start, end) of the track
    rate_linear: float | None         # Hz/s, stage 2
    sync_frame: int | None            # stage 3
    rate: float | None                # Hz/s, stage 4's fit
    acc: float | None                 # Hz/s^2, stage 4's fit
    tied: bool = False                # the sync frame a hinted near-tie


def analytic(x: torch.Tensor) -> torch.Tensor:
    """Real (n,) -> its analytic signal, complex128: one float64 FFT, the
    negative frequencies zeroed, the positive ones doubled."""
    n = x.shape[-1]
    h = torch.zeros(n, dtype=torch.float64, device=x.device)
    h[0] = 1.0
    h[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        h[n // 2] = 1.0
    return torch.fft.ifft(torch.fft.fft(x.to(torch.float64)) * h)


def rounded(z: torch.Tensor, dtype) -> torch.Tensor:
    """Complex or real values rounded to ``dtype`` and back to 32 bits
    (complex64 or float32)."""
    if z.is_complex():
        return torch.complex(z.real.to(dtype).float(), z.imag.to(dtype).float())
    return z.to(dtype).float()


def complex_block_spectra(z: torch.Tensor, p: front.Geometry,
                          num_frames: int, dtype=torch.float32
                          ) -> torch.Tensor:
    """Complex (..., n) -> complex64 hop-block spectra (..., nb, F + 2 phi):
    (zr + i zi)(cos + i sin), the products summed in float64 and rounded
    once to ``dtype``."""
    nb = num_frames + p.time_osr - 1
    blocks = z[..., : nb * p.hop].reshape(*z.shape[:-1], nb, p.hop)
    cos_m, sin_m = (torch.as_tensor(m.astype(np.float32), device=z.device)
                    .double() for m in front._dft_matrices(p))
    br, bi = blocks.real.double(), blocks.imag.double()
    spec = torch.complex((br @ cos_m - bi @ sin_m).float(),
                         (br @ sin_m + bi @ cos_m).float())
    return rounded(spec, dtype)


def power_tf(spec: torch.Tensor, p: front.Geometry, num_frames: int,
             dtype=torch.float32) -> torch.Tensor:
    """Block spectra -> (..., T, F) linear power of the Hann-windowed frames
    (the phase combine and the 3-tap stencil of ``front.db_grid_tf``)."""
    w = front._combine_phases(p, spec.device)
    u = spec[..., 0:num_frames, :] * w[0]
    for s in range(1, p.time_osr):
        u = u + spec[..., s: s + num_frames, :] * w[s]
    phi = p.freq_osr
    k0, k1 = phi, phi + p.num_freq_bins
    x = (0.5 * u[..., k0:k1] - 0.25 * u[..., k0 - phi: k1 - phi]
         - 0.25 * u[..., k0 + phi: k1 + phi])
    return (x.real * x.real + x.imag * x.imag).to(dtype).float()


def argmax_track(z: torch.Tensor, p: front.Geometry, dtype=torch.float32
                 ) -> np.ndarray:
    """Complex (n,) -> the (T,) frame-by-frame argmax bin of its dB
    waterfall's positive frequencies."""
    nf = p.num_frames(z.shape[-1])
    power = power_tf(complex_block_spectra(z, p, nf, dtype), p, nf, dtype)
    db = (10.0 * torch.log10(front._DB_FLOOR + power * front._db_scale(p)))
    return torch.argmax(db.to(dtype), dim=-1).cpu().numpy()


def _residual_variance(y: np.ndarray) -> float:
    """Mean squared residual of the least-squares line through y."""
    x = np.arange(len(y), dtype=np.float64)
    a = np.stack([np.ones_like(x), x], 1)
    coef = np.linalg.lstsq(a, y, rcond=None)[0]
    r = y - a @ coef
    return float(np.mean(r * r))


def segments(track: np.ndarray, window: int, max_variance: float
             ) -> list[tuple[int, int]]:
    """Maximal runs of windows whose residual variance is under
    ``max_variance``: (first window, one past the last); a run still open
    at the last window closes at the track's last frame."""
    y = track.astype(np.float64)
    if len(y) < window:
        return []
    ok = [_residual_variance(y[i: i + window]) < max_variance
          for i in range(len(y) - window + 1)]
    out, start = [], None
    for i, flag in enumerate(ok):
        if flag and start is None:
            start = i
        elif not flag and start is not None:
            out.append((start, i))
            start = None
    if start is not None:
        out.append((start, len(y) - 1))
    return out


def _fit(x: np.ndarray, y: np.ndarray, degree: int) -> np.ndarray:
    """Least-squares polynomial coefficients [c0, c1, ...]."""
    return np.linalg.lstsq(np.vander(x, degree + 1, increasing=True), y,
                           rcond=None)[0]


def rotate(z: torch.Tensor, rate: float, acc: float, fs: float,
           dtype=torch.float32) -> torch.Tensor:
    """z * exp(-j 2 pi (rate t^2/2 + acc t^3/3)), t = sample / fs: the
    cycle count in float64, reduced mod 1, then the angle and the product
    in float32 (``dtype`` rounds the angle and the result)."""
    t = np.arange(z.shape[-1], dtype=np.float64) / fs
    phase = rate * t * t / 2.0 + acc * t * t * t / 3.0
    cyc = torch.as_tensor((phase - np.floor(phase)).astype(np.float32),
                          device=z.device)
    ang = (np.float32(-2.0 * np.pi) * cyc).to(dtype).float()
    return rounded(z.to(torch.complex64)
                   * torch.complex(torch.cos(ang), torch.sin(ang)), dtype)


def _template(time_osr: int, magnitude: bool = False) -> np.ndarray:
    """The three Costas arrays as a frame-rate frequency template
    (``magnitude``: each sample's sum of |sequence value| over the pulses
    that reach it, what a pulse error is multiplied by there)."""
    seq = C.COSTAS_PATTERN.astype(np.float64) + 1.0
    seq -= seq.mean()
    sps2 = 2 * time_osr
    t = torch.as_tensor(np.linspace(-1.0, 1.0, sps2 + 1))
    k = np.pi * np.sqrt(2.0 / np.log(2.0))
    pulse = (0.5 * (torch.special.erf(k * 2.0 * (t + 0.5))
                    - torch.special.erf(k * 2.0 * (t - 0.5)))).numpy()
    if magnitude:
        seq, pulse = np.abs(seq), np.ones_like(pulse)
    one = np.zeros((NSYNC - 1) * time_osr + sps2 + 1)
    for s in range(NSYNC):
        one[s * time_osr: s * time_osr + sps2 + 1] += pulse * seq[s]
    out = np.zeros((3 * NSYNC + NDATA - 1) * time_osr + 1 + sps2)
    for i in range(3):
        o = i * (NSYNC + NDATA // 2) * time_osr
        out[o: o + len(one)] = one
    return out


def _sync_frame(masked: np.ndarray, time_osr: int, hint: int | None
                ) -> tuple[int, bool]:
    """Stage 3's frame: the correlation's first maximum, or ``hint`` where
    its correlation is within the tie margin of it ((frame, tied))."""
    tpl = _template(time_osr)
    corr = np.correlate(masked, tpl, mode="full")
    best = int(np.argmax(corr))
    pick = best
    if hint is not None:
        j = hint + len(tpl) - 1 - time_osr
        margin = (2.0 * PULSE_TOL * _template(time_osr, True).max()
                  * float(np.abs(masked).sum()))
        if j != best and 0 <= j < len(corr) and corr[best] - corr[j] <= margin:
            pick = j
    return pick - (len(tpl) - 1) + time_osr, pick != best


def correct(x: np.ndarray, fs: float, bins_per_tone: int,
            steps_per_symbol: int, device, dtype=torch.float32,
            hint: tuple | None = None) -> tuple[torch.Tensor, Model]:
    """One real cycle (numpy) -> (its drift-corrected analytic signal,
    complex64 on ``device``; the model found).  ``hint``: another side's
    (segment, sync frame) for stage 3's ties."""
    p = front.geometry(fs, bins_per_tone, steps_per_symbol)
    z = rounded(analytic(torch.as_tensor(np.asarray(x, np.float64),
                                         device=device)), dtype)
    window = WINDOW_FACTOR * p.time_osr
    track = argmax_track(z, p, dtype)
    segs = segments(track, window, MAX_VARIANCE_FACTOR * p.num_freq_bins ** 2)
    if not segs:
        return z, Model(None, None, None, None, None)
    start, end = max(segs, key=lambda s: s[1] - s[0])
    f_step = C.TONE_SPACING_HZ / p.freq_osr
    t_step = C.SYMBOL_PERIOD_S / p.time_osr
    times = np.arange(len(track)) * t_step
    rate1 = float(_fit(times[start:end], track[start:end] * f_step, 1)[1])
    z1 = rotate(z, rate1, 0.0, fs, dtype)

    track2 = argmax_track(z1, p, dtype).astype(np.float64) * f_step
    stop = end + window - 2
    masked = np.zeros_like(track2)
    masked[start:stop] = track2[start:stop] - track2[start:stop].mean()
    take = hint is not None and tuple(hint[0] or ()) == (start, end)
    sync, tied = _sync_frame(masked, p.time_osr, hint[1] if take else None)
    xs, ys = [], []
    for i in range(3):
        s = i * (NSYNC + NDATA // 2) * p.time_osr + sync
        e = min(s + (NSYNC - 1) * p.time_osr, len(masked))
        s = max(s, 0)
        if s < e:
            xs.append(np.arange(s, e) * t_step)
            ys.append(masked[s:e])
    if sum(len(a) for a in xs) < 10:
        return z1, Model((start, end), rate1, sync, None, None, tied)
    cf = _fit(np.concatenate(xs), np.concatenate(ys), 2)
    return rotate(z1, float(cf[1]), float(cf[2]), fs, dtype), \
        Model((start, end), rate1, sync, float(cf[1]), float(cf[2]), tied)
