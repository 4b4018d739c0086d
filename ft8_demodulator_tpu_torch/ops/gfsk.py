"""GFSK modulator: tone ids -> phase-continuous complex baseband (native TX).

Port of ``ft8_demodulator_tpu/ops/gfsk.py``: symbol k's Gaussian pulse is
centred at sample (k + 0.5) * sps, the WSJT-X alignment, or with
``reference_quirk`` one symbol later with the last Costas symbol cut off
(the reference modulator's own waveform).  The frequency track is three
outer products (each symbol slot sees exactly three Gaussian pulse
segments) and the phase accumulation is hierarchical so that it stays
accurate in float32:

* within a symbol slot: cumsum over <= sps samples (values stay small),
* across slots: a cumulative product of 79 unit phasors, so the growing
  integer part of the phase never has to be represented.

Waveform convention: ``w[n] = sin(phi_n) - j cos(phi_n) = -j exp(j phi_n)``,
raised-cosine amplitude ramps over the first/last sps/8 samples.  Complex
signals are native ``complex64`` tensors; ``tones_to_baseband`` returns the
JAX function's (..., n, 2) float32 [re, im] array.  The host entry points
run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..protocol import constants as C
from ..protocol.encode import encode_tones
from ..utils.device import entry_device

__all__ = ["gauss_window", "gfsk_frequency_track", "tones_to_baseband",
           "ft8_baseband", "tones_to_passband", "ft8_passband"]

_GFSK_BT = 2.0


# XLA's float32 erf: x * P(x^2) / Q(x^2) on x clamped to erfinv(1 - 2^-23),
# Horner steps fused multiply-adds.  torch.special.erf differs from it by a
# few ulp, and the TX sums that difference over 79 symbol phases.
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.7439211627767994


def _erf_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erf with XLA's rounding; each Horner step is one fused
    multiply-add (the float64 product of two float32 values is exact)."""
    x = torch.clamp(x.to(torch.float32), -_ERF_CLAMP, _ERF_CLAMP)
    x2 = (x * x).double()

    def horner(coeffs):
        acc = torch.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            acc = (x2 * acc.double() + float(np.float32(c))).float()
        return acc

    return (x * horner(_ERF_ALPHA)) / horner(_ERF_BETA)


def gauss_window(bt: float, t: torch.Tensor) -> torch.Tensor:
    """Gaussian frequency-smoothing pulse (integral of a Gaussian over 1 sym):
    0.5*(erf(k*bt*(t+.5)) - erf(k*bt*(t-.5))) with k = pi*sqrt(2/ln 2)."""
    k = np.pi * np.sqrt(2.0 / np.log(2.0))
    return 0.5 * (_erf_f32(k * bt * (t + 0.5)) - _erf_f32(k * bt * (t - 0.5)))


def _window_segments(sps: int, dtype, device=None) -> torch.Tensor:
    """(3, sps) Gaussian pulse split into its three symbol-length segments."""
    t = (torch.arange(3 * sps, dtype=dtype, device=device) - 1.5 * sps) / sps
    return gauss_window(_GFSK_BT, t).reshape(3, sps)


def gfsk_frequency_track(tones: torch.Tensor, sps: int,
                         dtype=torch.float32,
                         reference_quirk: bool = False) -> torch.Tensor:
    """(..., 79) tone ids -> (..., 79, sps) tone-unit frequency track.

    track[s] = te[s]*w2 + te[s+1]*w1 + te[s+2]*w0 with
    te = [t0, t0..t78, t78] (first/last tone extended past the frame);
    ``reference_quirk`` reads te = [0, t0, t0..t78, t78] instead, every
    symbol one symbol late.
    """
    w0, w1, w2 = _window_segments(sps, dtype, tones.device)
    t = tones.to(dtype)
    lead = [torch.zeros_like(t[..., :1])] if reference_quirk else []
    te = torch.cat(lead + [t[..., :1], t, t[..., -1:]], dim=-1)
    return (te[..., 0:79, None] * w2
            + te[..., 1:80, None] * w1
            + te[..., 2:81, None] * w0)


def _phase_fraction(track: torch.Tensor, sps: int, fs: float,
                    f0: float | torch.Tensor, dtype
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase (in cycles mod 1) at every sample, split as (slot phasor, frac).

    Returns (E_slot[..., 79] complex unit phasors at slot starts,
             frac[..., 79, sps] fractional cycles within each slot).
    ``f0`` is a Python float (the JAX TX's static carrier) or a 0-d
    float32 tensor (a carrier computed on the device, as in the
    subtraction pass).  For a tensor the carrier terms are float32
    arithmetic in the form XLA gives the JAX function's traced f0: the
    division by fs becomes a multiply by the float32 reciprocal, and
    (f0 / fs) * sps folds its two constants.
    """
    df = C.TONE_SPACING_HZ / fs          # cycles per sample per tone unit
    if isinstance(f0, torch.Tensor):
        inv_fs = np.float32(1.0 / fs)
        c0 = f0 * inv_fs                 # carrier cycles per sample
        carrier_slot = torch.remainder(f0 * (inv_fs * np.float32(sps)), 1.0)
    else:
        c0 = f0 / fs
        carrier_slot = float(np.mod(np.float32(c0 * sps), np.float32(1.0)))

    inc = track * df                                     # (..., 79, sps)
    cs = torch.cumsum(inc, dim=-1) - inc                 # exclusive
    r = torch.arange(sps, dtype=dtype, device=track.device)
    frac_carrier = torch.remainder(c0 * r, 1.0)
    frac = torch.remainder(cs + frac_carrier, 1.0)       # (..., 79, sps)

    # slot-start phases as unit phasors: the integer cycle count is never
    # represented (f32-exact for 79 products)
    slot_cycles = torch.remainder(inc.sum(-1) + carrier_slot, 1.0)
    slot_phasor = torch.polar(torch.ones_like(slot_cycles),
                              2.0 * np.pi * slot_cycles)
    e = torch.cumprod(slot_phasor, dim=-1)
    e = torch.cat([torch.ones_like(e[..., :1]), e[..., :-1]], dim=-1)
    return e, frac


def _baseband_complex(tones: torch.Tensor, sps: int, fs: float,
                      f0: float | torch.Tensor,
                      reference_quirk: bool = False) -> torch.Tensor:
    """(..., 79) tone ids -> (..., 79*sps) complex64 baseband; the carrier
    as :func:`_phase_fraction` takes it."""
    dtype = torch.float32
    track = gfsk_frequency_track(tones, sps, dtype, reference_quirk)
    e_slot, frac = _phase_fraction(track, sps, fs, f0, dtype)
    w = e_slot[..., :, None] * torch.polar(torch.ones_like(frac),
                                           2.0 * np.pi * frac)
    w = -1j * w                  # sin(phi) - j cos(phi) = -j exp(j phi)
    w = w.reshape(*tones.shape[:-1], C.NUM_SYMBOLS * sps)

    # raised-cosine amplitude ramp over the first/last sps//8 samples
    n = C.NUM_SYMBOLS * sps
    nramp = sps // 8
    i = torch.arange(n, dtype=dtype, device=tones.device)
    up = 0.5 * (1.0 - torch.cos(8.0 * np.pi * i / sps))
    down = 0.5 * (1.0 + torch.cos(8.0 * np.pi * (n - 1 - i) / sps))
    ramp = torch.where(i < nramp, up, 1.0)
    ramp = torch.where(i >= n - nramp, down, ramp)
    return (w * ramp).to(torch.complex64)


def _tones(tones, device) -> torch.Tensor:
    if not isinstance(tones, torch.Tensor):
        tones = torch.from_numpy(np.array(tones))
    return tones.to(entry_device(device))


def _payload_tones(payload, device) -> torch.Tensor:
    return encode_tones(torch.as_tensor(np.array(payload, np.uint8),
                                        device=entry_device(device)))


def tones_to_baseband(tones, sps: int, fs: float, f0: float,
                      reference_quirk: bool = False,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """(..., 79) tone ids -> (..., 79*sps, 2) float32 [real, imag]
    baseband on ``device``."""
    return torch.view_as_real(_baseband_complex(
        _tones(tones, device), sps, float(fs), float(f0), reference_quirk))


def ft8_baseband(payload, fs: float, f0: float,
                 reference_quirk: bool = False,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """(..., 10) payload bytes -> complex64 baseband transmission on
    ``device`` (the card unless the caller asks for the CPU; without a
    card, a CUDA device raises)."""
    sps = int(C.SYMBOL_PERIOD_S * fs)
    return _baseband_complex(_payload_tones(payload, device), sps, float(fs),
                             float(f0), reference_quirk)


def tones_to_passband(tones, sps: int, fs: float, f0: float, fc: float,
                      reference_quirk: bool = False,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Real passband waveform Re{baseband * exp(j 2 pi fc t)} on
    ``device``: mixing to fc equals generating the baseband at carrier
    f0 + fc, which keeps the whole phase inside the float32-safe
    accumulator."""
    return _baseband_complex(_tones(tones, device), sps, float(fs),
                             float(f0 + fc), reference_quirk).real


def ft8_passband(payload, fs: float, f0: float, fc: float,
                 reference_quirk: bool = False,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """(..., 10) payload bytes -> float32 passband transmission on
    ``device`` (the card unless the caller asks for the CPU; without a
    card, a CUDA device raises)."""
    sps = int(C.SYMBOL_PERIOD_S * fs)
    return _baseband_complex(_payload_tones(payload, device), sps, float(fs),
                             float(f0 + fc), reference_quirk).real
