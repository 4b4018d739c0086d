"""Channel ops: Doppler application/compensation and AWGN.

Port of ``ft8_demodulator_tpu/channel/doppler.py``, counterparts of the
reference's channel test scripts (src/tests/channel/
test_signal_after_channel.py:49-59, test_signal_processing.py:40-49).
Complex signals cross the API as (..., n, 2) float32 [re, im] arrays or
tensors, returned in the same layout; a complex tensor or array is taken
too and returned complex64.

HOST-SIDE PHASE, by design: the Doppler/compensation ops compute their
phase in float64 numpy on the host, reduce it mod 1 to float32 cycles,
and only the rotate runs on the device (``beacon/drift.py
_apply_phase_cycles``).  A float32 phase accumulates ~0.1-cycle staircase
noise over a minutes-long capture (~1e5-1e6 cycles), which biases any
receiver arm that relies on the compensation.  ``doppler_hz`` and the
linear model's parameters are host values; a tensor ``doppler_hz`` is
copied to the host as float64.

Where they run: a tensor stays on its device, a host array goes to
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..beacon.drift import _apply_phase_cycles
from ..ops.waterfall import _on_device

__all__ = ["apply_doppler", "apply_doppler_physical",
           "compensate_linear_doppler",
           "compensate_linear_doppler_physical", "add_complex_awgn",
           "decimate"]


def _num_samples(wave_ri) -> int:
    """n of a (..., n, 2) [re, im] or (..., n) complex signal."""
    is_complex = wave_ri.is_complex() if isinstance(wave_ri, torch.Tensor) \
        else np.iscomplexobj(wave_ri)
    return np.shape(wave_ri)[-1 if is_complex else -2]


def _host_f64(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=np.float64)


def _rotate_cycles(wave_ri, cyc_f64: np.ndarray, device) -> torch.Tensor:
    """x * exp(-j 2 pi cyc): the float64 host cycle count reduced mod 1 to
    float32, the rotate on the device of the wave."""
    x = _on_device(wave_ri, device)
    as_pair = not x.is_complex()
    z = torch.view_as_complex(x.to(torch.float32).contiguous()) if as_pair \
        else x.to(torch.complex64)
    cyc = torch.as_tensor((cyc_f64 - np.floor(cyc_f64)).astype(np.float32),
                          device=z.device)
    out = _apply_phase_cycles(z, cyc)
    return torch.view_as_real(out) if as_pair else out


def apply_doppler(wave_ri, doppler_hz, fs: float,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """y[i] = x[i] * exp(-j 2 pi f_d[i] * t_i), the reference's channel
    convention (instantaneous shift times absolute time,
    test_signal_after_channel.py:55-58)."""
    n = _num_samples(wave_ri)
    t = np.arange(n, dtype=np.float64) / float(fs)
    return _rotate_cycles(wave_ri, _host_f64(doppler_hz) * t, device)


def apply_doppler_physical(wave_ri, doppler_hz, fs: float,
                           device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """y[i] = x[i] * exp(-j phi_i), phi = 2 pi INTEGRAL of f_d dt — the
    PHYSICAL Doppler channel (instantaneous frequency offset = -f_d(t)).

    The reference's convention (:func:`apply_doppler`) writes the phase
    as f_d(t) * t, whose instantaneous frequency is f_d + t * f_d' —
    identical only for constant f_d; over a multi-cycle capture the
    t * f_d' term amplifies any residual after partial compensation by
    absolute capture time.  Trapezoid-integrated float64 host phase
    (exact for linear f_d, so :func:`compensate_linear_doppler_physical`'s
    closed form cancels it analytically)."""
    n = _num_samples(wave_ri)
    f = np.broadcast_to(_host_f64(doppler_hz), (n,))
    phase = np.empty(n, np.float64)
    phase[0] = 0.0
    np.cumsum((f[1:] + f[:-1]) * (0.5 / float(fs)), out=phase[1:])
    return _rotate_cycles(wave_ri, phase, device)


def compensate_linear_doppler_physical(wave_ri, slope_hz_per_sample: float,
                                       intercept_hz: float, fs: float,
                                       device: str | torch.device = "cuda"
                                       ) -> torch.Tensor:
    """Exact inverse of :func:`apply_doppler_physical` for a linear model
    f_d(k) = slope * k + intercept: phase = -2 pi (slope * fs * t^2 / 2
    + intercept * t), the closed-form integral."""
    n = _num_samples(wave_ri)
    t = np.arange(n, dtype=np.float64) / float(fs)
    phase = -(float(slope_hz_per_sample) * float(fs) * t * t * 0.5
              + float(intercept_hz) * t)
    return _rotate_cycles(wave_ri, phase, device)


def compensate_linear_doppler(wave_ri, slope_hz_per_sample: float,
                              intercept_hz: float, fs: float,
                              device: str | torch.device = "cuda"
                              ) -> torch.Tensor:
    """Undo a linear Doppler model: y = x * exp(+j 2 pi (a*t*fs + b) * t)
    (test_signal_processing.py:45-46), the reference's convention."""
    n = _num_samples(wave_ri)
    t = np.arange(n, dtype=np.float64) / float(fs)
    phase = -(float(slope_hz_per_sample) * t * float(fs)
              + float(intercept_hz)) * t
    return _rotate_cycles(wave_ri, phase, device)


def add_complex_awgn(wave_ri, generator: torch.Generator | None,
                     snr_db: float,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Add circular Gaussian noise at the given SNR relative to the signal's
    own mean power, with the reference's per-quadrature sigma convention
    (noise std sqrt(noise_power) per real/imag component,
    test_signal_after_channel.py:42-43).

    ``generator`` takes the place of the JAX package's PRNG key.  The
    noise is drawn on the generator's device (the CPU for None) and moved
    to the wave's, so one seed gives the same capture on the card and on
    the CPU.
    """
    x = _on_device(wave_ri, device)
    as_pair = not x.is_complex()
    ri = x.to(torch.float32) if as_pair else torch.view_as_real(
        x.to(torch.complex64))
    power = torch.mean(ri[..., 0] ** 2 + ri[..., 1] ** 2)
    sigma = torch.sqrt(power / 10.0 ** (snr_db / 10.0))
    gen_device = generator.device if generator is not None else "cpu"
    noise = torch.randn(ri.shape, generator=generator, dtype=torch.float32,
                        device=gen_device).to(ri.device)
    out = ri + noise * sigma
    return out if as_pair else torch.view_as_complex(out.contiguous())


def decimate(wave_ri, factor: int):
    """Plain stride decimation (the reference downsamples without an
    anti-alias filter, test_signal_processing.py:48-49): a strided view of
    a (..., n, 2) [re, im] or (..., n) complex tensor or array."""
    is_complex = wave_ri.is_complex() if isinstance(wave_ri, torch.Tensor) \
        else np.iscomplexobj(wave_ri)
    return wave_ri[..., ::factor] if is_complex else wave_ri[..., ::factor, :]
