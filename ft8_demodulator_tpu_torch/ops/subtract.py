"""Decoded-signal reconstruction and subtraction (multi-pass decoding).

Port of ``ft8_demodulator_tpu/ops/subtract.py``.  Each successfully
decoded payload is re-encoded to its GFSK baseband (the native TX of
``ops/gfsk.py``), aligned in time by integer sample lags, refined in
carrier frequency from the phase slope of its per-symbol correlations,
least-squares fitted in amplitude and phase, and subtracted from the audio.
The candidates go in order, each against the audio the earlier ones left.

The JAX function loops over every row and masks the failed ones to a zero
subtraction; here only the successful rows run (the same residual).  The
lag searches and the frequency grids are batched products, and the
argmaxes keep the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..protocol import constants as C
from ..protocol.encode import encode_tones
from .gfsk import _baseband_complex
from .waterfall import WaterfallParams

__all__ = ["subtract_decoded", "NUM_FREQ_REFINE"]

# frequency-refinement grid: +-(grid bin)/2 around the candidate frequency
NUM_FREQ_REFINE = 33


def _linspace_f32(start: torch.Tensor, stop: torch.Tensor,
                  num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32, JAX's formula:
    start * (1 - i/div) + stop * (i/div), the endpoint exactly ``stop``
    (torch.linspace rounds otherwise)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) \
        / np.float32(div)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _refine_and_fit(x_ext: torch.Tensor, bb: torch.Tensor, sps: int,
                    fs: float, df_span: float, half: int) -> torch.Tensor:
    """Refine the time and carrier offsets and LS-fit one reconstruction.

    x_ext: (79*sps + 2*half,) real received window centred on the
    candidate's grid-quantised start; bb: (79*sps,) complex64 unit
    reconstruction at the candidate's grid frequency.  Returns the real
    waveform to subtract from x_ext (zero outside the aligned span).

    The lag is searched on a coarse grid, then at single samples around
    the coarse peak, by the sum of per-symbol correlation magnitudes
    (insensitive to the not yet refined carrier offset); the carrier offset
    is the peak of the coherent power over a grid of offsets, coarse then
    fine.
    """
    dev = x_ext.device
    n = C.NUM_SYMBOLS * sps
    span = torch.arange(n, device=dev)
    t = torch.arange(n, dtype=torch.float32, device=dev) / np.float32(fs)
    bb_conj = torch.conj(bb)

    def sym_corr(lags: torch.Tensor) -> torch.Tensor:
        """(L,) lags -> (L, 79) complex per-symbol correlations."""
        xw = x_ext[lags[:, None] + span]                      # (L, n)
        return (xw * bb_conj).reshape(-1, C.NUM_SYMBOLS, sps).sum(-1)

    def best_lag(lags: torch.Tensor) -> torch.Tensor:
        return lags[torch.argmax(sym_corr(lags).abs().sum(-1))]

    coarse_step = max(1, (2 * half) // 16)
    lag = best_lag(torch.arange(0, 2 * half + 1, coarse_step, device=dev))
    lag = best_lag(torch.clamp(
        lag - coarse_step + torch.arange(2 * coarse_step + 1, device=dev),
        0, 2 * half))

    x_win = x_ext[lag + span]
    c_s = sym_corr(lag.reshape(1))[0]                         # (79,)
    t_s = (torch.arange(C.NUM_SYMBOLS, dtype=torch.float32, device=dev)
           + 0.5) * np.float32(sps / fs)

    def grid_peak(center: torch.Tensor, half_span: float) -> torch.Tensor:
        lim = torch.tensor(half_span, dtype=torch.float32, device=dev)
        dfs = center + _linspace_f32(-lim, lim, NUM_FREQ_REFINE)
        rot = torch.exp((-2j * np.pi) * dfs[:, None] * t_s[None, :])
        power = (c_s[None, :] * rot).sum(-1).abs()
        return dfs[torch.argmax(power)]

    step = 2.0 * df_span / (NUM_FREQ_REFINE - 1)
    df_hat = grid_peak(torch.zeros((), device=dev), df_span)
    df_hat = grid_peak(df_hat, step)

    # re-centre the reconstruction at the refined frequency
    bb_f = bb * torch.exp((2j * np.pi) * df_hat * t)
    rc, rs = bb_f.real, bb_f.imag
    alpha = (x_win * rc).sum() / torch.clamp((rc * rc).sum(), min=1e-12)
    beta = (x_win * rs).sum() / torch.clamp((rs * rs).sum(), min=1e-12)
    out = torch.zeros_like(x_ext)
    out[lag + span] = alpha * rc + beta * rs
    return out


def subtract_decoded(wave: torch.Tensor, p: WaterfallParams,
                     payloads: torch.Tensor, abs_time: torch.Tensor,
                     abs_freq: torch.Tensor,
                     success: torch.Tensor) -> torch.Tensor:
    """Subtract every successfully decoded transmission from real audio.

    wave (n,) float32; payloads (K, 10) uint8; abs_time / abs_freq (K,)
    waterfall indices of the uncropped grid; success (K,) bool.  Returns
    the residual audio (n,) on the device of ``wave``.

    The reconstruction uses the WSJT-X-aligned synth (symbol 0 at the
    waveform start, at abs_time * hop).
    """
    dev = wave.device
    sps = p.nperseg
    n_sig = C.NUM_SYMBOLS * sps
    freq_step = C.TONE_SPACING_HZ / p.freq_osr
    df_span = 0.6 * freq_step
    half = p.hop // 2             # grid time quantisation is +-hop/2
    n_ext = n_sig + 2 * half
    pad = n_ext
    xp = torch.nn.functional.pad(wave.to(torch.float32), (pad, pad))

    rows = torch.nonzero(success.cpu()).flatten().tolist()
    if not rows:
        return xp[pad: pad + wave.shape[-1]]
    tones = encode_tones(payloads[rows].to(dev))             # (R, 79)
    # the carrier in float32 on the device, as the JAX function traces it
    f0s = abs_freq[rows].to(dev, torch.float32) * np.float32(freq_step)
    for r, t0 in enumerate(abs_time.cpu()[rows].tolist()):
        bb = _baseband_complex(tones[r], sps, float(p.fs), f0s[r])
        start = min(max(pad + t0 * p.hop - half, 0), xp.shape[0] - n_ext)
        x_ext = xp[start: start + n_ext]
        sub = _refine_and_fit(x_ext, bb, sps, float(p.fs), df_span, half)
        xp[start: start + n_ext] = x_ext - sub
    return xp[pad: pad + wave.shape[-1]]
