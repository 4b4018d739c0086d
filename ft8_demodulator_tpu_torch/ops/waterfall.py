"""Waterfall front-end: windowed STFT -> dB power grid (block backend).

Port of the block backend of ``ft8_demodulator_tpu/ops/waterfall.py``: for
the standard FT8 geometry (hop * time_osr == nperseg and
nfft == freq_osr * nperseg) the audio is cut into non-overlapping
hop-length blocks, one (hop, num_freq_bins + 2*freq_osr) DFT product
transforms each block once, and each frame's spectrum is recovered exactly
as

    U_t[k] = sum_s  e^{-2pi i s k / (freq_osr*time_osr)} * P_{t+s}[k]

followed by the periodic-Hann window applied as an exact 3-tap stencil in
frequency, X[k] = 0.5*U[k] - 0.25*U[k-freq_osr] - 0.25*U[k+freq_osr], then
|X|^2 / sum(win)^2 in dB.  Spectra are native complex tensors.

Other geometries (the JAX package's "matmul" and "fft" backends) are not
ported yet: see ROADMAP.md, queue 1, "waterfall backends".
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..protocol import constants as C

__all__ = ["WaterfallParams", "waterfall_params", "waterfall_real"]

_DB_FLOOR = 1e-12
# Above this hop the block DFT matrices stop being the right trade
_MATMUL_MAX_NPERSEG = 4608
# cap on DFT-matrix size (elements) for the block backend
_DFT_MATRIX_MAX_ELEMS = 16 * 1024 * 1024


class WaterfallParams(NamedTuple):
    """Static STFT geometry for one (fs, osr) configuration."""

    fs: float
    nperseg: int
    hop: int
    nfft: int
    time_osr: int          # steps_per_symbol
    freq_osr: int          # bins_per_tone
    num_freq_bins: int     # positive-frequency bins = nfft // 2

    def num_frames(self, num_samples: int) -> int:
        return max(0, (num_samples - self.nperseg) // self.hop + 1)

    def num_blocks(self, num_samples: int) -> int:
        """Whole FT8 symbols in the waterfall."""
        return self.num_frames(num_samples) // self.time_osr


def waterfall_params(fs: float, bins_per_tone: int = 2,
                     steps_per_symbol: int = 2) -> WaterfallParams:
    nperseg = int(C.SYMBOL_PERIOD_S * fs)
    hop = nperseg // steps_per_symbol
    nfft = int(fs / C.TONE_SPACING_HZ * bins_per_tone)
    return WaterfallParams(
        fs=float(fs), nperseg=nperseg, hop=hop, nfft=nfft,
        time_osr=steps_per_symbol, freq_osr=bins_per_tone,
        num_freq_bins=nfft // 2,
    )


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _db_scale(p: WaterfallParams) -> float:
    """1 / sum(win)^2: the 'spectrum' scaling of the dB grid."""
    return 1.0 / float(np.sum(_hann_periodic(p.nperseg)) ** 2)


def _block_geometry_ok(p: WaterfallParams) -> bool:
    """True iff the overlap-reusing block backend is exact for p."""
    return (p.hop * p.time_osr == p.nperseg
            and p.nfft == p.freq_osr * p.nperseg
            and p.hop > 0)


@functools.lru_cache(maxsize=16)
def _block_dft_matrices(hop: int, nfft: int,
                        num_freq_bins: int, freq_osr: int):
    """(hop, num_freq_bins + 2*freq_osr) cos/sin DFT matrices (float32).

    Column c corresponds to DFT bin k = c - freq_osr (the extra columns on
    both sides feed the 3-tap Hann stencil).  No window is folded in.
    """
    n = np.arange(hop)[:, None]
    k = np.arange(-freq_osr, num_freq_bins + freq_osr)[None, :]
    ang = -2.0 * np.pi * ((n * k) % nfft) / nfft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _block_combine_phases(p: WaterfallParams):
    """Per-block phase vectors w[s, k] = e^{-2pi i s k/(freq_osr*time_osr)}.

    Returns (cos, sin), each (time_osr, num_freq_bins + 2*freq_osr) float32;
    k runs over the stencil-extended bin range starting at -freq_osr.
    """
    s = np.arange(p.time_osr)[:, None]
    k = np.arange(-p.freq_osr, p.num_freq_bins + p.freq_osr)[None, :]
    # s*hop sample delay of block s => phase -2pi*s*hop*k/nfft; with
    # hop*time_osr == nperseg and nfft == freq_osr*nperseg this reduces to
    # -2pi*s*k/(freq_osr*time_osr) exactly.
    period = p.freq_osr * p.time_osr
    ang = -2.0 * np.pi * ((s * k) % period) / period
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _pick_backend(p: WaterfallParams, backend: str | None) -> str:
    """The JAX package's backend choice; only "block" is ported."""
    if backend is not None:
        if backend == "block" and not _block_geometry_ok(p):
            raise ValueError(
                "backend='block' requires hop*time_osr == nperseg and "
                f"nfft == freq_osr*nperseg; got {p} — use 'matmul' or 'fft'")
        return backend
    if _block_geometry_ok(p) and p.hop <= _MATMUL_MAX_NPERSEG \
            and p.hop * (p.num_freq_bins + 2 * p.freq_osr) \
            <= _DFT_MATRIX_MAX_ELEMS:
        return "block"
    if p.nperseg <= _MATMUL_MAX_NPERSEG \
            and p.nperseg * p.num_freq_bins <= _DFT_MATRIX_MAX_ELEMS:
        return "matmul"
    return "fft"


def _require_block(p: WaterfallParams) -> None:
    backend = _pick_backend(p, None)
    if backend != "block":
        raise NotImplementedError(
            f"the {backend!r} waterfall backend (geometry {p}) is not ported "
            "yet: ROADMAP.md, queue 1, 'waterfall backends'")


@functools.lru_cache(maxsize=8)
def _block_constants(p: WaterfallParams, device: torch.device):
    """((cos, sin) float64 DFT matrices, (cos, sin) float32 combine phases)
    of geometry ``p`` on ``device``, copied there once."""
    dft = tuple(torch.as_tensor(m, device=device).double()
                for m in _block_dft_matrices(p.hop, p.nfft, p.num_freq_bins,
                                             p.freq_osr))
    phases = tuple(torch.as_tensor(m, device=device)
                   for m in _block_combine_phases(p))
    return dft, phases


def _blocks(wave: torch.Tensor, p: WaterfallParams,
            num_frames: int) -> torch.Tensor:
    """Real (..., n) -> (..., nb, hop) non-overlapping hop blocks."""
    nb = num_frames + p.time_osr - 1
    return wave[..., : nb * p.hop].reshape(*wave.shape[:-1], nb, p.hop)


def _block_spectrum(wave: torch.Tensor, p: WaterfallParams,
                    num_frames: int) -> torch.Tensor:
    """Real (..., n) -> per-block complex64 DFT (..., nb, Kx).

    Kx = num_freq_bins + 2*freq_osr (stencil halo), nb = num_frames +
    time_osr - 1 blocks.  The products are summed in float64 and each
    value rounded once to float32: the JAX package's "highest" precision
    (exact float32), whatever the order of the sums.
    """
    blocks = _blocks(wave, p, num_frames).double()
    cos_m, sin_m = _block_constants(p, wave.device)[0]
    return torch.complex((blocks @ cos_m).float(), (blocks @ sin_m).float())


def _block_power(spec: torch.Tensor, p: WaterfallParams, num_frames: int,
                 phases: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """Combine complex block spectra (..., nb, Kx) into windowed power
    (..., T, K).  ``phases`` = (cos, sin) (time_osr, Kx) float32 tensors;
    None takes the cached ones of :func:`_block_combine_phases`."""
    if phases is None:
        phases = _block_constants(p, spec.device)[1]
    w = torch.complex(*phases)
    u = spec[..., 0:num_frames, :] * w[0]
    for s in range(1, p.time_osr):
        u = u + spec[..., s: s + num_frames, :] * w[s]
    # periodic Hann as exact 3-tap stencil over the extended bin axis
    phi = p.freq_osr
    k0, k1 = phi, phi + p.num_freq_bins
    x = (0.5 * u[..., k0:k1] - 0.25 * u[..., k0 - phi: k1 - phi]
         - 0.25 * u[..., k0 + phi: k1 + phi])
    return x.real * x.real + x.imag * x.imag


def _block_boxcar_tf(spec: torch.Tensor, p: WaterfallParams, num_frames: int,
                     phases: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """Boxcar (no-window) one-symbol DFT power grid, time-major.

    Complex block spectra (..., nb, Kx) -> (..., num_frames + 2*(time_osr
    - 1), num_freq_bins).  Row j is |X|^2 of the boxcar symbol DFT whose
    window starts at block j - (time_osr - 1): the phase combine of
    :func:`_block_power` without the Hann stencil, over spectra padded by
    time_osr - 1 zero blocks at each end, so partially captured edge
    symbols carry their exact partial sums.  The Hann frame t uses the
    same combine as row t + time_osr - 1.
    """
    if phases is None:
        phases = _block_constants(p, spec.device)[1]
    tau, phi = p.time_osr, p.freq_osr
    k0, k1 = phi, phi + p.num_freq_bins
    nbrows = num_frames + 2 * (tau - 1)
    w = torch.complex(*phases)[:, k0:k1]
    zeros = spec.new_zeros((*spec.shape[:-2], tau - 1, k1 - k0))
    padded = torch.cat([zeros, spec[..., k0:k1], zeros], dim=-2)
    u = padded[..., 0:nbrows, :] * w[0]
    for s in range(1, tau):
        u = u + padded[..., s: s + nbrows, :] * w[s]
    return u.real * u.real + u.imag * u.imag


def _power_to_db(power: torch.Tensor, p: WaterfallParams) -> torch.Tensor:
    return 10.0 * torch.log10(_DB_FLOOR + power * _db_scale(p))


def _block_waterfall_tf(spec: torch.Tensor, p: WaterfallParams,
                        num_frames: int, phases=None) -> torch.Tensor:
    """Complex block spectra -> dB waterfall in (time, freq) layout."""
    return _power_to_db(_block_power(spec, p, num_frames, phases), p)


def waterfall_real(wave: torch.Tensor, p: WaterfallParams,
                   num_frames: int) -> torch.Tensor:
    """Real audio (..., n) -> dB waterfall (..., nfft//2, num_frames).

    float32 DFT products (the JAX package's "highest" precision), laid out
    frequency-major in memory.  Only the block backend is ported; other
    geometries raise NotImplementedError.
    """
    _require_block(p)
    return _block_waterfall_tf(_block_spectrum(wave, p, num_frames), p,
                               num_frames).transpose(-1, -2).contiguous()
