"""Waterfall front-end: windowed STFT -> dB power grid.

Port of ``ft8_demodulator_tpu/ops/waterfall.py`` with its three backends,
chosen per geometry by ``_pick_backend`` as the JAX package chooses them:

* ``block``: for the standard FT8 geometry (hop * time_osr == nperseg and
  nfft == freq_osr * nperseg) the audio is cut into non-overlapping
  hop-length blocks, one (hop, num_freq_bins + 2*freq_osr) DFT product
  transforms each block once, and each frame's spectrum is recovered
  exactly as

      U_t[k] = sum_s  e^{-2pi i s k / (freq_osr*time_osr)} * P_{t+s}[k]

  followed by the periodic-Hann window applied as an exact 3-tap stencil
  in frequency, X[k] = 0.5*U[k] - 0.25*U[k-freq_osr] - 0.25*U[k+freq_osr];
* ``matmul``: overlapping frames times the window-fused (nperseg,
  nfft//2) cos/sin DFT matrices (any geometry within the matrices' size
  caps, e.g. an odd rate such as 1,999 Hz);
* ``fft``: ``torch.fft.rfft`` / ``torch.fft.fft`` of the windowed
  frames, for geometries whose DFT matrices would be too large (32,768
  Hz, where nfft is odd, 44.1 and 48 kHz).  The JAX package runs XLA's
  FFT there, not a Pallas kernel, so a library FFT is the faithful port.

The DFT products of ``block`` and ``matmul`` are summed in float64, and
the fft backend transforms in complex128; each value is rounded once to
float32 (the JAX package's "highest" precision, whatever the order of
the sums, and the same on the card and the CPU).  Complex input (the
drift-correction path) is a complex tensor or, at the boundaries that
mirror a JAX signature, a (..., n, 2) float32 [re, im] array; its spectrum
is one complex product, X = (R_r - I_i) + j(R_i + I_r) summed in float64
and rounded once (JAX rounds the four real products separately).
Spectra are native complex tensors; grids are |X|^2 / sum(win)^2 in dB.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..protocol import constants as C
from ..utils.device import entry_device

__all__ = ["WaterfallParams", "waterfall_params", "frame_signal",
           "waterfall_real", "waterfall_real_band", "waterfall_complex",
           "calculate_spectrogram"]

_DB_FLOOR = 1e-12
# Above this nperseg (hop for the block backend) the DFT matrices stop
# being the right trade; the fft backend takes over
_MATMUL_MAX_NPERSEG = 4608
# cap on DFT-matrix size (elements) before falling back to fft
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


@functools.lru_cache(maxsize=16)
def _dft_matrices(nperseg: int, nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-fused (nperseg, nfft//2) cos/sin DFT matrices (float32 host
    constants, the JAX package's values)."""
    win = _hann_periodic(nperseg)
    n = np.arange(nperseg)[:, None]
    k = np.arange(nfft // 2)[None, :]
    ang = -2.0 * np.pi * (n * k % nfft) / nfft
    cos_m = (np.cos(ang) * win[:, None]).astype(np.float32)
    sin_m = (np.sin(ang) * win[:, None]).astype(np.float32)
    return cos_m, sin_m


@functools.lru_cache(maxsize=8)
def _window(nperseg: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """JAX's float32 periodic Hann window as ``dtype`` on ``device``, built
    once."""
    return torch.as_tensor(_hann_periodic(nperseg).astype(np.float32),
                           dtype=dtype, device=device)


@functools.lru_cache(maxsize=4)
def _matmul_constants(p: WaterfallParams, device: torch.device):
    """(cos, sin) float64 copies of :func:`_dft_matrices` on ``device``."""
    return tuple(torch.as_tensor(m, device=device).double()
                 for m in _dft_matrices(p.nperseg, p.nfft))


def frame_signal(wave: torch.Tensor, nperseg: int, hop: int,
                 num_frames: int) -> torch.Tensor:
    """(..., n) -> (..., num_frames, nperseg) overlapping frames (a strided
    view)."""
    return wave.unfold(-1, nperseg, hop)[..., :num_frames, :]


def _as_complex(wave: torch.Tensor) -> torch.Tensor:
    """A complex tensor, or (..., n, 2) float [re, im] -> complex64
    (..., n)."""
    if wave.is_complex():
        return wave.to(torch.complex64)
    return torch.view_as_complex(wave.to(torch.float32).contiguous())


def _rounded_product(x: torch.Tensor, cos_m: torch.Tensor,
                     sin_m: torch.Tensor) -> torch.Tensor:
    """Real or complex (..., m) rows times the float64 (m, k) cos/sin
    matrices -> complex64 (..., k): the products summed in float64, each
    part rounded once to float32."""
    if x.is_complex():
        xr, xi = x.real.double(), x.imag.double()
        re = xr @ cos_m - xi @ sin_m
        im = xr @ sin_m + xi @ cos_m
    else:
        xd = x.double()
        re, im = xd @ cos_m, xd @ sin_m
    return torch.complex(re.float(), im.float())


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
    """The JAX package's backend choice: "block" where its geometry holds
    and its matrices fit the caps, else "matmul" within the caps, else
    "fft"."""
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
    """Real or complex (..., n) -> per-block complex64 DFT (..., nb, Kx).

    Kx = num_freq_bins + 2*freq_osr (stencil halo), nb = num_frames +
    time_osr - 1 blocks.  The products are summed in float64 and each
    value rounded once to float32: the JAX package's "highest" precision
    (exact float32), whatever the order of the sums.
    """
    return _rounded_product(_blocks(wave, p, num_frames),
                            *_block_constants(p, wave.device)[0])


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


def _power_spectrum(frames: torch.Tensor, p: WaterfallParams,
                    backend: str) -> torch.Tensor:
    """Real or complex frames (..., T, nperseg) -> positive-frequency power
    (..., T, nfft//2) float32, by the "matmul" or "fft" backend."""
    if backend == "matmul":
        x = _rounded_product(frames, *_matmul_constants(p, frames.device))
    else:
        # float64 (complex128) FFT of the frames times JAX's float32
        # window, each value rounded once: complex64 FFTs differ between
        # the card and the CPU by up to 1.4e-3 dB in the grid's low cells
        # at an odd nfft (32,768 Hz, NVIDIA H100)
        win = _window(p.nperseg, frames.device, torch.float64)
        if frames.is_complex():
            x = torch.fft.fft(frames.to(torch.complex128) * win, n=p.nfft,
                              dim=-1)
        else:
            x = torch.fft.rfft(frames.double() * win, n=p.nfft, dim=-1)
        x = x[..., : p.num_freq_bins].to(torch.complex64)
    return x.real * x.real + x.imag * x.imag


def _waterfall(wave: torch.Tensor, p: WaterfallParams, num_frames: int,
               backend: str) -> torch.Tensor:
    """Real or complex (..., n) -> frequency-major dB grid (..., F, T)."""
    if backend == "block":
        power = _block_power(_block_spectrum(wave, p, num_frames), p,
                             num_frames)
    else:
        power = _power_spectrum(frame_signal(wave, p.nperseg, p.hop,
                                             num_frames), p, backend)
    return _power_to_db(power, p).transpose(-1, -2).contiguous()


def waterfall_real(wave: torch.Tensor, p: WaterfallParams,
                   num_frames: int, backend: str | None = None
                   ) -> torch.Tensor:
    """Real audio (..., n) -> dB waterfall (..., nfft//2, num_frames),
    frequency-major in memory, on the device of ``wave``.

    ``backend`` None picks it from the geometry (``_pick_backend``);
    "block" on a geometry it does not fit raises a ValueError.
    """
    return _waterfall(wave, p, num_frames, _pick_backend(p, backend))


def _on_device(wave, device: str | torch.device) -> torch.Tensor:
    """A tensor stays on its device; a host array (float32 or complex64,
    as JAX takes it) goes to ``device``."""
    if isinstance(wave, torch.Tensor):
        return wave
    wave = np.asarray(wave)
    dtype = np.complex64 if np.iscomplexobj(wave) else np.float32
    return torch.as_tensor(wave.astype(dtype), device=entry_device(device))


def waterfall_complex(wave_ri, p: WaterfallParams, num_frames: int,
                      backend: str | None = None,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Complex signal, a complex tensor or (..., n, 2) float32 [re, im] ->
    dB waterfall (..., F, T) of the positive frequencies, on the device of
    the tensor (a host array goes to ``device``)."""
    return _waterfall(_as_complex(_on_device(wave_ri, device)), p,
                      num_frames, _pick_backend(p, backend))


def _pad_slice(m: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """Columns [start, start + width) of ``m``, zeros past its last
    column."""
    part = m[..., start: start + width]
    return F.pad(part, (0, width - part.shape[-1]))


def waterfall_real_band(wave, p: WaterfallParams, num_frames: int,
                        row_start, band_rows: int,
                        backend: str | None = None,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """dB waterfall rows [row_start, row_start + band_rows) only: (...,
    band_rows, num_frames), on the device of ``wave`` (a host array goes to
    ``device``).

    The block and matmul backends slice the DFT matrices' columns (each
    output bin is an independent dot product, so the band equals the same
    rows of :func:`waterfall_real`); the fft backend slices the full grid.
    ``row_start`` (int or 0-d tensor) is taken as ``lax.dynamic_slice``
    takes it on the padded axis: a negative start counts from that axis's
    end, and the start is clamped to [0, nfft//2].  Rows at or past
    nfft//2 read zero-padded matrix columns (the fft backend: the dB
    floor) and are meaningless; callers mask them out.
    """
    backend = _pick_backend(p, backend)
    wave = _on_device(wave, device)
    start = int(row_start)
    if start < 0:
        halo = 2 * p.freq_osr if backend == "block" else 0
        start += p.num_freq_bins + halo + band_rows
    start = min(max(start, 0), p.num_freq_bins)
    if backend == "fft":
        full = waterfall_real(wave, p, num_frames, backend)
        floor = 10.0 * np.log10(_DB_FLOOR)
        return F.pad(full, (0, 0, 0, band_rows), value=floor)[
            ..., start: start + band_rows, :]
    if backend == "block":
        phi = p.freq_osr
        width = band_rows + 2 * phi
        (cos_m, sin_m), (wc, ws) = _block_constants(p, wave.device)
        spec = _rounded_product(_blocks(wave, p, num_frames),
                                _pad_slice(cos_m, start, width),
                                _pad_slice(sin_m, start, width))
        power = _block_power(spec, p._replace(num_freq_bins=band_rows),
                             num_frames, (_pad_slice(wc, start, width),
                                          _pad_slice(ws, start, width)))
    else:
        cos_m, sin_m = _matmul_constants(p, wave.device)
        x = _rounded_product(
            frame_signal(wave, p.nperseg, p.hop, num_frames),
            _pad_slice(cos_m, start, band_rows),
            _pad_slice(sin_m, start, band_rows))
        power = x.real * x.real + x.imag * x.imag
    return _power_to_db(power, p).transpose(-1, -2).contiguous()


def calculate_spectrogram(wave_data, sample_rate: float,
                          bins_per_tone: int = 2, steps_per_symbol: int = 2,
                          device: str | torch.device = "cuda"):
    """Reference-API host wrapper: (mag_db, freqs, times) numpy arrays
    with the full two-sided fftshifted spectrum (complex64 FFT of every
    windowed frame), computed on ``device``; too-short input yields empty
    arrays."""
    wave = np.asarray(wave_data)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if wave.shape[-1] < p.nperseg:
        return np.array([[]]), np.array([]), np.array([])
    t_frames = p.num_frames(wave.shape[-1])
    x = _on_device(wave, device)
    win = _window(p.nperseg, x.device, torch.float32)
    z = frame_signal(x, p.nperseg, p.hop, t_frames) * win
    spec = torch.fft.fft(z.to(torch.complex64), n=p.nfft, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    mag = _power_to_db(power, p).transpose(-1, -2).cpu().numpy()
    mag = np.fft.fftshift(mag, axes=0)
    freqs = np.fft.fftshift(np.fft.fftfreq(p.nfft, 1.0 / sample_rate))
    times = (np.arange(t_frames) * p.hop + p.nperseg / 2) / sample_rate
    return mag, freqs, times
