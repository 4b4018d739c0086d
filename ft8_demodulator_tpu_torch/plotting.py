"""Host-side plotting utilities (strictly outside the decode path).

Equivalents of the reference's figure generators — the in-decoder
spectrogram PNG (src/ft8_tools/ft8_demodulator/ft8_decode.py:343-380, here
an explicit opt-in call), the GFSK pulse plots (src/tests/plot/gfsk_plot.py)
and the SNR / drift error curves (plot_snr_vs_freq_error.py,
plot_drift_vs_freq_error.py).  matplotlib is imported lazily with the Agg
backend so headless use never needs a display.

A copy of ``ft8_demodulator_tpu/plotting.py`` with the same names and
behaviour (the GFSK pulse from this package's ``ops/gfsk.py``, on the
CPU), so that the port loads nothing of the JAX package
(``tests/test_torch_io_compat.py`` holds the two equal).
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_spectrogram", "plot_gfsk_pulse", "plot_snr_vs_freq_error",
           "plot_drift_vs_freq_error", "plot_snr_curve"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_spectrogram(mag_db: np.ndarray, freqs: np.ndarray, times: np.ndarray,
                     candidates=None, path: str = "ft8_spectrogram.png",
                     title: str = "FT8 Signal Spectrogram") -> str:
    """Waterfall image with optional candidate markers (decode results)."""
    plt = _plt()
    plt.figure(figsize=(10, 6))
    plt.imshow(np.asarray(mag_db), aspect="auto", origin="lower",
               extent=[times[0], times[-1], freqs[0], freqs[-1]])
    plt.colorbar(label="Intensity (dB)")
    plt.title(title)
    plt.xlabel("Time (s)")
    plt.ylabel("Frequency (Hz)")
    if candidates:
        for i, r in enumerate(candidates):
            plt.plot(r.time_sec, r.freq_hz, "ro", markersize=4)
            plt.annotate(f"{i + 1}:{r.score:.1f}", (r.time_sec, r.freq_hz),
                         xytext=(5, 5), textcoords="offset points",
                         color="white", fontsize=8,
                         bbox=dict(boxstyle="round,pad=0.3", fc="red",
                                   alpha=0.7))
    plt.savefig(path)
    plt.close()
    return path


def plot_gfsk_pulse(bt: float = 2.0, path: str = "gfsk_pulse.png") -> str:
    """The Gaussian frequency pulse and its three symbol segments."""
    import torch

    from .ops.gfsk import gauss_window

    plt = _plt()
    t = np.linspace(-1.5, 1.5, 601)
    w = gauss_window(bt, torch.as_tensor(t, dtype=torch.float32)).numpy()
    plt.figure(figsize=(8, 4))
    plt.plot(t, w)
    for edge in (-0.5, 0.5):
        plt.axvline(edge, color="gray", linestyle="--", alpha=0.5)
    plt.title(f"GFSK Gaussian pulse (BT={bt})")
    plt.xlabel("Symbols")
    plt.grid(True)
    plt.savefig(path)
    plt.close()
    return path


def plot_snr_vs_freq_error(snr_db, freq_err_hz,
                           path: str = "snr_vs_freq_error.png") -> str:
    """Drift-estimate error vs Es/N0 (reference plot_snr_vs_freq_error.py)."""
    plt = _plt()
    plt.figure(figsize=(8, 5))
    plt.plot(snr_db, freq_err_hz, "o-")
    plt.xlabel("Es/N0 (dB)")
    plt.ylabel("Frequency error (Hz)")
    plt.title("Drift-corrected frequency error vs SNR")
    plt.grid(True)
    plt.savefig(path)
    plt.close()
    return path


def plot_drift_vs_freq_error(drift_hz_per_s, freq_err_hz,
                             path: str = "drift_vs_freq_error.png") -> str:
    """Error vs injected drift rate (reference plot_drift_vs_freq_error.py)."""
    plt = _plt()
    plt.figure(figsize=(8, 5))
    plt.plot(drift_hz_per_s, freq_err_hz, "s-")
    plt.xlabel("Drift rate (Hz/s)")
    plt.ylabel("Frequency error (Hz)")
    plt.title("Frequency error vs drift rate")
    plt.grid(True)
    plt.savefig(path)
    plt.close()
    return path


def plot_snr_curve(snr_db, success_rate, fs: float,
                   path: str = "snr_curve.png") -> str:
    """Yield-vs-SNR curve from benchmarks/snr_curve.py output."""
    plt = _plt()
    plt.figure(figsize=(8, 5))
    plt.plot(snr_db, success_rate, "o-")
    plt.axhline(0.5, color="r", linestyle="--", label="50% criterion")
    plt.xlabel("SNR (dB)")
    plt.ylabel("Decode success rate")
    plt.title(f"FT8 decode yield vs SNR (fs={fs:.0f} Hz)")
    plt.legend()
    plt.grid(True)
    plt.savefig(path)
    plt.close()
    return path


def plot_snr_vs_bandwidth(bandwidth_hz, min_snr_db,
                          path: str = "snr_vs_bandwidth.png") -> str:
    """Sensitivity-vs-bandwidth curve (reference test_ft8_standard.py:111)."""
    plt = _plt()
    plt.figure(figsize=(8, 5))
    plt.plot(bandwidth_hz, min_snr_db, "o-")
    plt.xlabel("Noise bandwidth fs/2 (Hz)")
    plt.ylabel("Min full-band SNR with >=50% decode (dB)")
    plt.title("FT8 sensitivity vs bandwidth")
    plt.grid(True)
    plt.savefig(path)
    plt.close()
    return path


def plot_rx_fft(sdr, path: str = "rx_fft.png",
                center_freq: float = 0.0) -> str:
    """Grab ONE buffer from an `io.sdr.SDRInterface` and plot its power
    spectrum — the live RX-spectrum eyeball of the reference's SDR
    diagnostic scripts (src/tests/pluto-sdr/plot_fft.py:1-85,
    simple_fft_plot.py), hardware-agnostic behind the adapter seam
    (works with LoopbackSDR in tests, PlutoSDR on real hardware)."""
    samples = np.asarray(sdr.rx())
    return plot_fft(samples, float(sdr.sample_rate), path=path,
                    center_freq=center_freq)


def plot_fft(samples, fs: float, path: str = "fft.png",
             center_freq: float = 0.0) -> str:
    """Averaged power spectrum of a capture (reference
    src/tests/pluto-sdr/plot_fft.py / simple_fft_plot.py equivalents)."""
    plt = _plt()
    x = np.asarray(samples)
    n = min(len(x), 65536)
    spec = np.fft.fftshift(np.fft.fft(x[:n]))
    freqs = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / fs)) + center_freq
    plt.figure(figsize=(8, 5))
    plt.plot(freqs, 10 * np.log10(1e-12 + np.abs(spec) ** 2))
    plt.xlabel("Frequency (Hz)")
    plt.ylabel("Power (dB)")
    plt.title("Capture spectrum")
    plt.grid(True)
    plt.savefig(path)
    plt.close()
    return path
