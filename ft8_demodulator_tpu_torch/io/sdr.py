"""SDR hardware-in-the-loop adapter seam.

The reference drives an ADALM-Pluto directly from test scripts
(src/tests/pluto-sdr/sender.py:14-49, receive.py:17-78).  Here the hardware
sits behind a small interface so the TX/RX pipelines are testable without a
radio: `LoopbackSDR` is the software fake (optionally with AWGN), and
`PlutoSDR` adapts the real device through pyadi-iio when it is installed.

Port of ``ft8_demodulator_tpu/io/sdr.py``: the radios and
`qpsk_loopback_check` are copies; `transmit_ft8` and `receive_and_decode`
run this package's TX and decode on ``device`` (the card unless the
caller asks for the CPU) and hand numpy to the radio.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SDRInterface", "LoopbackSDR", "PlutoSDR", "transmit_ft8",
           "receive_and_decode", "qpsk_loopback_check"]


class SDRInterface:
    """Minimal SDR contract: complex-baseband tx / buffered rx."""

    sample_rate: float
    rx_buffer_size: int

    def tx(self, samples: np.ndarray) -> None:
        raise NotImplementedError

    def rx(self) -> np.ndarray:
        """One buffer of complex64 samples."""
        raise NotImplementedError


@dataclass
class LoopbackSDR(SDRInterface):
    """Software loopback: rx() replays what was tx()ed, plus optional noise
    and DC offset (so the receive pipeline's DC removal is exercised)."""

    sample_rate: float = 1e6
    rx_buffer_size: int = 160000
    noise_sigma: float = 0.0
    dc_offset: complex = 0.0
    seed: int = 0

    def __post_init__(self):
        self._tx_data = np.zeros(0, np.complex64)
        self._cursor = 0
        self._rng = np.random.default_rng(self.seed)

    def tx(self, samples: np.ndarray) -> None:
        self._tx_data = np.asarray(samples, np.complex64)
        self._cursor = 0

    def rx(self) -> np.ndarray:
        out = np.zeros(self.rx_buffer_size, np.complex64)
        end = min(self._cursor + self.rx_buffer_size, len(self._tx_data))
        take = max(0, end - self._cursor)
        if take:
            out[:take] = self._tx_data[self._cursor:end]
        self._cursor += self.rx_buffer_size
        if self.noise_sigma:
            out = out + (self._rng.standard_normal(len(out))
                         + 1j * self._rng.standard_normal(len(out))
                         ).astype(np.complex64) * self.noise_sigma
        return out + np.complex64(self.dc_offset)


class PlutoSDR(SDRInterface):
    """ADALM-Pluto adapter (requires pyadi-iio, not bundled here)."""

    def __init__(self, uri: str = "ip:192.168.3.2", sample_rate: float = 1e6,
                 center_freq: float = 1e9, rx_gain_db: float = -20.0,
                 tx_gain_db: float = -50.0,
                 rx_buffer_size: int | None = None):
        try:
            import adi
        except ImportError as e:  # pragma: no cover - hardware path
            raise ImportError(
                "PlutoSDR requires the pyadi-iio package (pip install "
                "pyadi-iio) and attached hardware") from e
        self.sample_rate = sample_rate
        self.rx_buffer_size = rx_buffer_size or int(sample_rate * 0.16)
        dev = adi.Pluto(uri)
        dev.sample_rate = int(sample_rate)
        dev.rx_lo = int(center_freq)
        dev.tx_lo = int(center_freq)
        dev.rx_rf_bandwidth = int(sample_rate)
        dev.tx_rf_bandwidth = int(sample_rate)
        dev.gain_control_mode_chan0 = "manual"
        dev.rx_hardwaregain_chan0 = rx_gain_db
        dev.tx_hardwaregain_chan0 = tx_gain_db
        dev.rx_buffer_size = self.rx_buffer_size
        self._dev = dev

    def tx(self, samples: np.ndarray) -> None:  # pragma: no cover
        self._dev.tx(np.asarray(samples) * (2 ** 14))

    def rx(self) -> np.ndarray:  # pragma: no cover
        return np.asarray(self._dev.rx())


def transmit_ft8(sdr: SDRInterface, payload: np.ndarray, f0: float = 500.0,
                 fc: float = 0.0, device="cuda") -> np.ndarray:
    """Generate (on ``device``) and transmit one FT8 frame; returns the
    complex64 waveform sent (reference sender.py:31-49, minus the infinite
    retransmit loop)."""
    from ..ops.gfsk import ft8_baseband

    wave = ft8_baseband(np.asarray(payload, np.uint8), sdr.sample_rate, f0,
                        device=device).cpu().numpy()
    wave = wave * np.exp(2j * np.pi * fc * np.arange(len(wave))
                         / sdr.sample_rate).astype(np.complex64)
    sdr.tx(wave.astype(np.complex64))
    return wave


def receive_and_decode(sdr: SDRInterface, num_buffers: int = 30,
                       device="cuda", **decode_kwargs):
    """Collect buffers, remove DC, decode on ``device`` (reference
    receive.py:33-78)."""
    from ..demod import decode_ft8_message

    chunks = [sdr.rx() for _ in range(num_buffers)]
    samples = np.concatenate(chunks)
    samples = samples - np.mean(samples)
    return decode_ft8_message(samples, sdr.sample_rate, device=device,
                              **decode_kwargs)


def qpsk_loopback_check(sdr: SDRInterface, num_symbols: int = 1000,
                        sps: int = 16, seed: int = 0) -> float:
    """Modulation-agnostic SDR-path sanity check: QPSK through tx/rx.

    The reference's hardware smoke test (pluto-sdr/test_basic.py:24-46)
    pushes 1000 rectangular-pulse QPSK symbols through the radio and
    eyeballs the constellation; this is that check behind the
    SDRInterface seam with an asserted statistic instead of a plot:
    transmit `num_symbols` random QPSK symbols at `sps` samples/symbol,
    receive one buffer, DC-remove, and hard-demod by quadrant at the
    symbol centres.  Returns the fraction of symbols recovered (1.0 on
    a clean loopback; a real radio with noise/gain error scores lower —
    the reference treats >~0.9 as a healthy path).
    """
    rng = np.random.default_rng(seed)
    x_int = rng.integers(0, 4, num_symbols)
    ang = x_int * (np.pi / 2.0) + np.pi / 4.0       # 45/135/225/315 deg
    symbols = np.exp(1j * ang).astype(np.complex64)
    samples = np.repeat(symbols, sps)
    sdr.tx(samples)
    rx = np.asarray(sdr.rx())[: num_symbols * sps]
    rx = rx - np.mean(rx)
    centres = rx.reshape(-1, sps)[:, sps // 2]
    got = (np.floor(np.mod(np.angle(centres), 2 * np.pi)
                    / (np.pi / 2.0))).astype(int)
    n = min(len(got), num_symbols)
    return float(np.mean(got[:n] == x_int[:n])) if n else 0.0
