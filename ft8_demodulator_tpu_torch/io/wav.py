"""WAV PCM reader/writer on the stdlib wave module (no soundfile dep).

Matches the reference's read_wave_file behaviour
(src/tests/demodulator/from_wave.py:24): 8/16/32-bit PCM, stereo collapsed
to the first channel, samples normalised to [-1, 1] by the integer max.
Beyond the reference: 24-bit PCM (the common SDR-recorder width) is also
accepted.

A copy of ``ft8_demodulator_tpu/io/wav.py`` with the same names and
behaviour, so that the port loads nothing of the JAX package
(``tests/test_torch_io_compat.py`` holds the two equal).
"""

from __future__ import annotations

import wave as _wave

import numpy as np

__all__ = ["read_wave_file", "write_wave_file"]

_WIDTH_DTYPES = {1: np.uint8, 2: np.int16, 4: np.int32}


def read_wave_file(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    with _wave.open(path, "rb") as f:
        n_channels = f.getnchannels()
        width = f.getsampwidth()
        rate = f.getframerate()
        raw = f.readframes(f.getnframes())
    if width == 3:
        # 24-bit packed little-endian PCM: widen to int32, sign-extend
        b = np.frombuffer(raw, np.uint8).reshape(-1, n_channels, 3)[:, 0, :]
        data = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        data = (data ^ 0x800000) - 0x800000
        return data.astype(np.float32) / float(2 ** 23 - 1), rate
    if width not in _WIDTH_DTYPES:
        raise ValueError(f"Unsupported sample width: {width}")
    data = np.frombuffer(raw, dtype=_WIDTH_DTYPES[width])
    if n_channels > 1:
        data = data[::n_channels]
    data = data.astype(np.float32)
    if width == 1:  # 8-bit PCM is unsigned
        data -= 128.0
        data /= 127.0
    else:
        data /= np.iinfo(_WIDTH_DTYPES[width]).max
    return data, rate


def write_wave_file(path: str, samples: np.ndarray, sample_rate: int,
                    width: int = 2) -> None:
    """Write float samples in [-1, 1] as PCM WAV."""
    if width != 2:
        raise ValueError("only 16-bit output supported")
    clipped = np.clip(np.asarray(samples), -1.0, 1.0)
    pcm = (clipped * np.iinfo(np.int16).max).astype(np.int16)
    with _wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(pcm.tobytes())
