"""Random decode trials in the form of benchmarks/soak.py, for
tests/test_torch_soak.py (the port against JAX on the CPU) and chip_smoke.py
phase 19 (the card against the CPU).  Imports neither JAX nor the JAX
package: the audio comes from the port's TX on the CPU and numpy noise, so
every consumer decodes identical input.

* :func:`soak_trials` draws single-signal captures as soak.py:58-101 does
  (the same draws from ``default_rng(seed)``, in the same order), and
  turns ``use_osd`` on every other trial;
* :func:`planted_fault` applies soak.py's asserts (:103-146) to a decode's
  rows;
* :func:`slot_batch` makes a batch of slots with a few signals each, for
  ``decode_slots``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ft8_demodulator_tpu_torch.ops.gfsk import ft8_baseband, ft8_passband
from ft8_demodulator_tpu_torch.protocol import constants as C

# benchmarks/soak.py:31
RATES = (2000.0, 3000.0, 4000.0, 6000.0, 8000.0, 10500.0, 12000.0)
DEEP_EVERY = 8          # osr 4x4
HIGH_OSR_EVERY = 10     # trial % 10 == 3: osr {3, 5, 10} at 2 or 3 kHz
COMPLEX_EVERY = 5       # trial % 5 == 1: complex baseband
SLOT_SECONDS = (13.6, 15.0)
# soak.py's SNR tolerance, dB
SNR_TOL_DB = 3.5


@dataclass(frozen=True)
class SoakTrial:
    """One drawn capture and the decode options soak.py gives it."""

    seed: int
    trial: int
    snr_db: float
    fs: float
    osr: int
    is_complex: bool
    use_osd: bool
    payload: bytes
    f0: float
    start: int
    slot_s: float
    amp: float
    audio: np.ndarray

    @property
    def decode_kwargs(self) -> dict:
        """decode_ft8_message's options, as soak.py passes them."""
        return dict(bins_per_tone=self.osr, steps_per_symbol=self.osr,
                    min_score=1.0, use_osd=self.use_osd, mf_first=True)

    @property
    def repro(self) -> dict:
        """soak.py's reproduction tuple, with the seed, SNR and OSD flag."""
        return {"seed": self.seed, "trial": self.trial,
                "snr_db": self.snr_db, "fs": self.fs, "osr": self.osr,
                "complex": self.is_complex, "use_osd": self.use_osd,
                "payload": self.payload.hex(), "f0": round(self.f0, 3),
                "start": self.start, "slot_s": self.slot_s,
                "amp": round(self.amp, 4)}


def _trial(rng: np.random.Generator, seed: int, trial: int,
           snr_db: float) -> SoakTrial:
    fs = float(rng.choice(RATES))
    osr = 4 if trial % DEEP_EVERY == 0 else 2
    if trial % HIGH_OSR_EVERY == 3:
        osr = int(rng.choice([3, 5, 10]))
        fs = float(rng.choice(RATES[:2]))
    payload = rng.integers(0, 256, size=10, dtype=np.uint8)
    payload[9] &= 0xF8
    grid_step = C.TONE_SPACING_HZ / osr
    f0 = float(rng.uniform(12 * grid_step, fs / 2 - 10 * C.TONE_SPACING_HZ))
    slot_s = float(rng.choice(SLOT_SECONDS))
    n = int(fs * slot_s)
    is_complex = trial % COMPLEX_EVERY == 1
    amp = float(10.0 ** rng.uniform(-2.0, 2.0))
    if is_complex:
        wave = ft8_baseband(payload, fs, f0, device="cpu").numpy()
        start = int(rng.integers(0, max(1, n - len(wave))))
        sig = np.zeros(n, np.complex64)
        sig[start: start + len(wave)] = wave * amp
        sp = float(np.mean(np.abs(wave * amp) ** 2))
        nz = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        sig += (nz * np.sqrt(sp / 10 ** (snr_db / 10) / 2)
                ).astype(np.complex64)
    else:
        wave = ft8_passband(payload, fs, f0, 0.0, device="cpu").numpy()
        start = int(rng.integers(0, max(1, n - len(wave))))
        sig = np.zeros(n, np.float32)
        sig[start: start + len(wave)] = wave * amp
        sp = float(np.mean((wave * amp) ** 2))
        sig += rng.standard_normal(n).astype(np.float32) \
            * np.sqrt(sp / 10 ** (snr_db / 10))
    return SoakTrial(seed, trial, snr_db, fs, osr, is_complex,
                     trial % 2 == 1, bytes(payload.tolist()), f0, start,
                     slot_s, amp, sig)


def soak_trials(seed: int, count: int, snr_db: float) -> list[SoakTrial]:
    """Trials 0..count-1 of soak.py's draw from default_rng(seed), each at
    ``snr_db`` (in fs/2 for real audio, fs for complex)."""
    rng = np.random.default_rng(seed)
    return [_trial(rng, seed, t, snr_db) for t in range(count)]


def planted_fault(trial: SoakTrial, rows) -> str | None:
    """soak.py's asserts on a decode's rows: the planted payload decodes,
    at the planted time within 1.5 grid cells (at least a quarter symbol),
    the planted frequency within 2.5 cells (at least half a tone), and the
    SNR within SNR_TOL_DB of the injected one in 2500 Hz.  None if they
    hold, else why not."""
    hit = [r for r in rows if r.message.payload == trial.payload]
    if not hit:
        return "payload not decoded"
    r = hit[0]
    dt = abs(r.time_sec - trial.start / trial.fs)
    df = abs(r.freq_hz - trial.f0)
    tol_t = max(1.5 * C.SYMBOL_PERIOD_S / trial.osr, C.SYMBOL_PERIOD_S / 4)
    tol_f = max(2.5 * C.TONE_SPACING_HZ / trial.osr, C.TONE_SPACING_HZ / 2)
    if dt > tol_t + 1e-6:
        return f"time off by {dt:.3f} s"
    if df > tol_f + 1e-6:
        return f"freq off by {df:.2f} Hz"
    if r.snr_db is not None:
        bw = trial.fs if trial.is_complex else trial.fs / 2
        expect = trial.snr_db + 10.0 * np.log10(bw / 2500.0)
        if abs(r.snr_db - expect) > SNR_TOL_DB:
            return f"snr {r.snr_db:.1f} vs expected {expect:.1f} dB"
    return None


def slot_batch(seed: int, fs: float, slot_s: float, batch: int,
               snr_db: tuple[float, ...]
               ) -> tuple[np.ndarray, list[list[bytes]]]:
    """(waves (batch, n) float32, payloads per slot): unit-variance white
    noise from default_rng(seed), each slot holding one random payload at
    each SNR of ``snr_db`` (over the noise in fs/2, soak.py's measure), at
    off-grid frequencies at least 60 Hz apart in [100 Hz, fs/2 - 100 Hz],
    starting in the slot's first 2 s (whole inside the slot)."""
    rng = np.random.default_rng(seed)
    n = int(fs * slot_s)
    waves = rng.standard_normal((batch, n)).astype(np.float32)
    signals = len(snr_db)
    # a unit-amplitude tone carries power 1/2
    amps = np.sqrt(2.0 * 10.0 ** (np.asarray(snr_db) / 10.0))
    planted = []
    for b in range(batch):
        while True:
            f0 = np.sort(rng.uniform(100.0, fs / 2 - 100.0, signals))
            if signals < 2 or np.diff(f0).min() >= 60.0:
                break
        payloads = rng.integers(0, 256, (signals, 10), dtype=np.uint8)
        payloads[:, 9] &= 0xF8
        latest = min(int(2 * fs), n - C.NUM_SYMBOLS * int(
            C.SYMBOL_PERIOD_S * fs))
        starts = rng.integers(0, latest + 1, signals)
        for pl, f, s, amp in zip(payloads, f0, starts, amps):
            sig = ft8_passband(pl, fs, float(f), 0.0, device="cpu").numpy()
            waves[b, s: s + len(sig)] += np.float32(amp) * sig
        planted.append([bytes(pl.tolist()) for pl in payloads])
    return waves, planted
