"""The beacon cells' traffic: a LEO satellite's FT8 beacon through passes,
as a ground station's sound card hands it over.

A traffic file (``traffic/pass.json``) and a seed -> ``pool_passes``
passes of ``cycles_per_pass`` 15-s cycles of real float32 audio at ``fs``,
on the host.  Each pass has one beacon: one random 77-bit payload sent in
every cycle; a carrier at each cycle's start of ``carrier_hz`` plus one
uniform draw over +-``carrier_spread_hz`` a pass; a linear drift from each
cycle's start at one rate a pass, uniform over +-``drift_hz_per_s`` (the
residual of a Doppler-precompensated pass plus a keyed transmitter's
repeatable chirp, so the same in every cycle); a start uniform over
``start_s`` in each cycle; and a per-cycle SNR that follows the pass,
``snr_db_ends`` at both ends rising as 1 - x^2 (x from -1 to 1 over the
pass) to ``snr_db_middle`` (2,500-Hz convention over unit-variance noise at
``fs``, the generator's).

Parameters come from ``numpy.random.default_rng(seed)``, the noise from a
``torch.Generator`` on the device seeded with ``seed``, and the GFSK from
the benchmark's frozen transmitter (``reference/tx.py``), with the drift's
phase accumulated in float64 beside the tones'.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .reference import constants as C
from .reference.tx import _pulse, encode_tones

__all__ = ["Pass", "snr_profile", "make_passes"]


class Pass(NamedTuple):
    """One pass: (cycles, n) float32 host audio and what it holds."""

    audio: np.ndarray
    payload: bytes
    carrier_hz: float
    drift_hz_per_s: float
    start_s: np.ndarray          # (cycles,)
    snr_db: np.ndarray           # (cycles,)


def snr_profile(traffic: dict) -> np.ndarray:
    """(cycles,) SNR in dB of each cycle of a pass."""
    n = int(traffic["cycles_per_pass"])
    x = np.linspace(-1.0, 1.0, n) if n > 1 else np.zeros(1)
    lo, hi = float(traffic["snr_db_ends"]), float(traffic["snr_db_middle"])
    return lo + (hi - lo) * (1.0 - x * x)


def _drifting_gfsk(tones: torch.Tensor, carrier_hz: float, rate: float,
                   first: np.ndarray, fs: float, sps: int) -> torch.Tensor:
    """(79,) tone ids -> (S, 79 sps) float64 unit-amplitude GFSK, one row a
    cycle whose transmission starts at sample ``first[s]``: the carrier at
    the cycle's start plus ``rate`` Hz/s from it, the tx's pulse, ramps
    and exclusive phase sum."""
    dev = tones.device
    w0, w1, w2 = _pulse(sps, dev)
    t = tones.to(torch.float64)[None]
    te = torch.cat([t[:, :1], t, t[:, -1:]], dim=-1)
    track = (te[:, 0:79, None] * w2 + te[:, 1:80, None] * w1
             + te[:, 2:81, None] * w0).reshape(1, -1)
    n = track.shape[-1]
    tau = (torch.as_tensor(first, dtype=torch.float64, device=dev)[:, None]
           + torch.arange(n, dtype=torch.float64, device=dev)) / fs
    inc = (carrier_hz + rate * tau + track * C.TONE_SPACING_HZ) / fs
    cycles = torch.cumsum(inc, dim=-1) - inc
    wave = torch.sin(2.0 * np.pi * torch.remainder(cycles, 1.0))
    i = torch.arange(n, dtype=torch.float64, device=dev)
    nramp = sps // 8
    ramp = torch.ones_like(i)
    ramp = torch.where(i < nramp,
                       0.5 * (1.0 - torch.cos(8.0 * np.pi * i / sps)), ramp)
    ramp = torch.where(i >= n - nramp, 0.5 * (1.0 + torch.cos(
        8.0 * np.pi * (n - 1 - i) / sps)), ramp)
    return wave * ramp


def make_passes(traffic: dict, seed: int, device) -> list[Pass]:
    """The pool: ``pool_passes`` passes made on ``device``, handed to the
    host as float32."""
    fs = float(traffic["fs"])
    n = int(round(traffic["cycle_s"] * fs))
    sps = int(round(C.SYMBOL_PERIOD_S * fs))
    cycles = int(traffic["cycles_per_pass"])
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    snr = snr_profile(traffic)
    amp = np.sqrt(2.0 * 10.0 ** (snr / 10.0) * 2500.0 / (fs / 2.0))
    out = []
    for _ in range(int(traffic["pool_passes"])):
        payload = rng.integers(0, 256, 10, dtype=np.uint8)
        payload[9] &= 0xF8
        carrier = float(traffic["carrier_hz"]) + rng.uniform(
            -1.0, 1.0) * float(traffic["carrier_spread_hz"])
        lo, hi = traffic["drift_hz_per_s"]
        rate = float(rng.choice([-1.0, 1.0]) * rng.uniform(lo, hi))
        start = rng.uniform(*traffic["start_s"], cycles)
        first = np.round(start * fs).astype(np.int64)
        tones = encode_tones(torch.as_tensor(payload, device=device))
        sig = _drifting_gfsk(tones, carrier, rate, first, fs, sps) \
            * torch.as_tensor(amp, dtype=torch.float64, device=device)[:, None]
        x = torch.randn((cycles, n), generator=gen, device=device,
                        dtype=torch.float32)
        idx = torch.as_tensor(first, device=device)[:, None] \
            + torch.arange(sig.shape[-1], device=device)
        keep = idx < n
        x.scatter_add_(1, idx.clamp(max=n - 1),
                       torch.where(keep, sig, 0.0).to(torch.float32))
        out.append(Pass(x.cpu().numpy(), bytes(payload.tolist()), carrier,
                        rate, start, snr))
    return out
