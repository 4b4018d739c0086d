"""The one traffic generator: a traffic file's parameters and a seed ->
15-s 12-kHz FT8 slots on the device.

Each slot holds ``signals`` transmissions of random 77-bit payloads at SNRs
spread evenly over ``snr_db`` (2,500-Hz convention, unit-variance noise),
in a random order per slot; carriers uniform over ``freq_hz`` with at least
``min_spacing_hz`` between neighbours (uniform over that constrained set:
sorted uniforms over the band shortened by the spacings, then spread by
them, which is what drawing and rejecting gives); starts uniform over
``start_s``.  Carriers and starts are continuous, so the signals sit off
the search grid in time and frequency.  With ``buried_db`` each slot adds
one more transmission that much under its strongest, ``buried_offset_hz``
above it and ``buried_delay_symbols`` later.

The per-slot parameters come from ``numpy.random.default_rng(seed)`` (a few
thousand numbers), the noise from a ``torch.Generator`` on the device
seeded with ``seed``, and the audio from the benchmark's own transmitter
(``reference/tx.py``).  Every seed gives the same set of SNRs, signal
counts and sizes: only the order, carriers, starts, payloads and noise
differ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .reference import constants as C
from .reference.tx import encode_tones, passband

__all__ = ["Planted", "make_slots"]


class Planted(NamedTuple):
    """What the generator put in each slot: (B, M) arrays, host numpy."""

    payload: np.ndarray        # (B, M, 10) uint8
    snr_db: np.ndarray
    freq_hz: np.ndarray
    start_s: np.ndarray


def _draw(rng: np.random.Generator, traffic: dict, batch: int) -> Planted:
    m = int(traffic["signals"])
    lo, hi = traffic["freq_hz"]
    gap = float(traffic["min_spacing_hz"])
    f0 = np.sort(rng.uniform(lo, hi - (m - 1) * gap, (batch, m)), axis=1) \
        + gap * np.arange(m)
    snr = np.linspace(*traffic["snr_db"], m)
    snr = np.stack([rng.permutation(snr) for _ in range(batch)])
    start = rng.uniform(*traffic["start_s"], (batch, m))
    payload = rng.integers(0, 256, (batch, m, 10), dtype=np.uint8)
    if traffic.get("buried_db") is not None:
        strong = np.argmax(snr, axis=1)
        pick = lambda a: a[np.arange(batch), strong][:, None]
        f0 = np.concatenate([f0, pick(f0) + traffic["buried_offset_hz"]], 1)
        snr = np.concatenate([snr, pick(snr) - traffic["buried_db"]], 1)
        start = np.concatenate(
            [start, pick(start) + traffic["buried_delay_symbols"]
             * C.SYMBOL_PERIOD_S], 1)
        payload = np.concatenate(
            [payload, rng.integers(0, 256, (batch, 1, 10), dtype=np.uint8)], 1)
    payload[..., 9] &= 0xF8
    return Planted(payload, snr, f0, start)


def make_slots(traffic: dict, seed: int, batches: int, device
               ) -> tuple[list[torch.Tensor], list[Planted]]:
    """``batches`` (batch, n) float32 tensors of slots on ``device`` and
    what each holds."""
    fs = float(traffic["fs"])
    n = int(round(traffic["slot_s"] * fs))
    sps = int(round(C.SYMBOL_PERIOD_S * fs))
    batch = int(traffic["batch"])
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    waves, planted = [], []
    for _ in range(batches):
        plan = _draw(rng, traffic, batch)
        x = torch.randn((batch, n), generator=gen, device=device,
                        dtype=torch.float32)
        tones = encode_tones(torch.as_tensor(plan.payload, device=device))
        length = C.NUM_SYMBOLS * sps
        for j in range(plan.payload.shape[1]):
            amp = np.sqrt(2.0 * 10.0 ** (plan.snr_db[:, j] / 10.0) * 2500.0
                          / (fs / 2.0))
            sig = passband(tones[:, j], torch.as_tensor(
                plan.freq_hz[:, j], device=device), fs, sps)
            sig = sig * torch.as_tensor(amp, dtype=torch.float32,
                                        device=device)[:, None]
            first = torch.as_tensor((plan.start_s[:, j] * fs).astype(np.int64),
                                    device=device)
            idx = first[:, None] + torch.arange(length, device=device)
            keep = idx < n
            x.scatter_add_(1, idx.clamp(max=n - 1), torch.where(keep, sig, 0.0))
        waves.append(x)
        planted.append(plan)
    return waves, planted
