"""The traffic of an SDR skimmer: one band's continuous 12-kHz audio as the
receiver hands it over, in fixed buffers that are not aligned to the UTC
15-s slots.

A traffic file (``traffic/feed.json``) and a seed -> a pool of ``pool``
distinct 15-s slots, made on the device by the one traffic generator
(``generator.py``: ``signals`` transmissions a slot with random payloads,
SNRs spread evenly over ``snr_db``, carriers over ``freq_hz`` at least
``min_spacing_hz`` apart, starts over ``start_s`` after the slot's
boundary, unit-variance noise), handed to the host.  The stream is the
pool's slots in order, repeated without end; its slot boundaries lie
``offset_s`` after the stream's sample 0, one draw from the seed over
``offset_s``'s range, so a block edge falls anywhere in a slot.  Before the
first boundary the stream holds the tail of the pool's last slot.

A call is the next ``call_s`` seconds of the stream, as buffers of
``buffer_samples`` samples (the last buffer of a call may be shorter).  The
offset comes from ``numpy.random.default_rng([seed, 2])``, so the slots are
the generator's for the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import generator

__all__ = ["Stream", "make_stream"]


class Stream(NamedTuple):
    """The stream of a seed: its pool, laid out from sample 0, and what
    each slot of the pool holds."""

    fs: float
    slot_len: int              # samples a slot
    call_len: int              # samples a call
    buffer_len: int            # samples a buffer
    offset: int                # the first slot boundary, in samples
    audio: np.ndarray          # (pool * slot_len,) float32: stream sample
    #                            s is audio[s % len(audio)]
    planted: generator.Planted  # (pool, M) arrays of the pool's slots

    def samples(self, lo: int, hi: int) -> np.ndarray:
        """Stream samples [lo, hi) (lo >= 0), a new float32 array."""
        n = len(self.audio)
        return np.take(self.audio, np.arange(lo, hi) % n)

    def call(self, i: int) -> list[np.ndarray]:
        """Call ``i``'s buffers: views of the stream."""
        n = len(self.audio)
        lo = (i * self.call_len) % n
        if lo + self.call_len <= n:
            part = self.audio[lo: lo + self.call_len]
        else:
            part = self.samples(i * self.call_len, (i + 1) * self.call_len)
        return [part[j: j + self.buffer_len]
                for j in range(0, self.call_len, self.buffer_len)]


def make_stream(traffic: dict, seed: int, device) -> Stream:
    """The seed's stream: the pool made on ``device``, then on the host."""
    fs = float(traffic["fs"])
    waves, planted = generator.make_slots(
        dict(traffic, batch=int(traffic["pool"])), seed, 1, device)
    slot_len = waves[0].shape[-1]
    rng = np.random.default_rng([seed, 2])
    offset = int(round(rng.uniform(*traffic["offset_s"]) * fs)) % slot_len
    flat = waves[0].reshape(-1).cpu().numpy()
    return Stream(fs, slot_len, int(round(traffic["call_s"] * fs)),
                  int(traffic["buffer_samples"]), offset,
                  np.roll(flat, offset), planted[0])
