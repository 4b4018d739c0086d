"""The traffic of a station in a QSO: a traffic file's parameters and a seed
-> a pool of 15-s 12-kHz captures on the device, each a band of standard
(i3 = 1) FT8 messages packed by the reference's packer
(``reference/message.py``).

Each capture holds, in a random order over the band:

* ``qsos`` transmissions of QSOs between other stations, "CALL1 CALL2 X"
  with X drawn from a grid, a report, an R+report, RR73 and 73, at SNRs
  spread evenly over ``qso_snr_db``;
* ``cqs`` calls "CQ CALL GRID" at SNRs spread evenly over ``cq_snr_db``;
* ``callers`` answers to the station, "MYCALL CALL GRID", over
  ``caller_snr_db``;
* one message from the QSO partner, "MYCALL DXCALL X", X the capture's
  place in the QSO (its index in the pool, modulo ``partner_exchange``'s
  length: a report, an R+report, RR73 or 73), at an SNR drawn uniformly
  from ``partner_snr_db``.

Calls are random standard calls (one or two letters, a digit, one to
three letters), distinct within a capture and from the station's two.
Carriers and starts are drawn as ``generator.py`` draws them (sorted
uniforms over the band shortened by the spacings, then spread by them;
starts uniform over ``start_s``), the noise is a ``torch.Generator`` on
the device seeded with the seed (2,500-Hz SNR convention, unit-variance
noise) and the audio comes from the benchmark's transmitter
(``reference/tx.py``).  The per-capture parameters come from
``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import string
from typing import NamedTuple

import numpy as np
import torch

from .reference import constants as C
from .reference.message import pack
from .reference.tx import encode_tones, passband

__all__ = ["Plan", "plan_capture", "make_captures"]


class Plan(NamedTuple):
    """What one capture holds, one entry a transmission."""

    texts: list[str]
    groups: list[str]
    payload: np.ndarray        # (M, 10) uint8
    snr_db: np.ndarray
    freq_hz: np.ndarray
    start_s: np.ndarray


def _call(rng: np.random.Generator, taken: set[str]) -> str:
    letters = string.ascii_uppercase
    while True:
        call = ("".join(rng.choice(list(letters), int(rng.integers(1, 3))))
                + str(int(rng.integers(0, 10)))
                + "".join(rng.choice(list(letters), int(rng.integers(1, 4)))))
        if call not in taken:
            taken.add(call)
            return call


def _grid(rng: np.random.Generator) -> str:
    a, b = rng.integers(0, 18, 2)
    return f"{chr(65 + a)}{chr(65 + b)}{int(rng.integers(0, 100)):02d}"


def _exchange(rng: np.random.Generator, kind: str) -> str:
    report = f"{int(rng.integers(-24, 11)):+03d}"
    return {"grid": lambda: _grid(rng), "report": lambda: report,
            "R+report": lambda: "R" + report, "RR73": lambda: "RR73",
            "73": lambda: "73"}[kind]()


def plan_capture(rng: np.random.Generator, traffic: dict, index: int) -> Plan:
    """The ``index``-th capture of the pool."""
    my, dx = traffic["my_call"], traffic["dx_call"]
    taken = {my, dx}
    kinds = ("grid", "report", "R+report", "RR73", "73")
    texts, snr = [], []
    for _ in range(int(traffic["qsos"])):
        texts.append(f"{_call(rng, taken)} {_call(rng, taken)} "
                     f"{_exchange(rng, kinds[int(rng.integers(0, 5))])}")
    snr += list(np.linspace(*traffic["qso_snr_db"], int(traffic["qsos"])))
    for _ in range(int(traffic["cqs"])):
        texts.append(f"CQ {_call(rng, taken)} {_grid(rng)}")
    snr += list(np.linspace(*traffic["cq_snr_db"], int(traffic["cqs"])))
    for _ in range(int(traffic["callers"])):
        texts.append(f"{my} {_call(rng, taken)} {_grid(rng)}")
    snr += list(np.linspace(*traffic["caller_snr_db"],
                            int(traffic["callers"])))
    place = traffic["partner_exchange"]
    texts.append(f"{my} {dx} {_exchange(rng, place[index % len(place)])}")
    snr.append(float(rng.uniform(*traffic["partner_snr_db"])))
    groups = (["qso"] * int(traffic["qsos"]) + ["cq"] * int(traffic["cqs"])
              + ["caller"] * int(traffic["callers"]) + ["partner"])

    m = len(texts)
    lo, hi = traffic["freq_hz"]
    gap = float(traffic["min_spacing_hz"])
    f0 = np.sort(rng.uniform(lo, hi - (m - 1) * gap, m)) + gap * np.arange(m)
    start = rng.uniform(*traffic["start_s"], m)
    order = rng.permutation(m)          # transmission j on carrier order[j]
    return Plan(texts, groups,
                np.stack([np.frombuffer(pack(t), np.uint8) for t in texts]),
                np.asarray(snr, np.float64), f0[order], start)


def make_captures(traffic: dict, seed: int, device
                  ) -> tuple[torch.Tensor, list[Plan]]:
    """The pool: (P, n) float32 captures on ``device`` and what each
    holds."""
    fs = float(traffic["fs"])
    n = int(round(traffic["slot_s"] * fs))
    sps = int(round(C.SYMBOL_PERIOD_S * fs))
    pool = int(traffic["pool"])
    rng = np.random.default_rng(seed)
    plans = [plan_capture(rng, traffic, i) for i in range(pool)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((pool, n), generator=gen, device=device,
                    dtype=torch.float32)
    stack = lambda key: np.stack([getattr(p, key) for p in plans])
    payload, snr = stack("payload"), stack("snr_db")
    freq, start = stack("freq_hz"), stack("start_s")
    tones = encode_tones(torch.as_tensor(payload, device=device))
    length = C.NUM_SYMBOLS * sps
    for j in range(payload.shape[1]):
        amp = np.sqrt(2.0 * 10.0 ** (snr[:, j] / 10.0) * 2500.0 / (fs / 2.0))
        sig = passband(tones[:, j], torch.as_tensor(freq[:, j], device=device),
                       fs, sps)
        sig = sig * torch.as_tensor(amp, dtype=torch.float32,
                                    device=device)[:, None]
        first = torch.as_tensor((start[:, j] * fs).astype(np.int64),
                                device=device)
        idx = first[:, None] + torch.arange(length, device=device)
        keep = idx < n
        x.scatter_add_(1, idx.clamp(max=n - 1), torch.where(keep, sig, 0.0))
    return x, plans
