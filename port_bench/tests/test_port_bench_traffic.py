"""The one traffic generator: a seed repeats exactly, seeds differ, every
seed carries the same set of SNRs and the traffic file's constraints, and
the frozen transmitter's signals decode through the plain reference."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import generator
from port_bench.reference import decode as ref_decode


def _traffic(name: str, **over) -> dict:
    t = json.loads((ROOT / "port_bench" / "traffic" / f"{name}.json")
                   .read_text())
    t.update(over)
    return t


@pytest.mark.parametrize("name", ["busy", "weak", "station"])
def test_seed_repeats_and_seeds_differ(name):
    t = _traffic(name, batch=2)
    a, pa = generator.make_slots(t, 2 ** 31 + 5, 1, "cpu")
    b, pb = generator.make_slots(t, 2 ** 31 + 5, 1, "cpu")
    c, pc = generator.make_slots(t, 2 ** 31 + 6, 1, "cpu")
    assert torch.equal(a[0], b[0])
    assert all(np.array_equal(x, y) for x, y in zip(pa[0], pb[0]))
    assert not torch.equal(a[0], c[0])
    assert not np.array_equal(pa[0].payload, pc[0].payload)
    n = int(t["slot_s"] * t["fs"])
    assert a[0].shape == (2, n) and a[0].dtype == torch.float32


@pytest.mark.parametrize("name", ["busy", "weak", "station"])
def test_every_seed_draws_the_same_mix(name):
    t = _traffic(name, batch=3)
    plans = [generator.make_slots(t, s, 1, "cpu")[1][0] for s in (1, 99)]
    m = t["signals"]
    for p in plans:
        assert np.allclose(np.sort(p.snr_db[:, :m], 1),
                           np.linspace(*t["snr_db"], m)[None])
        f = p.freq_hz[:, :m]
        assert (np.diff(f, axis=1) >= t["min_spacing_hz"] - 1e-9).all()
        assert (f >= t["freq_hz"][0]).all() and (f <= t["freq_hz"][1]).all()
        s = p.start_s[:, :m]
        assert (s >= t["start_s"][0]).all() and (s <= t["start_s"][1]).all()
        assert (p.payload[..., 9] & 0x07 == 0).all()
        if t.get("buried_db") is not None:
            strong = np.argmax(p.snr_db[:, :m], 1)
            rows = np.arange(len(strong))
            assert np.allclose(p.snr_db[:, m],
                               p.snr_db[rows, strong] - t["buried_db"])
            assert np.allclose(p.freq_hz[:, m], f[rows, strong]
                               + t["buried_offset_hz"])


def test_the_strong_signals_decode():
    """The frozen TX is FT8: the reference decodes the planted busy-band
    signals of +3.5 dB or more, and nothing it decodes is unplanted.  (Not
    every strong one: STANDARD's 20 candidates, with no suppression of a
    peak's neighbour cells, are mostly spent on the strongest signals.)"""
    t = _traffic("busy", batch=2)
    waves, plans = generator.make_slots(t, 7, 1, "cpu")
    cfg = json.loads((ROOT / "port_bench" / "configs" / "standard.json")
                     .read_text())
    res = ref_decode.decode_slots(waves[0], t["fs"], cfg, False, "bf16")
    for i in range(2):
        got = {bytes(p) for p in res.payload[i][res.success[i]].numpy()}
        planted = {bytes(p): s for p, s in zip(plans[0].payload[i],
                                                plans[0].snr_db[i])}
        assert got <= set(planted)
        assert {p for p, s in planted.items() if s >= 3.5} <= got
