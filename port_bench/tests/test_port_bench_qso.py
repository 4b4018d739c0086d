"""The QSO traffic (``qso.py``), its packer (``reference/message.py``) and
its entry (``entries/qso.py``): a seed repeats exactly and seeds differ,
every capture carries the stated groups, calls and SNRs, the packer
round-trips every message form the traffic makes, the entry's sample is
drawn from the seed, and on a capture that a clamped hypothesis decides
the entry's check reports a program with a faulty hypothesis as not
correct."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import compare, qso
from port_bench.entries import qso as qso_entry
from port_bench.reference import message

TRAFFIC = json.loads((ROOT / "port_bench" / "traffic" / "qso.json")
                     .read_text())
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "deepest.json")
                    .read_text())


def _small(**over) -> dict:
    return {**TRAFFIC, "pool": 4, **over}


def test_seed_repeats_and_seeds_differ():
    a, pa = qso.make_captures(_small(), 2 ** 31 + 5, "cpu")
    b, pb = qso.make_captures(_small(), 2 ** 31 + 5, "cpu")
    c, pc = qso.make_captures(_small(), 2 ** 31 + 6, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert all(x.texts == y.texts and np.array_equal(x.freq_hz, y.freq_hz)
               for x, y in zip(pa, pb))
    assert [x.texts for x in pa] != [x.texts for x in pc]
    n = int(TRAFFIC["slot_s"] * TRAFFIC["fs"])
    assert a.shape == (4, n) and a.dtype == torch.float32


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 17])
def test_every_capture_plants_the_stated_groups(seed):
    my, dx = CONFIG["decode_ft8_message"]["ap"].split()
    assert (TRAFFIC["my_call"], TRAFFIC["dx_call"]) == (my, dx)
    _, plans = qso.make_captures(_small(), seed, "cpu")
    place = TRAFFIC["partner_exchange"]
    for i, p in enumerate(plans):
        groups = np.array(p.groups)
        for g, key, count in (("qso", "qso_snr_db", TRAFFIC["qsos"]),
                              ("cq", "cq_snr_db", TRAFFIC["cqs"]),
                              ("caller", "caller_snr_db",
                               TRAFFIC["callers"])):
            assert np.allclose(np.sort(p.snr_db[groups == g]),
                               np.linspace(*TRAFFIC[key], count))
        lo, hi = TRAFFIC["partner_snr_db"]
        assert lo <= p.snr_db[groups == "partner"][0] <= hi
        assert (groups == "partner").sum() == 1
        words = [t.split() for t in p.texts]
        calls = set()
        for w, g in zip(words, p.groups):
            assert len(w) == 3
            if g == "qso":
                assert {w[0], w[1]}.isdisjoint({my, dx})
                calls |= {w[0], w[1]}
            elif g == "cq":
                assert w[0] == "CQ" and w[1] not in (my, dx)
                calls.add(w[1])
            elif g == "caller":
                assert w[0] == my and w[1] not in (my, dx)
                calls.add(w[1])
            else:
                assert w[:2] == [my, dx]
                kind = place[i % len(place)]
                if kind in ("RR73", "73"):
                    assert w[2] == kind
                else:
                    assert (w[2][0] == "R") == (kind == "R+report")
                    assert -24 <= int(w[2].lstrip("R")) <= 10
        # every other station's call once, and all of them standard
        assert len(calls) == 2 * TRAFFIC["qsos"] + TRAFFIC["cqs"] \
            + TRAFFIC["callers"]
        assert all(message.is_standard_call(c) for c in calls)
        f = np.sort(p.freq_hz)
        assert (np.diff(f) >= TRAFFIC["min_spacing_hz"] - 1e-9).all()
        assert TRAFFIC["freq_hz"][0] <= f[0] and f[-1] <= TRAFFIC["freq_hz"][1]
        assert ((p.start_s >= TRAFFIC["start_s"][0])
                & (p.start_s <= TRAFFIC["start_s"][1])).all()


def test_the_packer_round_trips():
    _, plans = qso.make_captures(_small(pool=8), 3, "cpu")
    texts = [t for p in plans for t in p.texts]
    for p in plans:
        for t, pl in zip(p.texts, p.payload):
            assert message.pack(t) == bytes(pl)
            assert message.unpack(bytes(pl)) == t
            assert pl[9] & 0x07 == 0
    # each form the traffic makes appears
    ends = {t.split()[2] for t in texts}
    assert {"RR73", "73"} <= ends
    assert any(e[0] in "+-" for e in ends) and any(e[:2] in ("R+", "R-")
                                                   for e in ends)
    with pytest.raises(ValueError):
        message.pack("K1ABC W9XYZ FN42 73")


def test_the_hypotheses_fix_the_planted_bits():
    """Every a-priori type agrees on its fixed bits with the messages it
    stands for, and with no message of another group's form."""
    values, mask = message.ap_hypotheses("K1ABC", "W9XYZ")
    bits = lambda t: np.unpackbits(np.frombuffer(message.pack(t), np.uint8)
                                   )[:77]
    fits = lambda h, t: bool((bits(t)[mask[h]] == values[h][mask[h]]).all())
    assert fits(0, "CQ G4ABC IO91") and not fits(0, "K1ABC G4ABC IO91")
    assert fits(1, "K1ABC G4ABC IO91") and not fits(1, "CQ G4ABC IO91")
    assert fits(2, "K1ABC W9XYZ -07") and not fits(2, "K1ABC G4ABC -07")
    for h, end in ((3, "RRR"), (4, "RR73"), (5, "73")):
        assert fits(h, f"K1ABC W9XYZ {end}")
        assert not fits(h, "K1ABC W9XYZ R-07")
    assert mask.sum(1).tolist() == [32, 32, 61, 77, 77, 77]


class _Row:
    def __init__(self, payload: bytes):
        self.message = type("M", (), {"payload": payload})()


def test_the_sample_is_drawn_from_the_seed_and_unplanted_counts():
    entry = qso_entry.Entry.__new__(qso_entry.Entry)
    entry.traffic, entry.pool = TRAFFIC, [None] * 16
    entry.rows = [[]] * 40
    a, b, c = entry.sample(7), entry.sample(7), entry.sample(8)
    assert a == b and a != c
    assert len(a) == TRAFFIC["sample"]
    assert len({x % 16 for x in a}) == len(a)
    _, plans = qso.make_captures(_small(pool=2), 9, "cpu")
    rows = [[_Row(bytes(plans[0].payload[0])), _Row(bytes(10))],
            [_Row(bytes(plans[1].payload[3]))],
            [_Row(bytes(plans[1].payload[3]))]]
    assert qso_entry.unplanted(rows, plans) == [1, 0, 1]


# one capture with the QSO partner alone, sending 73 at -21.5 dB: the
# sync finds it, and neither the first pass, nor the refined search, nor a
# coherent branch without a hypothesis decodes it; a clamped hypothesis
# inside a coherent branch does (found by a probe of seeds on the CPU)
AP_TRAFFIC = {**TRAFFIC, "pool": 1, "sample": 1, "qsos": 0, "cqs": 0,
              "callers": 0, "partner_snr_db": [-21.5, -21.5],
              "partner_exchange": ["73"]}
AP_SEED = 3
LIMITS = json.loads((ROOT / "port_bench" / "limits" / "deepest.qso.json")
                    .read_text())
STATED = CONFIG["precision"][qso_entry.Entry.reference_precision_key]


@pytest.fixture(scope="module")
def ap_entry():
    torch.set_num_threads(2)
    return qso_entry.Entry(CONFIG, AP_TRAFFIC, AP_SEED, "cpu")


def test_a_clamped_hypothesis_decides_the_fault_capture(ap_entry):
    """On the fault tests' capture the reference's one row comes from a
    clamped hypothesis, and the reference without the clamps (``no_ap``,
    ``control_qso.py``'s control) fails the cell's limits."""
    (ref,) = ap_entry.reference_decodes([0], STATED)
    acc = ref.accepted
    assert [r.payload for r in ref.rows] \
        == [bytes(ap_entry.plans[0].payload[0])]
    assert acc["ap"] + acc["ap_coherent"] - acc["ap_coherent_null"] >= 1
    no_ap = ap_entry.reference_rows([0], STATED, ap=False)
    assert not compare.within(compare.compare_rows(no_ap, [ref.rows]),
                              LIMITS)


def _inverted(clamp):
    return lambda llrs, values, mask: clamp(llrs, 1 - values, mask)


def _unclamped(clamp):
    return lambda llrs, values, mask: clamp(llrs, values,
                                            torch.zeros_like(mask))


@pytest.mark.parametrize("fault", [None, "wrong DxCall", "inverted clamp",
                                   "no clamp"])
def test_the_check_sees_a_faulty_hypothesis(ap_entry, fault, monkeypatch):
    """The cell's check (``Entry.check`` against the cell's limits) passes
    the sound program and reports as not correct a program that clamps a
    wrong DxCall, clamps each fixed bit to the wrong sign, or clamps no
    bit."""
    from ft8_demodulator_tpu_torch.demod import decode as prog

    if fault == "wrong DxCall":
        monkeypatch.setitem(ap_entry.kwargs, "ap", "K1ABC W9XYY")
    elif fault == "inverted clamp":
        monkeypatch.setattr(prog, "_ap_clamped", _inverted(prog._ap_clamped))
    elif fault == "no clamp":
        monkeypatch.setattr(prog, "_ap_clamped",
                            _unclamped(prog._ap_clamped))
    ap_entry.call(0)
    numbers = ap_entry.check(AP_SEED, LIMITS, STATED)
    assert compare.within(numbers, LIMITS) == (fault is None), numbers
