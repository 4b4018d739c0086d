"""The SDR stream's traffic (``streams.py``) and its entry
(``entries/stream.py``): a seed repeats exactly and seeds differ, the
stream is the pool's slots in order from the seed's offset, a call is 15 s
of it as the receiver's buffers, the entry's samples are drawn from the
seed, and on a tiny CPU stream the entry's check passes the sound session
and reports three faulty ones as not correct: one without the lookahead,
one that delivers a row twice and one that skips the pre-roll."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import compare, generator, streams
from port_bench.entries import stream as stream_entry
from port_bench.reference import stream as ref_stream

TRAFFIC = json.loads((ROOT / "port_bench" / "traffic" / "feed.json")
                     .read_text())
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "stream.json")
                    .read_text())
LIMITS = json.loads((ROOT / "port_bench" / "limits" / "stream.feed.json")
                    .read_text())
# a tiny stream at 2 kHz: every slot's transmissions start 0.2-0.8 s after
# its boundary and the boundaries lie 14 s after sample 0, so every
# transmission straddles a block edge and the pool's last slot's lie in the
# first block's pre-roll
TINY = {**TRAFFIC, "fs": 2000, "pool": 2, "signals": 4,
        "freq_hz": [200.0, 900.0], "start_s": [0.2, 0.8],
        "offset_s": [14.0, 14.0], "warm_calls": 1, "sample_blocks": 2}
SEED = 2 ** 32 + 3


def _starts(s: streams.Stream, lo_s: float, hi_s: float) -> list[float]:
    """The absolute starts (s) of the stream's transmissions in [lo_s,
    hi_s), those before sample 0 too."""
    pool, slot_s = s.planted.start_s.shape[0], s.slot_len / s.fs
    first = int(np.floor((lo_s - s.offset / s.fs) / slot_s)) - 1
    last = int(np.ceil((hi_s - s.offset / s.fs) / slot_s))
    return [t for k in range(first, last + 1)
            for t in s.offset / s.fs + k * slot_s + s.planted.start_s[k % pool]
            if lo_s <= t < hi_s]


def test_seed_repeats_and_seeds_differ():
    t = {**TRAFFIC, "pool": 3}
    a = streams.make_stream(t, 2 ** 31 + 5, "cpu")
    b = streams.make_stream(t, 2 ** 31 + 5, "cpu")
    c = streams.make_stream(t, 2 ** 31 + 6, "cpu")
    assert np.array_equal(a.audio, b.audio) and a.offset == b.offset
    assert not np.array_equal(a.audio, c.audio)
    assert not np.array_equal(a.planted.payload, c.planted.payload)
    assert a.audio.dtype == np.float32


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 17])
def test_the_stream_is_the_pool_from_the_offset(seed):
    t = {**TRAFFIC, "pool": 3}
    s = streams.make_stream(t, seed, "cpu")
    waves, planted = generator.make_slots({**t, "batch": 3}, seed, 1, "cpu")
    n = int(t["slot_s"] * t["fs"])
    lo, hi = t["offset_s"]
    assert lo * t["fs"] <= s.offset < hi * t["fs"] and s.slot_len == n
    assert s.offset == int(round(np.random.default_rng([seed, 2]).uniform(
        lo, hi) * t["fs"])) % n
    flat = waves[0].reshape(-1).numpy()
    # slot j starts at the offset plus j slots, and the pool repeats
    for j in range(3):
        assert np.array_equal(s.samples(s.offset + j * n,
                                        s.offset + (j + 1) * n),
                              flat[j * n: (j + 1) * n])
    assert np.array_equal(s.samples(s.offset + 3 * n, s.offset + 4 * n),
                          flat[:n])
    assert np.array_equal(s.samples(0, s.offset), flat[len(flat) - s.offset:])
    np.testing.assert_array_equal(s.planted.payload, planted[0].payload)
    assert planted[0].payload.shape == (3, t["signals"], 10)
    # the planted mix: SNRs evenly over the range, carriers and starts
    snr = np.sort(planted[0].snr_db, axis=1)
    assert np.allclose(snr, np.linspace(*t["snr_db"], t["signals"]))
    f = np.sort(planted[0].freq_hz, axis=1)
    assert f.min() >= t["freq_hz"][0] and f.max() <= t["freq_hz"][1]
    assert np.diff(f, axis=1).min() >= t["min_spacing_hz"] - 1e-9
    st = planted[0].start_s
    assert st.min() >= t["start_s"][0] and st.max() <= t["start_s"][1]


def test_a_call_is_fifteen_seconds_of_buffers():
    s = streams.make_stream({**TRAFFIC, "pool": 2}, 7, "cpu")
    bufs = s.call(3)
    assert [len(b) for b in bufs] == [1920] * 93 + [1440]
    assert np.array_equal(np.concatenate(bufs),
                          s.samples(3 * 180000, 4 * 180000))
    got = _starts(s, 0.0, 60.0)
    assert len(got) == 4 * TRAFFIC["signals"]


def test_samples_are_drawn_from_the_seed():
    e = stream_entry.Entry.__new__(stream_entry.Entry)
    e.traffic = TRAFFIC
    m = TRAFFIC["sample_blocks"]
    a, b = e.sample(11, 1000), e.sample(11, 1000)
    runs = {tuple(r[0] for r in e.sample(s, 1000)[1:]) for s in range(12)}
    assert a == b and a[0] == [0, 1] and len(a[1]) == m + 1
    assert a[1] == list(range(a[1][0], a[1][0] + m + 1)) and a[1][0] >= 1
    assert a[1][-1] < 1000 and len(runs) > 6
    assert e.compared(a) == [0, 1] + a[1][1:]
    assert e.sample(5, 1) == [[0]] and e.sample(5, 3) == [[0, 1], [1, 2]]


def test_dup_rows_counts_a_transmission_delivered_twice():
    from port_bench.reference.decode import Row

    r = lambda p, t: Row(p, t, 500.0, 1.0, -10.0)
    assert stream_entry.dup_rows([r(b"a", 1.0), r(b"a", 481.0),
                                  r(b"b", 1.0)]) == 0
    assert stream_entry.dup_rows([r(b"a", 1.0), r(b"a", 1.04),
                                  r(b"a", 481.0)]) == 1


def _no_lookahead(base):
    class NoLookahead(base):
        def _device_chunk(self, take):
            x = super()._device_chunk(take).clone()
            x[self.block_len:] = 0.0
            return x
    return NoLookahead


def _twice(base):
    class Twice(base):
        def _deliver(self):
            rows = super()._deliver()
            return rows + rows[:1]
    return Twice


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's rows of the tiny stream's samples, computed once:
    the same for every session, sound or faulty."""
    return {}


def _check(session, reference_runs, monkeypatch=None, pre_roll=True):
    e = stream_entry.Entry(CONFIG, TINY, SEED, torch.device("cpu"))
    e.session_type = session(e.session_type) if session else e.session_type
    if not pre_roll:
        from ft8_demodulator_tpu_torch.demod import stream_session
        monkeypatch.setattr(stream_session, "PRE_ROLL_SYMBOLS", 0)
    e.warm()
    for i in range(5):
        e.call(i)
    if reference_runs:
        e.reference_runs = lambda runs, precision: reference_runs["runs"]
    else:
        run = e.reference_runs
        e.reference_runs = lambda runs, precision: reference_runs.setdefault(
            "runs", run(runs, precision))
    return e.check(SEED, LIMITS, CONFIG["precision"]["stream"])


def test_the_sound_session_passes(reference_runs):
    got = _check(None, reference_runs)
    assert compare.within(got, LIMITS), got
    assert got["row_diff_pct"] == 0.0 and got["dup_rows"] == 0.0


@pytest.mark.parametrize("fault", ["no_lookahead", "twice", "no_pre_roll"])
def test_a_faulty_session_fails(fault, reference_runs, monkeypatch):
    if "runs" not in reference_runs:
        _check(None, reference_runs)
    got = _check({"no_lookahead": _no_lookahead, "twice": _twice,
                  "no_pre_roll": None}[fault], reference_runs, monkeypatch,
                 pre_roll=fault != "no_pre_roll")
    assert not compare.within(got, LIMITS), got
    if fault == "twice":
        assert got["dup_rows"] >= 1


def test_a_program_without_the_dedup_window_fails_at_once(monkeypatch):
    """A StreamSession that does not take the configuration's dedup window
    (one without the exactly-once rule across slots) is refused when the
    entry is made, before any traffic."""
    from ft8_demodulator_tpu_torch.demod import stream_session

    class Older(stream_session.StreamSession):
        def __init__(self, fs, config, block_seconds=15.0,
                     pipeline_depth=0, device="cuda"):
            super().__init__(fs, config, block_seconds, pipeline_depth,
                             device)

    made = []
    monkeypatch.setattr(stream_session, "StreamSession", Older)
    monkeypatch.setattr(stream_entry.streams, "make_stream",
                        lambda *a: made.append(a))
    with pytest.raises(TypeError, match="dedup_window_s"):
        stream_entry.Entry(CONFIG, TINY, SEED, torch.device("cpu"))
    assert made == []


def test_the_tiny_stream_straddles_and_has_a_pre_roll():
    """What the faults need: transmissions across block edges, and some
    that start before sample 0 and decode in the pre-roll."""
    s = streams.make_stream(TINY, SEED, "cpu")
    r = ref_stream.rules(s.fs, CONFIG)
    starts = _starts(s, -2.0, 60.0)
    edge = r.block_len / s.fs
    assert any(-1.6 < t < 0 for t in starts)
    assert all((t % edge) + 12.64 > edge for t in starts if t >= 0)
