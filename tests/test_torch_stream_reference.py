"""The port's StreamSession held to the benchmark's plain reference of the
stream (``port_bench/reference/stream.py``), on the CPU.

A seeded, unaligned 2-kHz stream goes through ``StreamSession`` with the
``stream`` configuration's settings (osr 4x4, K 40, min_score 1, OSD, the
refined matched-filter retry and the coherent retry), fed in uneven pieces
and flushed, and through the reference block by block.  Its transmissions
cover the stream's rules: one in the first block's pre-roll (it starts
before sample 0), one straddling a block edge (only the lookahead holds
its tail), one starting on a block edge (both blocks find it), one whose
start times round to two slots (only the half-slot rule delivers it once),
and one after the last full block (only the flush decodes it).  No JAX:
the reference stands in for it.  The reference without its lookahead must
fail the same comparison.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import compare  # noqa: E402
from port_bench.entries.stream import dup_rows  # noqa: E402
from port_bench.reference import decode as rdec  # noqa: E402
from port_bench.reference import stream as rstream  # noqa: E402
from port_bench.reference.tx import encode_tones, passband  # noqa: E402

from ft8_demodulator_tpu_torch.config import DecoderConfig  # noqa: E402
from ft8_demodulator_tpu_torch.demod.stream_session import \
    StreamSession  # noqa: E402

torch.set_num_threads(2)

FS = 2000.0
CFG = json.loads((ROOT / "port_bench/configs/stream.json").read_text())
CONFIG = DecoderConfig(
    bins_per_tone=CFG["bins_per_tone"],
    steps_per_symbol=CFG["steps_per_symbol"],
    max_candidates=CFG["max_candidates"], min_score=CFG["min_score"],
    max_iterations=CFG["max_iterations"], use_osd=CFG["use_osd"],
    use_mf=CFG["use_mf"], mf_first=CFG["mf_first"],
    mf_refine=CFG["mf_refine"], coherent=CFG["coherent"])
R = rstream.rules(FS, CFG)
# blocks of 15 s (30,000 samples) and a lookahead of 80 symbols (12.8 s):
# three full blocks, then 17 s that only the flush decodes
TOTAL_S = 62.0
# (start s, carrier Hz, amplitude over unit-variance noise): the pre-roll,
# a block-edge straddle, a start on the 30-s block edge, a start 7.48 s into
# a slot (its start times round to slots 2 and 3), a weak one, and one in
# the flushed block
EVENTS = [(-1.0, 400.0, 0.5), (9.0, 700.0, 0.5), (29.98, 500.0, 0.5),
          (37.48, 850.0, 0.5), (14.0, 300.0, 0.12), (47.0, 600.0, 0.5)]
# rows: payload, time and frequency exactly (the same grid points and the
# same float products); the score within 1e-4 (both sides sum the same
# float32 dB cells in one order after float64 DFT sums rounded once:
# measured 0); the SNR within 0.1 dB after its 0.1-dB rounding
# (compare_rows's rule: both estimate it from the same float32 cells)
SCORE_TOL = 1e-4


def _stream(seed: int):
    rng = np.random.default_rng(seed)
    n = int(TOTAL_S * FS)
    audio = rng.standard_normal(n).astype(np.float32)
    payload = rng.integers(0, 256, (len(EVENTS), 10), dtype=np.uint8)
    payload[:, 9] &= 0xF8
    sps = R.p.nperseg
    sig = passband(encode_tones(torch.as_tensor(payload)),
                   torch.as_tensor([f for _, f, _ in EVENTS]), FS,
                   sps).numpy()
    for (t, _, amp), s in zip(EVENTS, sig):
        i = int(round(t * FS))
        s = s[max(0, -i): n - i] * amp
        audio[max(0, i): max(0, i) + len(s)] += s
    return audio, [bytes(p.tolist()) for p in payload]


def _program(audio, window_s: float = CFG["stream"]["dedup_window_s"]):
    sess = StreamSession(FS, CONFIG, pipeline_depth=0, device="cpu",
                         dedup_window_s=window_s)
    rows = []
    for piece in np.array_split(audio, 11):
        rows.extend(sess.feed(piece))
    flushed = sess.flush()
    return [rdec.Row(r.message.payload, r.time_sec, r.freq_hz, r.score,
                     r.snr_db) for r in rows + flushed], len(flushed)


def _reference(audio, lookahead: bool = True):
    with rdec.exact_float32():
        blocks, delivery = rstream.decode_stream(
            lambda lo, hi: audio[lo:hi], len(audio), FS, CFG, "cpu",
            lookahead=lookahead)
    return [r for b in blocks for r in b], delivery


def _found(d: rstream.BlockDecode, b: int, payload: bytes) -> np.ndarray:
    """The absolute start times (s) at which block ``b``'s candidates
    decoded ``payload``."""
    pl = np.frombuffer(payload, np.uint8)
    hit = d.success & (d.payload == pl).all(1)
    return (d.abs_time[hit] + b * R.block_len // R.p.hop) \
        * (0.16 / R.p.time_osr)


@pytest.fixture(scope="module", params=[3, 11])
def case(request):
    audio, payloads = _stream(request.param)
    prog, flushed = _program(audio)
    ref, delivery = _reference(audio)
    with rdec.exact_float32():
        edge = {b: rstream.decode_block(
            rstream.block_samples(lambda lo, hi: audio[lo:hi], R, b), R,
            CFG, "cpu", first=False) for b in (1, 2)}
    return audio, payloads, prog, flushed, ref, delivery, edge


def test_rows_equal_the_reference(case):
    _, _, prog, _, ref, _, _ = case
    got = compare.compare_rows([prog], [ref])
    assert got["row_diff_pct"] == 0.0
    assert got["score_gap"] <= SCORE_TOL
    assert [r.payload for r in prog] == [r.payload for r in ref]


def test_every_transmission_once(case):
    """Each planted transmission is delivered once, at its start (within a
    symbol), the pre-roll's, the straddle's, the edge's, the two-slot
    one's and the flushed one's included; nothing else is delivered."""
    _, payloads, prog, flushed, _, delivery, _ = case
    strong = [i for i, (_, _, amp) in enumerate(EVENTS) if amp > 0.2]
    got = [r.payload for r in prog]
    assert dup_rows(prog) == 0 and set(got) <= set(payloads)
    for i in strong:
        assert got.count(payloads[i]) == 1, i
        t = next(r.time_s for r in prog if r.payload == payloads[i])
        assert abs(t - EVENTS[i][0]) <= 0.16, (i, t)
    assert flushed >= 1 and payloads[-1] in got[-flushed:]
    # de-duplication dropped rows, across blocks too
    assert delivery.counts["duplicates"] > 0
    assert delivery.counts["blocks"] == 4


def test_both_blocks_find_the_edge_transmission(case):
    """The transmission that starts 20 ms before the 30-s block edge
    decodes in block 1 (its last start frames) and in block 2 (its first):
    the cross-block de-duplication delivers it once."""
    _, payloads, prog, _, _, _, edge = case
    t1, t2 = _found(edge[1], 1, payloads[2]), _found(edge[2], 2, payloads[2])
    assert len(t1) and len(t2) and t1.max() < 30.0 <= t2.min()
    assert [r.payload for r in prog].count(payloads[2]) == 1


def test_the_half_slot_rule_is_needed(case):
    """The start times found for the transmission 7.48 s into a slot round
    to two slots: the slot key alone would deliver it twice."""
    _, payloads, _, _, _, _, edge = case
    found = _found(edge[2], 2, payloads[3])
    assert len({int(round(t / 15.0)) for t in found}) == 2, found


def test_a_zero_window_delivers_it_twice(case):
    """With the dedup window 0 (the slot key alone, the JAX package's rule)
    the session delivers the transmission 7.48 s into a slot twice, which
    the comparison and ``dup_rows`` both see."""
    audio, payloads, _, _, ref, _, _ = case
    prog, _ = _program(audio, 0.0)
    assert [r.payload for r in prog].count(payloads[3]) == 2
    assert dup_rows(prog) >= 1
    assert compare.compare_rows([prog], [ref])["row_diff_pct"] > 0.0


def test_no_lookahead_fails(case):
    """The reference with each block its own 15 s, zero-padded, loses the
    straddling transmissions: the comparison above fails."""
    audio, _, prog, _, _, _, _ = case
    ctrl, _ = _reference(audio, lookahead=False)
    got = compare.compare_rows([prog], [ctrl])
    assert got["row_diff_pct"] > 0.0
