"""The port's spans and counters (``utils/profiling.py``): the wait spans
nest in their stages, the BP / OSD / candidate counters count what the
decode did, and with no profiler recording nothing is recorded and no
counter touches a card value (CPU)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function

from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import osd as tosd
from ft8_demodulator_tpu_torch.ops.gfsk import ft8_passband
from ft8_demodulator_tpu_torch.ops.ldpc_decode import bp_decode_batch
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
from ft8_demodulator_tpu_torch.protocol.encode import (encode_codeword,
                                                       payload_to_bits)
from ft8_demodulator_tpu_torch.utils import profiling

FS = 2000.0
N = int(FS * 15)
STANDARD = dict(max_candidates=20, min_score=10.0, chunk=2)
# osr 4x4; seed 1 at this amplitude leaves one row to OSD that it accepts
DEEP = dict(max_candidates=40, min_score=1.0, use_osd=True, mf_first=True,
            chunk=2)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _slots(seed: int = 1, amp: float = 0.3) -> torch.Tensor:
    """Two 15-s slots of unit noise at 2 kHz, one planted signal each."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, size=(2, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    waves = rng.standard_normal((2, N)).astype(np.float32)
    for i in range(2):
        sig = ft8_passband(payloads[i], FS, 300.0 + 100.0 * i, 0.0,
                           device="cpu").numpy()
        waves[i, 300: 300 + len(sig)] += amp * sig
    return torch.as_tensor(waves)


def _decode(osr: int, **kw):
    p = waterfall_params(FS, osr, osr)
    return tdec.decode_slots(_slots(), p, p.num_frames(N), **kw)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.mark.parametrize("wait,stage,osr,kw", [
    pytest.param("ft8.decode.wait", "ft8.decode", 2, STANDARD,
                 id="ft8.decode.wait-ft8.decode"),
    pytest.param("ft8.osd.wait", "ft8.osd", 4, DEEP,
                 id="ft8.osd.wait-ft8.osd")])
def test_wait_spans_nest_in_their_stage(wait, stage, osr, kw):
    with _profile() as prof:
        _decode(osr, **kw)
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.name.startswith("ft8.")]
    waits = [(a, b) for a, b, name in spans if name == wait]
    outer = [(a, b) for a, b, name in spans if name == stage]
    assert waits and outer
    assert all(any(c <= a and b <= d for c, d in outer) for a, b in waits)


def test_osd_counts_rows_bp_left_and_rows_accepted(monkeypatch):
    """osd.rows: the valid candidates BP failed (from a second decode of
    the same LLRs without OSD); osd.accepted (on the card, traced): the
    rows whose OSD result the decode took."""
    fronts, taken = [], []
    finish, masked = tdec.finish_decode, tosd.osd_decode_masked

    def keep_front(*args):
        fronts.append(args)
        return finish(*args)

    def keep_ok(*args, **kwargs):
        plain, ok = masked(*args, **kwargs)
        taken.append(ok)
        return plain, ok

    monkeypatch.setattr(tdec, "finish_decode", keep_front)
    monkeypatch.setattr(tosd, "osd_decode_masked", keep_ok)
    with _profile():
        _decode(4, **DEEP)
    (llrs, t, f, score, valid, iters, use_osd), = fronts
    assert use_osd
    bp_only = finish(llrs, t, f, score, valid, iters, False)
    failed = int((valid & ~bp_only.success).sum())
    accepted = int(taken[0].sum())
    assert failed > 0 and accepted > 0
    total, traced = profiling.counters(), profiling.counters(traced=True)
    assert total["osd.rows"] == traced["osd.rows"] == failed
    assert traced["osd.accepted"] == accepted
    assert "osd.accepted" not in total
    assert traced["candidates.rows"] == valid.numel() == 2 * 40
    assert traced["candidates.valid"] == int(valid.sum())
    assert traced["slots"] == 2


def _codeword_llrs(rows: int) -> torch.Tensor:
    rng = np.random.default_rng(7)
    payloads = torch.as_tensor(rng.integers(0, 256, (rows, 10),
                                            dtype=np.uint8))
    bits = encode_codeword(payload_to_bits(payloads))
    return torch.where(bits > 0, 4.0, -4.0)


@pytest.mark.parametrize("llrs,iterations,halted", [
    (_codeword_llrs(5), 1, 1),                         # parity holds at once
    (torch.zeros((5, 174)), 1, 1),                     # zero-codeword guard
    (torch.as_tensor(np.random.default_rng(3).standard_normal(
        (5, 174)).astype(np.float32)), 20, 0),         # never converges
], ids=["codewords", "zeros", "noise"])
def test_bp_iterations_and_early_exit(llrs, iterations, halted):
    """Rows that halt at the first check end the loop after one iteration
    (the zero codeword leaves its min_errors at the 83 checks); noise rows
    run all 20 with failed checks left."""
    _, errors = bp_decode_batch(llrs, 20)
    if halted:
        assert bool((errors == 0).all() or (errors == 83).all())
    else:
        assert bool((errors > 0).all())
    c = profiling.counters()
    assert (c["bp.calls"], c["bp.rows"], c["bp.iterations"],
            c.get("bp.all_halted", 0)) == (1, 5, iterations, halted)
    # a wait for every all-halted check: each iteration's, and the exit's
    assert c["waits"] == iterations + halted


class _Untouchable:
    """A stand-in for a card tensor: any use of it fails."""

    def __getattr__(self, name):
        raise AssertionError(f"touched .{name}")


def test_nothing_recorded_or_read_without_a_profiler(monkeypatch):
    def entered(self):
        raise AssertionError(f"range {self.name} entered with no profiler")

    monkeypatch.setattr(record_function, "__enter__", entered)
    res = _decode(4, **DEEP)
    profiling.count_on_card("candidates.valid", _Untouchable())
    profiling.count("k4.launches")
    assert profiling.counters(traced=True) == {}
    total = profiling.counters()
    assert total["slots"] == 2 and total["k4.launches"] == 1
    assert total["bp.calls"] == 1 and total["waits"] > 0
    # every valid row left undecoded went through OSD
    assert total["osd.rows"] >= int((res.candidate_valid
                                     & ~res.success).sum()) > 0
    assert not profiling._ON_CARD
    # the shared null context of an unrecorded span
    assert profiling.span("ft8.decode") is profiling.span("ft8.decode")


@pytest.mark.parametrize("decorate_traced", [False, True])
def test_span_decorator_picks_at_each_call(decorate_traced):
    """A function decorated by span records a range when called under a
    profiler and none otherwise, whether or not a profiler recorded when
    it was decorated."""
    def body():
        return 1

    if decorate_traced:
        with _profile():
            fn = profiling.span("ft8.test_span")(body)
    else:
        fn = profiling.span("ft8.test_span")(body)
    with _profile() as prof:
        assert fn() == 1
    assert [e.name for e in prof.events()].count("ft8.test_span") == 1
    with _profile() as prof:
        pass
    fn()
    assert "ft8.test_span" not in [e.name for e in prof.events()]


def test_trace_writes_its_counters(tmp_path):
    profiling.count("waits", 5)
    with profiling.trace(str(tmp_path)):
        _decode(2, **STANDARD)
    assert (tmp_path / "trace.json").is_file()
    got = json.loads((tmp_path / "counters.json").read_text())
    assert got == profiling.counters(traced=True)
    assert got["slots"] == 2 and got["candidates.rows"] == 2 * 20
    # reset on entry: the count before the trace is not in it
    assert got["waits"] == profiling.counters()["waits"]
    assert got["bp.calls"] == 1 and 1 <= got["bp.iterations"] <= 20


def _stacked_coherent():
    from ft8_demodulator_tpu_torch.demod import decode_ft8_stacked

    return decode_ft8_stacked(_slots().numpy(), FS, use_osd=True,
                              coherent=True, device="cpu")


def _capture(**kw):
    return lambda: tdec.decode_ft8_message(_slots()[0].numpy(), FS,
                                           device="cpu", **kw)


@pytest.mark.parametrize("call,stages", [
    (_stacked_coherent, {"ft8.llrs", "ft8.coherent", "ft8.snr"}),
    (_capture(), {"ft8.llrs", "ft8.snr"}),
    (_capture(use_osd=True, use_mf=True, coherent=True),
     {"ft8.llrs", "ft8.coherent", "ft8.snr"}),
], ids=["stacked_coherent", "capture", "capture_mf_coherent"])
def test_no_wait_for_a_constant_on_a_second_call(call, stages):
    """A second call of the stacked path with the coherent retry, and of
    the host API, opens its LLR, coherent and SNR stages and no wait span
    inside them: the constants they read reached the device at the first
    call."""
    call()
    with _profile() as prof:
        call()
    names = {e.name for e in prof.events() if e.name.startswith("ft8.")}
    assert stages <= names
    assert not names & {"ft8.llrs.wait", "ft8.snr.wait",
                        "ft8.coherent.wait"}


def test_no_upload_of_the_hypotheses_on_a_second_call(monkeypatch):
    """The a-priori hypotheses reach a device once per (calls, device),
    the coherent retry's with the null hypothesis already first: a second
    decode with the same ``ap`` builds and copies none (a rebuild would
    call ``ap_hypotheses`` again) and opens no wait in its a-priori and
    coherent stages, and ``ap_arrays`` hands out the same tensors."""
    call = _capture(use_osd=True, use_mf=True, coherent=True,
                    ap="K1ABC W9XYZ")
    tdec._ap_tables.cache_clear()
    call()
    values, mask = tdec.ap_arrays("K1ABC W9XYZ", "cpu")

    def rebuilt(*args):
        raise AssertionError("the hypotheses were built again")

    monkeypatch.setattr(tdec, "ap_hypotheses", rebuilt)
    with _profile() as prof:
        call()
    names = {e.name for e in prof.events() if e.name.startswith("ft8.")}
    assert {"ft8.ap", "ft8.coherent"} <= names
    assert not names & {"ft8.ap.wait", "ft8.coherent.wait", "ft8.llrs.wait"}
    again = tdec.ap_arrays("k1abc  w9xyz", torch.device("cpu"))
    assert again[0] is values and again[1] is mask
    (v, m), (nv, nm) = tdec._ap_tables(("K1ABC", "W9XYZ"), torch.device("cpu"))
    assert v is values and torch.equal(nv[1:], v) and not nm[0].any()


def test_a_corrected_cycle_moves_its_bytes_in_four_waits(monkeypatch):
    """One drift-corrected 15-s, 20-kHz cycle of a session: the real cycle
    up, the two argmax tracks and the corrected cycle down, each one
    ``ft8.drift.wait`` inside ``ft8.drift``, and ``drift.copy_bytes``
    their bytes; the rotations copy nothing."""
    from ft8_demodulator_tpu_torch.demod import BeaconSession, beacon_session
    from ft8_demodulator_tpu_torch.ops.gfsk import ft8_baseband

    fs, n = 20000.0, 300000
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, 10, dtype=np.uint8)
    payload[9] &= 0xF8
    bb = ft8_baseband(payload, fs, 550.0, device="cpu").numpy()
    t = (int(0.5 * fs) + np.arange(len(bb))) / fs
    cycle = 0.1 * rng.standard_normal(n)
    cycle[int(0.5 * fs): int(0.5 * fs) + len(bb)] += \
        (bb * np.exp(1j * np.pi * 2.0 * t * t)).real
    monkeypatch.setattr(beacon_session, "decode_ft8_stacked",
                        lambda *a, **kw: [])
    s = BeaconSession(fs, correction=True, device="cpu")
    with _profile() as prof:
        s.feed(cycle.astype(np.float32))
    traced = profiling.counters(traced=True)
    assert traced["drift.locked"] == 1
    assert s.drift_models[0]["acc_hz_per_s2"] is not None
    frames = waterfall_params(fs, 2, 2).num_frames(n)
    assert traced["drift.copy_bytes"] == 4 * n + 2 * 8 * frames + 8 * n
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.name.startswith("ft8.drift")]
    waits = [(a, b) for a, b, name in spans if name == "ft8.drift.wait"]
    outer = [(a, b) for a, b, name in spans if name == "ft8.drift"]
    assert len(waits) == 4 == traced["waits"]
    assert all(any(c <= a and b <= d for c, d in outer) for a, b in waits)
    assert s._cycles[0].dtype == np.complex64


# the stream: StreamSession with the benchmark's ``stream`` configuration
# on 30 s of 2-kHz audio, one full block and the flushed rest
def _stream_config():
    from ft8_demodulator_tpu_torch.config import DecoderConfig

    return DecoderConfig(bins_per_tone=4, steps_per_symbol=4,
                         max_candidates=40, min_score=1.0, use_osd=True,
                         use_mf=True, mf_refine=True, coherent=True)


def _stream_audio() -> np.ndarray:
    rng = np.random.default_rng(5)
    audio = rng.standard_normal(int(FS * 30)).astype(np.float32)
    payloads = rng.integers(0, 256, size=(2, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    for p, t, f in zip(payloads, (9.0, 17.0), (400.0, 700.0)):
        sig = ft8_passband(p, FS, f, 0.0, device="cpu").numpy()
        audio[int(t * FS): int(t * FS) + len(sig)] += 0.5 * sig
    return audio


def _stream_rows(audio):
    from ft8_demodulator_tpu_torch.demod.stream_session import StreamSession

    sess = StreamSession(FS, _stream_config(), device="cpu")
    rows = []
    for piece in np.array_split(audio, 7):
        rows.extend(sess.feed(piece))
    return [(r.message.payload, r.time_sec, r.freq_hz, r.score, r.snr_db)
            for r in rows + sess.flush()]


@pytest.fixture(scope="module")
def stream_traced():
    """The stream's rows, profiler events and traced counters, and the
    reference's rows and counts of the same stream."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from port_bench.reference import decode as rdec
    from port_bench.reference import stream as rstream

    audio = _stream_audio()
    profiling.reset_counters()
    with _profile() as prof:
        rows = _stream_rows(audio)
    traced = profiling.counters(traced=True)
    profiling.reset_counters()
    cfg = dict(bins_per_tone=4, steps_per_symbol=4, max_candidates=40,
               min_score=1.0, max_iterations=20, use_osd=True, use_mf=True,
               mf_refine=True, coherent=True,
               stream={"dedup_window_s": 7.5})
    with rdec.exact_float32():
        blocks, delivery = rstream.decode_stream(
            lambda lo, hi: audio[lo:hi], len(audio), FS, cfg, "cpu",
            block_seconds=15.0)
    ref = [(r.payload, r.time_s, r.freq_hz, r.score, r.snr_db)
           for b in blocks for r in b]
    names = [e.name for e in prof.events() if e.name.startswith("ft8.")]
    return audio, rows, names, traced, ref, delivery.counts


def test_stream_spans_waits_and_counters(stream_traced):
    """Under a profiler the session's buffer, waterfall and delivery spans
    appear, one read-back wait a block, and the stream counters equal the
    reference's block, row, weak and duplicate counts."""
    _, rows, names, traced, ref, counts = stream_traced
    assert {"ft8.buffer", "ft8.waterfall", "ft8.rows",
            "ft8.rows.wait"} <= set(names)
    assert counts["blocks"] == 2 and counts["duplicates"] > 0
    assert names.count("ft8.rows.wait") == counts["blocks"]
    assert names.count("ft8.waterfall") == counts["blocks"]
    assert {k: traced[f"stream.{k}"] for k in counts} == counts
    assert [r[:3] for r in rows] == [r[:3] for r in ref]


def test_stream_read_back_is_one_wait_a_block(stream_traced, monkeypatch):
    """With no profiler recording: no range is entered and nothing is
    counted on the card, the rows are the traced run's, and the read-back
    adds one ``waits`` a block (the count without its wait is less by the
    blocks)."""
    from ft8_demodulator_tpu_torch.demod import stream_session

    audio, rows, _, _, _, counts = stream_traced

    def entered(self):
        raise AssertionError(f"range {self.name} entered with no profiler")

    monkeypatch.setattr(record_function, "__enter__", entered)
    assert _stream_rows(audio) == rows
    assert profiling.counters(traced=True) == {} and not profiling._ON_CARD
    waits = profiling.counters()["waits"]
    assert profiling.counters()["stream.blocks"] == counts["blocks"]
    profiling.reset_counters()
    monkeypatch.setattr(stream_session, "host_wait",
                        lambda name, n=1: profiling.span(name))
    assert _stream_rows(audio) == rows
    assert waits - profiling.counters()["waits"] == counts["blocks"]
