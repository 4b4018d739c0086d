"""Known-payload detection and tracking, refined fixes and the beacon
session, PyTorch port (CPU) vs JAX.

* ``known_track_scores``: within 1e-5 relative, identical -inf masks.
* ``detect_known_payload`` at R = 1, R = 8 (equalised) and on complex
  repeats: the same (time, frequency) picks in the same order, z within
  1e-5 relative; the top-K ties go to the lowest index.
* ``track_known_payload``: the df grid equals JAX's jitted ``linspace``
  bit for bit; on real and complex captures, at on- and off-grid hints,
  ``detected`` exactly, ``stat`` within 0.02, time within 1e-4 s and
  frequency within 0.01 Hz (the fields are rounded as JAX rounds them).
* ``refine_fixes`` in ``decode_ft8_message`` and ``decode_ft8_stacked``:
  the rows JAX gives.
* ``BeaconSession`` fed a stream in uneven chunks (R = 3, coherent, OSD,
  refined fixes), then flushed: the rows JAX's session gives; a checkpoint
  written by the JAX package loads in the port and resumes with the rows
  JAX gives, and the reverse.
* The slice's entry points keep the JAX signatures (names, order,
  defaults), add ``device`` (the card by default) and raise without a card
  unless given ``device="cpu"``.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu.beacon import detect as jdetect
from ft8_demodulator_tpu.beacon import drift as jdrift
from ft8_demodulator_tpu.demod import BeaconSession as JaxSession
from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.demod import stack as jstack
from ft8_demodulator_tpu.ops import gfsk as jgfsk
from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.gfsk import ft8_baseband, ft8_passband
from ft8_demodulator_tpu_torch.beacon import detect as tdetect
from ft8_demodulator_tpu_torch.beacon import drift as tdrift
from ft8_demodulator_tpu_torch.demod import BeaconSession
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.demod import stack as tstack
from ft8_demodulator_tpu_torch.ops import gfsk as tgfsk
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops import waterfall as twf
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
from ft8_demodulator_tpu_torch.protocol.encode import encode_tones

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
Z_RTOL = 1e-5
STAT_ATOL = 0.02
TIME_ATOL = 1e-4
FREQ_ATOL = 0.01
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x51], dtype=np.uint8)
OTHER = np.array([0x2B, 0x14, 0x9C, 0x33, 0x71, 0xE0, 0x55, 0xAA, 0x06,
                  0x18], dtype=np.uint8)
WANT = bytes(PAYLOAD[:9].tolist()) + bytes([PAYLOAD[9] & 0xF8])


def _repeats(seed, snr_db, r, f0=400.0, start=500):
    w = np.asarray(ft8_passband(PAYLOAD, FS, f0, 0.0))
    sig = np.zeros((r, N), np.float32)
    sig[:, start: start + len(w)] = w
    rng = np.random.default_rng(seed)
    sig += rng.standard_normal(sig.shape).astype(np.float32) \
        * np.sqrt(float(np.mean(w ** 2)) / 10 ** (snr_db / 10))
    return sig


def _complex_repeats(seed, snr_db, r, f0=350.4, start=530):
    bb = np.asarray(ft8_baseband(PAYLOAD, FS, f0))
    sig = np.zeros((r, N), np.complex64)
    sig[:, start: start + len(bb)] = bb
    rng = np.random.default_rng(seed)
    nz = rng.standard_normal(sig.shape) + 1j * rng.standard_normal(sig.shape)
    sig += (nz * np.sqrt(float(np.mean(np.abs(bb) ** 2))
                         / 10 ** (snr_db / 10) / 2)).astype(np.complex64)
    return sig


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_known_track_scores_match_jax(osr):
    waves = _repeats(1, -22.0, 4)
    jp = jwf.waterfall_params(FS, *osr)
    nf = jp.num_frames(N)
    linpow = np.array(jstack._stacked_power_and_spec(
        jnp.asarray(waves), jp, nf, False, True)[0])
    jg = jsync.search_grid(jp.num_freq_bins, nf, osr[1], osr[0])
    g = tsync.SearchGrid(*jg)
    track = np.array(jdetect.encode_tones(jnp.asarray(PAYLOAD)))
    want = np.asarray(jdetect.known_track_scores(
        jnp.asarray(linpow), jnp.asarray(track, jnp.int32), jg))
    got = tdetect.known_track_scores(torch.as_tensor(linpow),
                                     torch.as_tensor(track), g).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=Z_RTOL,
                               atol=Z_RTOL)


DETECT_CASES = {
    "R1 -20 dB": lambda: _repeats(201, -20.0, 1)[0],
    "R8 -24 dB": lambda: _repeats(201, -24.0, 8),
    "R4 complex -25 dB": lambda: _complex_repeats(7, -25.0, 4),
    "R1 noise": lambda: np.random.default_rng(3).standard_normal(N)
    .astype(np.float32),
}


@pytest.mark.parametrize("name", list(DETECT_CASES))
def test_detect_known_payload_matches_jax(name):
    waves = DETECT_CASES[name]()
    kw = dict(top_k=6, min_z=-100.0)
    want = jdetect.detect_known_payload(waves, FS, PAYLOAD, **kw)
    got = tdetect.detect_known_payload(waves, FS, PAYLOAD, device="cpu",
                                       **kw)
    assert [(d.time_sec, d.freq_hz) for d in got] == \
        [(d.time_sec, d.freq_hz) for d in want]
    np.testing.assert_allclose([d.z for d in got], [d.z for d in want],
                               rtol=Z_RTOL)
    hits = tdetect.detect_known_payload(waves, FS, PAYLOAD, device="cpu")
    assert [d.z for d in hits] == [d.z for d in got if d.z >= 6.0]
    if "noise" not in name:
        assert abs(hits[0].freq_hz - (400.0 if "complex" not in name
                                      else 350.0)) < 7.0
    assert tdetect.detect_known_payload(waves, FS, OTHER,
                                        device="cpu") == \
        jdetect.detect_known_payload(waves, FS, OTHER)


def test_detect_top_k_ties_go_to_the_lowest_index():
    """Silence: every z cell is 0/0 -> the same value; the top 4 are the
    first 4 flat (freq, time) cells, as lax.top_k picks them."""
    silence = np.zeros(N, np.float32)
    silence[::97] = 1.0                       # a flat, non-zero grid
    kw = dict(top_k=4, min_z=-1e9)
    got = tdetect.detect_known_payload(silence, FS, PAYLOAD, device="cpu",
                                       **kw)
    want = jdetect.detect_known_payload(silence, FS, PAYLOAD, **kw)
    assert [(d.time_sec, d.freq_hz) for d in got] == \
        [(d.time_sec, d.freq_hz) for d in want]


def test_track_df_grid_is_jax_jitted_linspace():
    for tol in (0.6, 0.5 * 3.125 + 0.6, 0.5 * 1.5625 + 0.6, 0.3):
        half = tol * 0.16
        n = int(np.ceil(2 * half * 4 * 79)) | 1
        want = np.asarray(jax.jit(lambda: jnp.linspace(-half, half, n))())
        np.testing.assert_array_equal(tdetect._linspace_folded(half, n),
                                      want)


TRACK_CASES = [
    ("real on-grid", False, (0.25, 400.0), {}),
    ("real off-grid hint", False, (0.27, 400.45), {}),
    ("real wide box", False, (0.25, 398.5), dict(freq_tolerance_hz=2.2)),
    ("real wrong spot", False, (1.0, 500.0), {}),
    ("complex", True, (0.265, 350.4), {}),
    ("complex off-grid hint", True, (0.25, 350.0), {}),
]


@pytest.mark.parametrize("name,complex_in,hint,kw", TRACK_CASES)
def test_track_known_payload_matches_jax(name, complex_in, hint, kw):
    if complex_in:
        wave = _complex_repeats(9, -24.0, 1)[0]
    else:
        wave = _repeats(7, -26.0, 1)[0]
    want = jdetect.track_known_payload(wave, FS, PAYLOAD, *hint, **kw)
    got = tdetect.track_known_payload(wave, FS, PAYLOAD, *hint,
                                      device="cpu", **kw)
    assert got.detected == want.detected
    assert abs(got.stat - want.stat) <= STAT_ATOL
    assert abs(got.time_sec - want.time_sec) <= TIME_ATOL
    assert abs(got.freq_hz - want.freq_hz) <= FREQ_ATOL
    if "wrong" not in name:
        assert got.detected
    if complex_in:
        pair = np.stack([wave.real, wave.imag], -1).astype(np.float32)
        assert tdetect.track_known_payload(pair, FS, PAYLOAD, *hint,
                                           device="cpu", **kw) == got


def _rows(rs):
    return [(r.message.payload, r.time_sec, r.freq_hz, r.snr_db) for r in rs]


def _assert_rows_close(got, want):
    """Payloads and SNRs equal; refined times within TIME_ATOL and
    frequencies within FREQ_ATOL."""
    assert [(r.message.payload, r.snr_db) for r in got] == \
        [(r.message.payload, r.snr_db) for r in want]
    for a, b in zip(got, want):
        assert abs(a.time_sec - b.time_sec) <= TIME_ATOL
        assert abs(a.freq_hz - b.freq_hz) <= FREQ_ATOL


def test_refine_fixes_match_jax():
    """decode_ft8_message on an off-grid transmission and a complex
    capture, and decode_ft8_stacked on repeats with a dead first repeat:
    the refined rows JAX gives (the fix moves the grid coordinates)."""
    one = _repeats(11, -6.0, 1, f0=401.7, start=555)[0]
    want = jdec.decode_ft8_message(one, FS, refine_fixes=True)
    got = tdec.decode_ft8_message(one, FS, refine_fixes=True, device="cpu")
    _assert_rows_close(got, want)
    plain = tdec.decode_ft8_message(one, FS, device="cpu")
    assert WANT in {r.message.payload for r in got}
    assert [(r.time_sec, r.freq_hz) for r in got] != \
        [(r.time_sec, r.freq_hz) for r in plain]
    z = _complex_repeats(12, -12.0, 1)[0]
    _assert_rows_close(
        tdec.decode_ft8_message(z, FS, refine_fixes=True, device="cpu"),
        jdec.decode_ft8_message(z, FS, refine_fixes=True))
    waves = _repeats(13, -14.0, 4, f0=401.7, start=555)
    waves[0] = 0.0
    kw = dict(min_score=1.0, use_osd=True, refine_fixes=True)
    got = tstack.decode_ft8_stacked(waves, FS, device="cpu", **kw)
    _assert_rows_close(got, jstack.decode_ft8_stacked(waves, FS, **kw))
    assert WANT in {r.message.payload for r in got}


def _stream(seed, snr_db, cycles, start=500, f0=400.0, payload=PAYLOAD):
    cycle = N
    w = np.asarray(ft8_passband(payload, FS, f0, 0.0))
    sig = np.zeros(cycles * cycle, np.float32)
    for c in range(cycles):
        sig[c * cycle + start: c * cycle + start + len(w)] += w
    rng = np.random.default_rng(seed)
    sig += rng.standard_normal(len(sig)).astype(np.float32) \
        * np.sqrt(float(np.mean(w ** 2)) / 10 ** (snr_db / 10))
    return sig


SESSION = dict(max_repeats=3, refine_fixes=True, min_score=1.0)


def _feed(session, sig, chunk=7001):
    rows = []
    for i in range(0, len(sig), chunk):
        rows.extend(session.feed(sig[i: i + chunk]))
    return rows


def _session_rows(rs):
    return [(r.message.payload, round(r.time_sec, 4), round(r.freq_hz, 2),
             r.snr_db) for r in rs]


def test_beacon_session_matches_jax(tmp_path):
    """3 cycles of the beacon at -19 dB (one cycle cannot decode it), then
    0.9 of a cycle holding another transmission at -3 dB, fed in uneven
    chunks, then flushed; each package's checkpoint, written after 1.5
    cycles, resumes in the other with the rows of the uninterrupted run."""
    sig = _stream(0, -19.0, 3)
    tail = _stream(1, -3.0, 1, payload=OTHER)[: int(0.9 * N)]
    sig = np.concatenate([sig, tail])
    jax_s = JaxSession(FS, **SESSION)
    want = _feed(jax_s, sig) + jax_s.flush()
    port_s = BeaconSession(FS, device="cpu", **SESSION)
    got = _feed(port_s, sig) + port_s.flush()
    assert len(got) == len(want)
    _assert_rows_close(got, want)
    # the beacon once (the session deduplicates), from a stacked cycle;
    # the other transmission from the flushed tail
    hits = [r for r in got if r.message.payload == WANT]
    assert len(hits) == 1 and 15.0 <= hits[0].time_sec < 45.0
    other = bytes(OTHER[:9].tolist()) + bytes([OTHER[9] & 0xF8])
    assert [r.time_sec >= 45.0 for r in got
            if r.message.payload == other] == [True]
    assert port_s.repeats_buffered == jax_s.repeats_buffered == 3

    cut = int(1.5 * N)
    for writer, reader in ((JaxSession, BeaconSession),
                           (BeaconSession, JaxSession)):
        kw = dict(device="cpu") if writer is BeaconSession else {}
        first = writer(FS, **kw, **SESSION)
        rows = _feed(first, sig[:cut])
        path = str(tmp_path / f"{writer.__module__.split('.')[0]}.npz")
        first.save(path)
        resumed = reader.load(path, device="cpu") \
            if reader is BeaconSession else reader.load(path)
        rows += _feed(resumed, sig[cut:]) + resumed.flush()
        _assert_rows_close(rows, want)
        with np.load(path) as z:
            keys = set(z.files)
        assert keys == {f.name for f in dataclasses.fields(_Keys)}


@dataclasses.dataclass
class _Keys:
    """The checkpoint keys of both packages."""
    fs: float
    max_repeats: int
    use_osd: bool
    coherent: bool
    ap: str
    min_z: float
    max_candidates: int
    correction: bool
    cycle_len: int
    t0_seconds: float
    bins_per_tone: int
    steps_per_symbol: int
    min_score: float
    max_iterations: int
    refine_fixes: bool
    buffer: object
    cycles: object
    cycles_done: int
    fed: bool
    finished: bool
    seen: object
    hash_calls: object


def test_detection_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    wave = np.zeros(N, np.float32)
    for call in (lambda: tdetect.detect_known_payload(wave, FS, PAYLOAD),
                 lambda: tdetect.track_known_payload(wave, FS, PAYLOAD, 0.5,
                                                     400.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


ENTRY_POINTS = {
    "decode_ft8_stacked": (jstack.decode_ft8_stacked,
                           tstack.decode_ft8_stacked),
    "decode_slot_stacked": (jstack.decode_slot_stacked,
                            tstack.decode_slot_stacked),
    "BeaconSession": (JaxSession, BeaconSession),
    "BeaconSession.load": (JaxSession.load, BeaconSession.load),
    "detect_known_payload": (jdetect.detect_known_payload,
                             tdetect.detect_known_payload),
    "track_known_payload": (jdetect.track_known_payload,
                            tdetect.track_known_payload),
    "correct_frequency_drift": (jdrift.correct_frequency_drift,
                                tdrift.correct_frequency_drift),
    "apply_polynomial_drift": (jdrift.apply_polynomial_drift,
                               tdrift.apply_polynomial_drift),
    "waterfall_complex": (jwf.waterfall_complex, twf.waterfall_complex),
    "waterfall_real_band": (jwf.waterfall_real_band, twf.waterfall_real_band),
    "calculate_spectrogram": (jwf.calculate_spectrogram,
                              twf.calculate_spectrogram),
    "ft8_baseband": (jgfsk.ft8_baseband, tgfsk.ft8_baseband),
    "tones_to_baseband": (jgfsk.tones_to_baseband, tgfsk.tones_to_baseband),
    "tones_to_passband": (jgfsk.tones_to_passband, tgfsk.tones_to_passband),
    "ft8_passband": (jgfsk.ft8_passband, tgfsk.ft8_passband),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_keep_the_jax_signature(name):
    """The JAX function's parameters, in its order and with its defaults,
    lead the port's (the TPU knob ``precision`` aside); ``device`` follows,
    the card by default."""
    jfn, tfn = ENTRY_POINTS[name]
    want = [(p.name, p.default)
            for p in inspect.signature(jfn).parameters.values()
            if p.name != "precision"]
    got = inspect.signature(tfn).parameters
    assert [(p.name, p.default) for p in got.values()][: len(want)] == want
    assert got["device"].default == "cuda"


def test_beacon_session_unpack_feed_after_flush_and_t0():
    s = BeaconSession(FS, max_repeats=2, t0_seconds=3.0, device="cpu")
    assert len(s._buffer) == int(3.0 * FS)
    from ft8_demodulator_tpu_torch.protocol.message import pack_message
    assert s.unpack(pack_message("CQ K1ABC FN42")) == "CQ K1ABC FN42"
    assert s.flush() == []
    with pytest.raises(RuntimeError, match="after flush"):
        s.feed(np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="max_repeats"):
        BeaconSession(FS, max_repeats=0, device="cpu")
    assert encode_tones(torch.as_tensor(PAYLOAD)).shape == (79,)


def test_beacon_session_keeps_each_ring_cycles_drift_model(monkeypatch,
                                                           tmp_path):
    """With correction, the corrector's model of each cycle in the ring
    stays beside it, oldest first, and leaves with it; a checkpoint does
    not hold them, so a loaded session's are None."""
    from ft8_demodulator_tpu_torch.beacon import drift

    calls = []

    def corrector(z, fs, params=None):
        calls.append(len(calls))
        model = {"segment_s": (0.0, 1.0), "sync_time_s": float(calls[-1])}
        return z, 0.0, model

    monkeypatch.setattr(drift, "correct_drift_tensor", corrector)
    monkeypatch.setattr(
        "ft8_demodulator_tpu_torch.demod.beacon_session.decode_ft8_stacked",
        lambda *a, **kw: [])
    s = BeaconSession(FS, max_repeats=2, correction=True, device="cpu")
    s.feed(np.zeros(3 * N, np.float32))
    assert [m["sync_time_s"] for m in s.drift_models] == [1.0, 2.0]
    s.drift_models[0]["sync_time_s"] = -1.0          # a copy
    assert s.drift_models[0]["sync_time_s"] == 1.0
    s.save(str(tmp_path / "s.npz"))
    assert BeaconSession.load(str(tmp_path / "s.npz"),
                              device="cpu").drift_models == [None, None]
    assert BeaconSession(FS, device="cpu").drift_models == []
