"""The message codec copy and the a-priori (AP) retries, PyTorch port (CPU)
vs JAX.

* ``protocol/message.py``: pack and unpack of every message type the codec
  packs (standard, /R and /P, CQ modifiers, hashed and nonstandard calls,
  DXpedition, RTTY Roundup, Field Day 0.3 / 0.4, EU VHF, telemetry, free
  text) and of random payloads of every i3 / n3: the same bytes, texts
  and errors; the callsign hashes; the hash table is the port's own.
* ``ap_hypotheses`` for (), ("K1ABC",) and ("K1ABC", "W9XYZ"): bit for bit.
* ``ap_retry`` and ``ap_coherent_retry`` on a weak "CQ K1ABC FN42"
  transmission that the first pass misses: every field of the result as
  in JAX; ``decode_ft8_message`` with ``ap`` (alone and with
  ``coherent``): the same rows; a noise-only capture through the whole
  ``coherent`` + ``ap`` stack: the same rows (none with the SNR gate, the
  same CRC-lucky false accept without it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu import protocol as jproto
from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.gfsk import ft8_passband as jax_passband
from ft8_demodulator_tpu.protocol import message as jmsg
from ft8_demodulator_tpu_torch import protocol as tproto
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
from ft8_demodulator_tpu_torch.protocol import message as tmsg

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
SCORE_ATOL = 1e-5
KW = dict(min_score=1.0, use_osd=True, mf_first=True)

MESSAGES = [
    "CQ K1ABC FN42", "K1ABC K9XYZ EN37", "K9XYZ K1ABC R-08",
    "K1ABC K9XYZ RRR", "K9XYZ K1ABC 73", "K1ABC K9XYZ RR73",
    "CQ DX W9XYZ EN37", "CQ TEST KA1ABC JO22", "CQ 001 K1ABC",
    "DE K1ABC FN42", "QRZ K1ABC", "K1ABC/R K9XYZ/R FN42",
    "K1ABC/P K9XYZ JO22", "K1ABC K9XYZ R FN42", "K1ABC K9XYZ +05",
    "K1ABC K9XYZ", "CQ PJ4/K1ABC", "PJ4/K1ABC <W9XYZ> RRR",
    "<W9XYZ> PJ4/K1ABC 73", "TNX BOB 73 GL", "HELLO?",
    "TU; W9XYZ K1ABC R 579 MA", "K1ABC W9XYZ 539 0013",
    "TU; K1ABC W9XYZ 599 DC", "W9XYZ K1ABC R 529 7999", "CQ K1ABC 569 NWT",
    "K1ABC RR73; W9XYZ <KH1/KH7Z> -08", "WA9XYZ KA1ABC R 16A EMA",
    "W9XYZ K1ABC 17B EMA", "<G4ABC> <PA9XYZ> R 570007 JO22DB",
]


@pytest.mark.parametrize("text", MESSAGES)
def test_pack_and_unpack_match_jax(text):
    """Each package with a fresh hash table of its own: the same payload
    and the same text back."""
    jt, tt = jmsg.CallsignHashTable(), tmsg.CallsignHashTable()
    want = jmsg.pack_message(text, hash_table=jt)
    got = tmsg.pack_message(text, hash_table=tt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tmsg.unpack_message(got, hash_table=tt) == \
        jmsg.unpack_message(want, hash_table=jt)
    assert tt.calls() == jt.calls()


def test_free_text_telemetry_and_random_payloads_match_jax():
    for text in ("73 GL", "  TNX 73  "):
        np.testing.assert_array_equal(tmsg.pack_free_text(text),
                                      jmsg.pack_free_text(text))
    for digits in ("123456789ABCDEF01", "0", "7FFFFFFFFFFFFFFFF"):
        np.testing.assert_array_equal(tmsg.pack_telemetry(digits),
                                      jmsg.pack_telemetry(digits))
    for bad in ("F" * 18, "XYZ"):
        for pack in (tmsg.pack_telemetry, jmsg.pack_telemetry):
            with pytest.raises(ValueError):
                pack(bad)
    # random 77-bit payloads of every i3 (and every n3 of i3 = 0): the
    # same text, or the same unsupported type
    rng = np.random.default_rng(9)
    jt, tt = jmsg.CallsignHashTable(["K1ABC", "W9XYZ"]), \
        tmsg.CallsignHashTable(["K1ABC", "W9XYZ"])
    for i3 in range(8):
        for n3 in (range(8) if i3 == 0 else (None,)):
            for _ in range(8):
                v = int.from_bytes(rng.bytes(10), "big") >> 3
                if i3 == 0:
                    v = (v & ~0x3F) | (n3 << 3)
                else:
                    v = (v & ~7) | i3
                payload = np.frombuffer((v << 3).to_bytes(10, "big"),
                                        np.uint8)
                out = []
                for unpack, table in ((tmsg.unpack_message, tt),
                                      (jmsg.unpack_message, jt)):
                    try:
                        out.append(unpack(payload, hash_table=table))
                    except ValueError as err:
                        out.append(type(err).__name__ + str(err))
                assert out[0] == out[1], (i3, n3, v)


def test_callsign_hashes_and_own_hash_table():
    for call in ("K1ABC", "PJ4/K1ABC", "KH1/KH7Z", "W9XYZ", "A"):
        for bits in (10, 12, 22):
            assert tmsg.hash_callsign(call, bits) == \
                jmsg.hash_callsign(call, bits)
        assert tmsg.is_standard_callsign(call) == \
            jmsg.is_standard_callsign(call)
    for bad in ("K1#ABC", "TOOLONGCALLSIGN"):
        for fn in (tmsg.hash_callsign, jmsg.hash_callsign):
            with pytest.raises(ValueError):
                fn(bad)
    # a call remembered by the port resolves in the port only
    call = "ZZ9TORCH"
    h = tmsg.hash_callsign(call, 22)
    payload = tmsg.pack_message(f"<{call}> K1ABC RR73")
    try:
        assert tmsg._hashes().get(h, 22) == call
        assert jmsg._hashes().get(h, 22) is None
        assert tmsg.unpack_message(payload).startswith(f"<{call}>")
        assert jmsg.unpack_message(payload).startswith("<...>")
    finally:
        tmsg.clear_hash_table()
    assert tmsg._ACTIVE_HASHES is not jmsg._ACTIVE_HASHES
    assert set(tproto.__all__) >= {n for n in jproto.__all__
                                   if hasattr(jmsg, n)}


@pytest.mark.parametrize("calls", [(), ("K1ABC",), ("K1ABC", "W9XYZ")])
def test_ap_hypotheses_match_jax(calls):
    got = tmsg.ap_hypotheses(*calls)
    want = jmsg.ap_hypotheses(*calls)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ap = " ".join(calls) if calls else True
    for a, b in zip(tdec.ap_arrays(ap), jdec.ap_arrays(ap)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for bad in ("A B C", "PJ4/K1ABC"):
        with pytest.raises(ValueError):
            tdec.ap_arrays(bad)
    with pytest.raises(ValueError, match="my_call"):
        tmsg.ap_hypotheses(None, "W9XYZ")


@pytest.fixture(scope="module")
def weak_cq():
    """tests/test_ap.py's recipe: "CQ K1ABC FN42" at -16.5 dB (seed 2),
    which the plain decode misses and the CQ hypothesis decodes."""
    payload = tmsg.pack_message("CQ K1ABC FN42")
    w = np.asarray(jax_passband(payload, FS, 400.0, 0.0))
    sig = np.zeros(N, np.float32)
    sig[500: 500 + len(w)] = w
    sp = float(np.mean(w ** 2))
    rng = np.random.default_rng(2)
    sig += rng.standard_normal(N).astype(np.float32) \
        * np.sqrt(sp / 10 ** (-16.5 / 10))
    return sig, bytes(payload.tolist())


def _assert_results_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        if name == "score":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=SCORE_ATOL)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def _decoded(res):
    return {bytes(np.asarray(pl).tolist())
            for pl in np.asarray(res.payload)[np.asarray(res.success)]}


def test_ap_retry_and_ap_coherent_retry_match_jax(weak_cq):
    sig, want_pl = weak_cq
    p = waterfall_params(FS, 2, 2)
    jp = jwf.waterfall_params(FS, 2, 2)
    first = jdec.decode_slot(jnp.asarray(sig), jp, p.num_frames(N), **KW)
    first_t = tdec.SlotDecodeResult(*(torch.as_tensor(np.array(a))
                                      for a in first))
    assert want_pl not in _decoded(first)
    jv, jm = jdec.ap_arrays("K1ABC W9XYZ")
    tv, tm = tdec.ap_arrays("K1ABC W9XYZ")
    want = jdec.ap_retry(jnp.asarray(sig), jp, first, 0, 0, jv, jm, 20, True)
    got = tdec.ap_retry(torch.as_tensor(sig), p, first_t, 0, 0, tv, tm, 20,
                        True)
    _assert_results_equal(got, want)
    assert want_pl in _decoded(got)

    # a null hypothesis, then the six, inside every coherent branch
    jv = jnp.concatenate([jnp.zeros((1, 77), jv.dtype), jv])
    jm = jnp.concatenate([jnp.zeros((1, 77), bool), jm.astype(bool)])
    want = jdec.ap_coherent_retry(jnp.asarray(sig), jp, first, 0, 0, jv, jm,
                                  20, True)
    got = tdec.ap_coherent_retry(torch.as_tensor(sig), p, first_t, 0, 0,
                                 torch.as_tensor(np.array(jv)),
                                 torch.as_tensor(np.array(jm)), 20, True)
    _assert_results_equal(got, want)
    assert want_pl in _decoded(got)


def _rows(rs):
    return [(r.message.payload, r.status.ldpc_errors, r.status.crc_extracted,
             r.status.crc_calculated, r.time_sec, r.freq_hz, r.snr_db)
            for r in rs]


def _assert_rows_equal(got, want):
    assert _rows(got) == _rows(want)
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("kw", [dict(ap=True), dict(ap="K1ABC"),
                                dict(ap="K1ABC W9XYZ", coherent=True)])
def test_decode_ft8_message_ap_matches_jax(weak_cq, kw):
    sig, want_pl = weak_cq
    got = tdec.decode_ft8_message(sig, FS, device="cpu", **KW, **kw)
    _assert_rows_equal(got, jdec.decode_ft8_message(sig, FS, **KW, **kw))
    assert want_pl in {r.message.payload for r in got}


def test_noise_through_the_coherent_ap_stack_matches_jax():
    """tests/test_coherent.py's noise slot 126: no row with the SNR gate;
    without it the same CRC-lucky false accept (at -30 dB) in both."""
    noise = np.random.default_rng(60126).standard_normal(N).astype(
        np.float32)
    kw = dict(KW, coherent=True, ap="K1ABC W9XYZ")
    assert tdec.decode_ft8_message(noise, FS, device="cpu", **kw) == []
    got = tdec.decode_ft8_message(noise, FS, device="cpu",
                                  min_plausible_snr_db=None, **kw)
    want = jdec.decode_ft8_message(noise, FS, min_plausible_snr_db=None,
                                   **kw)
    _assert_rows_equal(got, want)
    assert len(got) == 1 and got[0].snr_db < -26.0
