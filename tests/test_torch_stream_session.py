"""The port's StreamSession (CPU) against the JAX package's.

The cases of tests/test_stream_session.py run through both packages on the
same audio and the same feeds: the delivered rows are identical and in
order (payload, time, frequency, LDPC errors; score within 1e-4; the SNR
equal after its 0.1-dB rounding), at STANDARD, mf_first + OSD, and with
the coherent retry, at pipeline_depth 0 and 2.  Checkpoints written by
either package load in the other and resume to the rows the writer's
package gives, including a JAX checkpoint without ``undelivered`` or
``hash_calls`` (an older one).
"""

import numpy as np
import pytest
import torch

from ft8_demodulator_tpu.config import DecoderConfig as JaxConfig
from ft8_demodulator_tpu.demod.stream_session import \
    StreamSession as JaxSession
from ft8_demodulator_tpu.ops.gfsk import ft8_passband
from ft8_demodulator_tpu_torch.config import DecoderConfig
from ft8_demodulator_tpu_torch.demod.stream_session import StreamSession

torch.set_num_threads(2)

PAYLOAD_A = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                      0x50], dtype=np.uint8)
PAYLOAD_B = np.array([0xAA, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09,
                      0xF8], dtype=np.uint8)
FS = 2000.0
SCORE_ATOL = 1e-4
CONFIGS = {
    "standard": dict(min_score=4.0),
    "mf_first_osd": dict(min_score=1.0, use_osd=True, mf_first=True),
    "coherent": dict(min_score=4.0, use_mf=True, coherent=True),
}


def _stream(rng, events, total_s, noise=0.02):
    audio = (rng.standard_normal(int(FS * total_s)) * noise) \
        .astype(np.float32)
    for payload, t, f0 in events:
        w = np.asarray(ft8_passband(payload, FS, f0, 0.0))
        i = int(t * FS)
        if i < 0:
            w, i = w[-i:], 0
        w = w[: len(audio) - i]
        audio[i: i + len(w)] += w
    return audio


def _run(sess, chunks):
    rows = []
    for c in chunks:
        rows.extend(sess.feed(c))
    return rows + sess.flush()


def _key(rows):
    return [(r.message.payload, r.time_sec, r.freq_hz, r.snr_db,
             r.status.ldpc_errors, r.status.crc_extracted,
             r.status.crc_calculated, r.message.hash) for r in rows]


def _assert_same_rows(got, want):
    assert _key(got) == _key(want)
    for a, b in zip(got, want):
        assert abs(a.score - b.score) <= SCORE_ATOL


def _both(name, audio, pieces, depth=0):
    cfg = CONFIGS[name]
    want = _run(JaxSession(FS, JaxConfig(**cfg), pipeline_depth=depth),
                np.array_split(audio, pieces))
    got = _run(StreamSession(FS, DecoderConfig(**cfg), pipeline_depth=depth,
                             device="cpu"), np.array_split(audio, pieces))
    _assert_same_rows(got, want)
    return got


def test_incremental_feed_decodes_everything_as_jax(rng):
    audio = _stream(rng, [
        (PAYLOAD_A, 2.0, 400.0),
        (PAYLOAD_B, 23.0, 700.0),   # straddles the 15 s / 30 s block edge
        (PAYLOAD_A, 47.0, 500.0),
    ], total_s=75.0)
    got = _both("standard", audio, 23)
    rows = {(r.message.payload.hex(), round(r.time_sec), round(r.freq_hz))
            for r in got}
    assert rows == {(PAYLOAD_A.tobytes().hex(), 2, 400),
                    (PAYLOAD_B.tobytes().hex(), 23, 700),
                    (PAYLOAD_A.tobytes().hex(), 47, 500)}
    assert len(got) == 3


@pytest.mark.parametrize("name", ["mf_first_osd", "coherent"])
def test_deep_configs_as_jax(name, rng):
    """mf_first + OSD and the coherent retry on a weak, a clipped-at-start
    and a block-edge transmission."""
    audio = _stream(rng, [
        (PAYLOAD_A, -1.0, 400.0),
        (PAYLOAD_B, 12.5, 650.0),
        (PAYLOAD_A, 31.0, 900.0),
    ], total_s=45.0, noise=0.2)
    got = _both(name, audio, 7)
    assert len(got) >= 2


def test_pipeline_depth_two_as_jax_and_as_depth_zero(rng):
    audio = _stream(rng, [
        (PAYLOAD_A, 2.0, 400.0),
        (PAYLOAD_B, 31.0, 700.0),
    ], total_s=60.0)
    got = _both("standard", audio, 17, depth=2)
    flat = _run(StreamSession(FS, DecoderConfig(**CONFIGS["standard"]),
                              device="cpu"), np.array_split(audio, 17))
    _assert_same_rows(got, flat)
    assert len(got) == 2
    # the rows of a block come back later, not lost: two blocks decoded,
    # nothing delivered yet
    sess = StreamSession(FS, DecoderConfig(**CONFIGS["standard"]),
                         pipeline_depth=2, device="cpu")
    assert sess.feed(audio[: int(46 * FS)]) == []
    assert len(sess._pending) == 2


def test_clipped_at_capture_start_and_past_the_last_block(rng):
    audio = _stream(rng, [(PAYLOAD_A, -1.0, 400.0),
                          (PAYLOAD_B, 30.5, 600.0)], total_s=42.0)
    got = _both("standard", audio, 1)
    rows = [(r.message.payload.hex(), round(r.time_sec)) for r in got]
    assert (PAYLOAD_A.tobytes().hex(), -1) in rows
    assert any(p == PAYLOAD_B.tobytes().hex() and t in (30, 31)
               for p, t in rows)
    assert len(rows) == 2


def test_rows_carry_the_snr_of_jax():
    wave = np.asarray(ft8_passband(PAYLOAD_A, FS, 400.0, 0.0))
    sig = np.zeros(int(FS * 30), np.float32)
    sig[1000: 1000 + len(wave)] = wave
    sp = float(np.mean(wave ** 2))
    rng = np.random.default_rng(7)
    sig += rng.standard_normal(len(sig)).astype(np.float32) \
        * np.sqrt(sp / 10 ** (-5.0 / 10))
    cfg = dict(min_score=1.0)
    want = _run(JaxSession(FS, JaxConfig(**cfg)), [sig])
    got = _run(StreamSession(FS, DecoderConfig(**cfg), device="cpu"), [sig])
    _assert_same_rows(got, want)
    assert got and all(r.snr_db is not None for r in got)


def test_block_function_matches_jax_packed_rows(rng):
    """_decode_block_packed: the success rows of the packed (K, 18) result
    equal JAX's (score within 1e-4, SNR within 1e-3 dB).  The port masks
    the failed rows' SNR to -inf; JAX estimates every row of a block where
    one decodes.  Failed rows are never delivered."""
    from ft8_demodulator_tpu.demod import stream_session as jss
    from ft8_demodulator_tpu_torch.demod import stream_session as tss

    audio = _stream(rng, [(PAYLOAD_A, 3.0, 500.0)], total_s=30.0)
    js = JaxSession(FS, JaxConfig(min_score=4.0), pipeline_depth=1)
    ts = StreamSession(FS, DecoderConfig(min_score=4.0), pipeline_depth=1,
                       device="cpu")
    assert js.feed(audio) == [] and ts.feed(audio) == []
    want = np.asarray(js._pending[0][0])
    got = ts._pending[0][0].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (20, 18)
    ok = want[:, jss._COL_SUCCESS] > 0
    assert ok.sum() >= 1
    assert np.array_equal(got[:, tss._COL_SUCCESS], want[:, jss._COL_SUCCESS])
    assert np.all(got[~ok, tss._COL_SNR] == -np.inf)
    keep = [i for i in range(18) if i not in (tss._COL_SCORE, tss._COL_SNR)]
    assert np.array_equal(got[ok][:, keep], want[ok][:, keep])
    np.testing.assert_allclose(got[:, tss._COL_SCORE],
                               want[:, jss._COL_SCORE], rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got[ok, tss._COL_SNR], want[ok, jss._COL_SNR],
                               rtol=0, atol=1e-3)


def _checkpoint_cases(rng):
    audio = _stream(rng, [(PAYLOAD_A, 2.0, 400.0), (PAYLOAD_B, 40.0, 600.0),
                          (PAYLOAD_A, 52.0, 800.0)], total_s=60.0)
    return audio, int(len(audio) * 0.58)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_both_ways(writer, tmp_path, rng):
    """A session of either package saved with a block in flight
    (pipeline_depth 2) loads in the other and resumes: every row once, the
    rows the writer's package gives from start to end."""
    audio, cut = _checkpoint_cases(rng)
    cfg = CONFIGS["standard"]
    ref = _run(JaxSession(FS, JaxConfig(**cfg)), [audio])
    path = str(tmp_path / "s.npz")
    if writer == "jax":
        first = JaxSession(FS, JaxConfig(**cfg), pipeline_depth=2)
    else:
        first = StreamSession(FS, DecoderConfig(**cfg), pipeline_depth=2,
                              device="cpu")
    early = first.feed(audio[:cut])
    first.save(path)
    if writer == "jax":
        resumed = StreamSession.load(path, device="cpu")
        assert resumed.device == torch.device("cpu")
    else:
        resumed = JaxSession.load(path)
    assert tuple(resumed.config) == tuple(first.config)
    rows = early + _run(resumed, [audio[cut:]])
    _assert_same_rows(rows, ref)
    assert len(rows) == 3


def test_older_jax_checkpoint_without_queue_or_table(tmp_path, rng):
    """A checkpoint without ``undelivered`` and ``hash_calls`` (written
    before they existed) still loads."""
    audio, cut = _checkpoint_cases(rng)
    cfg = CONFIGS["standard"]
    first = JaxSession(FS, JaxConfig(**cfg))
    early = first.feed(audio[:cut])
    full = str(tmp_path / "full.npz")
    first.save(full)
    with np.load(full) as z:
        old = {k: z[k] for k in z.files
               if k not in ("undelivered", "hash_calls")}
    path = str(tmp_path / "old.npz")
    np.savez(path, **old)
    want = early + _run(JaxSession.load(path), [audio[cut:]])
    got = early + _run(StreamSession.load(path, device="cpu"),
                       [audio[cut:]])
    _assert_same_rows(got, want)
    assert len(got) == 3


def test_checkpoint_keys_and_dtypes_are_jaxs(tmp_path, rng):
    audio, cut = _checkpoint_cases(rng)
    cfg = CONFIGS["mf_first_osd"]
    paths = {}
    for name, sess in (("jax", JaxSession(FS, JaxConfig(**cfg),
                                          pipeline_depth=2)),
                       ("torch", StreamSession(FS, DecoderConfig(**cfg),
                                               pipeline_depth=2,
                                               device="cpu"))):
        sess.hash_table.add("PI4THD")
        sess.feed(audio[:cut])
        paths[name] = str(tmp_path / f"{name}.npz")
        sess.save(paths[name])
    with np.load(paths["jax"]) as j, np.load(paths["torch"]) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
        for k in ("config", "seen", "buffer", "offset", "fs",
                  "block_seconds"):
            assert np.array_equal(j[k], t[k]), k
        assert list(t["hash_calls"]) == list(j["hash_calls"]) == ["PI4THD"]
        assert t["config"].dtype == np.float64
        assert t["seen"].dtype == np.int64
        assert t["undelivered"].shape[1] == 19
