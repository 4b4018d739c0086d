"""The waterfall backends, complex input and the rest of the TX, PyTorch port
(CPU) vs JAX.

* ``waterfall_real`` / ``waterfall_complex`` on every backend: block (2 kHz
  osr 2x2 and 4x4), matmul (1,999 Hz, an odd rate; 2 kHz osr 2x3; forced on
  the block geometry), fft (32,768 Hz, where nfft = 10,485 is odd and
  ``num_freq_bins = nfft // 2``; 48 kHz; forced): dB grids within
  ``DB_ATOL`` = 1e-3 dB where the cell lies less than ``NULL_DEPTH_DB`` = 40
  dB under the grid's median, and every cell's linear power within 1e-3
  dB of itself plus 1e-6 of the grid's mean power.  (JAX rounds the
  complex product's four real parts separately and sums float32 in its
  own order; 50-60 dB under the median the two grids differ by up to
  2.4e-3 dB, measured.)
* ``waterfall_real_band`` (block, matmul, fft; a start past the top and
  negative ones, taken as ``lax.dynamic_slice`` takes them) and
  ``calculate_spectrogram`` (real and complex), at the same tolerance.
* The rest of the TX: ``reference_quirk``, ``tones_to_baseband``,
  ``ft8_baseband``, ``tones_to_passband`` against JAX at 2 kHz within 1e-4
  and against the goldens at the JAX tests' tolerances; ``bits_to_payload``,
  ``crc_generator`` and ``check_crc`` exactly.
* Complex and non-block decodes: ``decode_slot(is_complex)`` (Hann, MF
  retry, mf_first, coherent), ``decode_slot`` / ``decode_slots`` at 1,999 Hz
  (matmul backend, the direct matched filter) and ``decode_ft8_message`` on
  a complex capture: the fields / rows JAX gives (scores within 1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import gfsk as jgfsk
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.protocol import encode as jenc
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import gfsk as tgfsk
from ft8_demodulator_tpu_torch.ops import waterfall as twf
from ft8_demodulator_tpu_torch.protocol import constants as TC
from ft8_demodulator_tpu_torch.protocol import encode as tenc

torch.set_num_threads(2)

DB_ATOL = 1e-3
NULL_DEPTH_DB = 40.0
POWER_RTOL = 1e-6
TX_ATOL = 1e-4
SCORE_ATOL = 1e-4
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x51], dtype=np.uint8)
WANT = bytes(PAYLOAD[:9].tolist()) + bytes([PAYLOAD[9] & 0xF8])


def assert_db_close(got, want):
    """dB grids: DB_ATOL above the median - NULL_DEPTH_DB, and every
    cell's linear power within DB_ATOL of itself plus POWER_RTOL of the
    grid's mean power."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    keep = want > np.median(want) - NULL_DEPTH_DB
    assert np.abs(got - want)[keep].max() <= DB_ATOL
    lin_g, lin_w = 10.0 ** (got / 10.0), 10.0 ** (want / 10.0)
    rel = 10.0 ** (DB_ATOL / 10.0) - 1.0
    assert (np.abs(lin_g - lin_w)
            <= rel * lin_w + POWER_RTOL * lin_w.mean()).all()


def _noise(rng, n, complex_in):
    if complex_in:
        return rng.standard_normal((n, 2)).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


# (fs, (bins_per_tone, steps_per_symbol), backend, seconds, picked backend)
CASES = [
    (2000.0, (2, 2), None, 15, "block"),
    (2000.0, (4, 4), None, 15, "block"),
    (1999.0, (2, 2), None, 15, "matmul"),
    (2000.0, (2, 3), None, 15, "matmul"),
    (2000.0, (2, 2), "matmul", 15, "matmul"),
    (2000.0, (2, 2), "fft", 15, "fft"),
    (32768.0, (2, 2), None, 2, "fft"),
    (48000.0, (2, 2), None, 1, "fft"),
]


@pytest.mark.parametrize("complex_in", [False, True])
@pytest.mark.parametrize("fs,osr,backend,seconds,picked", CASES)
def test_waterfall_backends_match_jax(rng, fs, osr, backend, seconds,
                                      picked, complex_in):
    jp, tp = jwf.waterfall_params(fs, *osr), twf.waterfall_params(fs, *osr)
    assert tuple(tp) == tuple(jp)
    assert twf._pick_backend(tp, backend) == picked \
        == jwf._pick_backend(jp, backend)
    n = int(fs * seconds)
    nf = tp.num_frames(n)
    w = _noise(rng, n, complex_in)
    if complex_in:
        want = jwf.waterfall_complex(jnp.asarray(w), jp, nf, backend,
                                     precision="highest")
        got = twf.waterfall_complex(torch.as_tensor(w), tp, nf, backend)
        # a complex tensor is the same input as its [re, im] pair
        z = torch.view_as_complex(torch.as_tensor(w))
        assert torch.equal(twf.waterfall_complex(z, tp, nf, backend), got)
        # a host array goes to the device asked for
        assert torch.equal(twf.waterfall_complex(
            w[:, 0] + 1j * w[:, 1], tp, nf, backend, device="cpu"), got)
    else:
        want = jwf.waterfall_real(jnp.asarray(w), jp, nf, backend,
                                  precision="highest")
        got = twf.waterfall_real(torch.as_tensor(w), tp, nf, backend)
    assert got.shape == (tp.num_freq_bins, nf) and got.is_contiguous()
    assert_db_close(got.numpy(), want)


def test_block_backend_refuses_other_geometries():
    tp = twf.waterfall_params(1999.0, 2, 2)
    with pytest.raises(ValueError, match="backend='block'"):
        twf.waterfall_real(torch.zeros(30000), tp, 10, backend="block")


@pytest.mark.parametrize("fs,osr,seconds,picked", [
    (2000.0, (2, 2), 15, "block"), (1999.0, (2, 2), 15, "matmul"),
    (32768.0, (2, 2), 2, "fft")])
def test_waterfall_real_band_matches_jax(rng, fs, osr, seconds, picked):
    jp, tp = jwf.waterfall_params(fs, *osr), twf.waterfall_params(fs, *osr)
    assert twf._pick_backend(tp, None) == picked
    n = int(fs * seconds)
    nf = tp.num_frames(n)
    w = _noise(rng, n, False)
    full = twf.waterfall_real(torch.as_tensor(w), tp, nf)
    band = 48
    # a start past the top and a negative one (counted from the end of the
    # padded axis) are clamped, as lax.dynamic_slice takes them
    for start in (100, tp.num_freq_bins - 20, tp.num_freq_bins + 30, -7,
                  -150):
        want = jwf.waterfall_real_band(jnp.asarray(w), jp, nf,
                                       jnp.int32(start), band)
        got = twf.waterfall_real_band(torch.as_tensor(w), tp, nf,
                                      torch.tensor(start), band)
        assert got.shape == (band, nf)
        assert_db_close(got.numpy(), want)
        # rows inside the grid are the same rows of the full waterfall
        lo = start + tp.num_freq_bins + band + (
            2 * tp.freq_osr if picked == "block" else 0) if start < 0 \
            else start
        lo = min(max(lo, 0), tp.num_freq_bins)
        rows = min(band, tp.num_freq_bins - lo)
        if rows > 0:
            assert_db_close(got[:rows].numpy(), full[lo: lo + rows].numpy())


@pytest.mark.parametrize("complex_in", [False, True])
def test_calculate_spectrogram_matches_jax(rng, complex_in):
    fs = 2000.0
    n = int(fs * 6)
    w = rng.standard_normal(n)
    if complex_in:
        w = w + 1j * rng.standard_normal(n)
    want = jwf.calculate_spectrogram(w, fs, 2, 2)
    got = twf.calculate_spectrogram(w, fs, 2, 2, device="cpu")
    assert_db_close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    short = twf.calculate_spectrogram(w[:100], fs, device="cpu")
    assert [a.shape for a in short] == [(1, 0), (0,), (0,)]


# ---------------------------------------------------------------------------
# the rest of the TX

@pytest.mark.parametrize("fs", [2000.0, 4000.0])
def test_reference_quirk_track_matches_golden_and_jax(goldens, fs):
    sps = int(TC.SYMBOL_PERIOD_S * fs)
    payload = goldens["p1_payload"]
    tones = tenc.encode_tones(torch.as_tensor(payload))
    quirk = tgfsk.gfsk_frequency_track(tones, sps, reference_quirk=True)
    np.testing.assert_allclose(
        quirk.numpy().reshape(-1) * TC.TONE_SPACING_HZ,
        goldens[f"gfsk_fs{int(fs)}"][: TC.NUM_SYMBOLS * sps], atol=2e-4)
    want = jgfsk.gfsk_frequency_track(
        jenc.encode_tones(jnp.asarray(payload)), sps, reference_quirk=True)
    np.testing.assert_allclose(quirk.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("quirk", [False, True])
def test_baseband_and_passband_match_jax(goldens, quirk):
    """At 2 kHz within TX_ATOL of JAX (at 12 kHz the JAX TX's own float32
    phase is ~3e-4 off a float64 sum); tones_to_baseband as (n, 2)
    [re, im], ft8_baseband as complex64."""
    fs, f0, fc = 2000.0, 300.0, 250.0
    sps = int(TC.SYMBOL_PERIOD_S * fs)
    payloads = np.stack([goldens["p1_payload"], PAYLOAD])
    tones = np.array(jenc.encode_tones(jnp.asarray(payloads)))
    want = np.asarray(jgfsk.tones_to_baseband(jnp.asarray(tones), sps, fs,
                                              f0, quirk))
    got = tgfsk.tones_to_baseband(tones, sps, fs, f0, quirk, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TX_ATOL)
    bb = tgfsk.ft8_baseband(payloads, fs, f0, quirk, device="cpu")
    assert bb.dtype == torch.complex64
    np.testing.assert_allclose(bb.numpy(), np.asarray(jgfsk.ft8_baseband(
        jnp.asarray(payloads), fs, f0, quirk)), rtol=0, atol=TX_ATOL)
    pb = tgfsk.tones_to_passband(torch.as_tensor(tones), sps, fs, f0, fc,
                                 quirk, device="cpu")
    np.testing.assert_allclose(pb.numpy(), np.asarray(jgfsk.tones_to_passband(
        jnp.asarray(tones), sps, fs, f0, fc, quirk)), rtol=0, atol=TX_ATOL)
    np.testing.assert_array_equal(
        tgfsk.ft8_passband(payloads, fs, f0, fc, quirk, device="cpu").numpy(),
        pb.numpy())


def test_quirk_waveforms_match_goldens(goldens):
    """The JAX tests' golden tolerances: the reference's own waveform."""
    for fs, f0 in [(2000.0, 300.0), (4000.0, 550.0)]:
        golden = goldens[f"bb_fs{int(fs)}_f0{int(f0)}"]
        bb = tgfsk.ft8_baseband(goldens["p1_payload"], fs, f0,
                                reference_quirk=True, device="cpu").numpy()
        assert bb.shape == golden.shape
        assert np.abs(bb - golden).max() < 2e-3
    sps = int(TC.SYMBOL_PERIOD_S * 4000.0)
    tones = tenc.encode_tones(torch.as_tensor(goldens["p1_payload"]))
    pb = tgfsk.tones_to_passband(tones, sps, 4000.0, 550.0, 600.0, True,
                                 device="cpu").numpy()
    assert np.abs(pb - goldens["pb_fs4000_f0550_fc600"]).max() < 2e-3


def test_bits_to_payload_and_crc_helpers_match_jax(rng, goldens):
    bits = rng.integers(0, 2, (6, 77))
    got = tenc.bits_to_payload(torch.as_tensor(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jenc.bits_to_payload(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        tenc.payload_to_bits(got).numpy(), bits)
    for i in range(1, 5):
        payload = goldens[f"p{i}_payload"]
        a91 = tenc.crc_generator(payload)
        np.testing.assert_array_equal(a91, goldens[f"p{i}_a91"])
        np.testing.assert_array_equal(a91, jenc.crc_generator(payload))
        assert tenc.check_crc(a91) and jenc.check_crc(a91)
        bad = a91.copy()
        bad[3] ^= 0x10
        assert tenc.check_crc(bad) == jenc.check_crc(bad) is False


def test_tx_and_spectrogram_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = twf.waterfall_params(2000.0, 2, 2)
    for call in (lambda: tgfsk.ft8_baseband(PAYLOAD, 2000.0, 300.0),
                 lambda: tgfsk.tones_to_baseband(np.zeros(79, int), 320,
                                                 2000.0, 300.0),
                 lambda: tgfsk.tones_to_passband(np.zeros(79, int), 320,
                                                 2000.0, 300.0, 0.0),
                 lambda: twf.calculate_spectrogram(np.zeros(4000), 2000.0),
                 lambda: twf.waterfall_complex(np.zeros((4000, 2)), p, 10),
                 lambda: twf.waterfall_real_band(np.zeros(4000), p, 10, 0, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# complex and non-block decodes

def _complex_capture(seed, snr_db, fs=2000.0, f0=350.0, start=500):
    """One transmission's complex baseband in complex white noise, SNR in
    the 2500-Hz convention, as (n, 2) [re, im] float32."""
    bb = np.asarray(jgfsk.ft8_baseband(PAYLOAD, fs, f0))
    sig = np.zeros(int(fs * 15), np.complex64)
    sig[start: start + len(bb)] = bb
    rng = np.random.default_rng(seed)
    nz = rng.standard_normal(sig.shape) + 1j * rng.standard_normal(sig.shape)
    sig += (nz * np.sqrt(fs / 2500.0 / 10 ** (snr_db / 10) / 2)
            ).astype(np.complex64)
    return np.stack([sig.real, sig.imag], -1).astype(np.float32)


def _real_capture(seed, snr_db, fs, f0=400.0, start=500):
    w = np.asarray(jgfsk.ft8_passband(PAYLOAD, fs, f0, 0.0))
    sig = np.zeros(int(fs * 15), np.float32)
    sig[start: start + len(w)] = w
    rng = np.random.default_rng(seed)
    sig += rng.standard_normal(len(sig)).astype(np.float32) \
        * np.sqrt(np.mean(w ** 2) / 10 ** (snr_db / 10))
    return sig


def _assert_results_equal(got, want):
    ok = np.asarray(want.success)
    np.testing.assert_array_equal(got.success.numpy(), ok)
    np.testing.assert_array_equal(got.abs_time.numpy(),
                                  np.asarray(want.abs_time))
    np.testing.assert_array_equal(got.abs_freq.numpy(),
                                  np.asarray(want.abs_freq))
    np.testing.assert_array_equal(got.candidate_valid.numpy(),
                                  np.asarray(want.candidate_valid))
    np.testing.assert_array_equal(got.payload.numpy()[ok],
                                  np.asarray(want.payload)[ok])
    valid = np.asarray(want.candidate_valid)
    np.testing.assert_allclose(got.score.numpy()[valid],
                               np.asarray(want.score)[valid], rtol=0,
                               atol=SCORE_ATOL)


SLOT_OPTIONS = {
    "hann": {}, "use_mf": dict(use_mf=True), "mf_first": dict(mf_first=True),
    "mf_first+mf_refine": dict(mf_first=True, mf_refine=True),
    "coherent": dict(mf_first=True, coherent=True),
}


@pytest.mark.parametrize("name", list(SLOT_OPTIONS))
def test_decode_slot_complex_matches_jax(name):
    """A -16 dB complex capture at 2 kHz (block geometry, complex input:
    the frequency-major route)."""
    fs = 2000.0
    wave = _complex_capture(4, -16.0, fs)
    p = twf.waterfall_params(fs, 2, 2)
    nf = p.num_frames(wave.shape[0])
    kw = dict(max_candidates=20, min_score=1.0, use_osd=True,
              is_complex=True, **SLOT_OPTIONS[name])
    want = jdec.decode_slot(jnp.asarray(wave), jwf.waterfall_params(fs, 2, 2),
                            nf, **kw)
    got = tdec.decode_slot(torch.as_tensor(wave), p, nf, **kw)
    _assert_results_equal(got, want)
    assert np.asarray(want.success).any()


def test_decode_slot_and_slots_at_an_odd_rate_match_jax():
    """1,999 Hz: the matmul waterfall and the direct matched filter, for
    decode_slot (Hann + MF retry, mf_first) and decode_slots (one slot at a
    time, as JAX's chunked vmap)."""
    fs = 1999.0
    waves = np.stack([_real_capture(seed, -10.0, fs) for seed in (1, 2)])
    jp, p = jwf.waterfall_params(fs, 2, 2), twf.waterfall_params(fs, 2, 2)
    nf = p.num_frames(waves.shape[1])
    for kw in (dict(use_mf=True), dict(mf_first=True)):
        kw.update(max_candidates=12, min_score=1.0, use_osd=True)
        _assert_results_equal(
            tdec.decode_slot(torch.as_tensor(waves[0]), p, nf, **kw),
            jdec.decode_slot(jnp.asarray(waves[0]), jp, nf, **kw))
    kw = dict(max_candidates=12, min_score=1.0, use_osd=True)
    got = tdec.decode_slots(torch.as_tensor(waves), p, nf, chunk=1, **kw)
    want = jdec.decode_slots(jnp.asarray(waves), jp, nf, chunk=1, **kw)
    assert got.success.shape == (2, 12)
    for b in range(2):
        _assert_results_equal(
            tdec.SlotDecodeResult(*(a[b] for a in got)),
            jdec.SlotDecodeResult(*(a[b] for a in want)))
    assert np.asarray(want.success).any(-1).all()


def _rows(rs):
    return [(r.message.payload, r.time_sec, r.freq_hz, r.snr_db) for r in rs]


@pytest.mark.parametrize("kw", [{}, dict(bins_per_tone=4, steps_per_symbol=4,
                                         max_candidates=40, min_score=1.0,
                                         use_osd=True, use_mf=True,
                                         coherent=True)],
                         ids=["standard", "deep+coherent"])
def test_decode_ft8_message_complex_matches_jax(kw):
    """Complex (analytic) input to the host API: one pass, the rows JAX
    gives (passes=2 is forced to one pass in both)."""
    wave = _complex_capture(5, -8.0)
    z = wave[:, 0] + 1j * wave[:, 1]
    want = jdec.decode_ft8_message(z, 2000.0, passes=2, **kw)
    got = tdec.decode_ft8_message(z, 2000.0, passes=2, device="cpu", **kw)
    assert _rows(got) == _rows(want)
    assert WANT in {r.message.payload for r in got}
    for a, b in zip(got, want):
        assert abs(a.score - b.score) <= SCORE_ATOL


def test_decode_ft8_message_at_an_odd_rate_matches_jax():
    wave = _real_capture(3, -10.0, 1999.0)
    kw = dict(use_osd=True, mf_first=True, min_score=1.0)
    want = jdec.decode_ft8_message(wave, 1999.0, **kw)
    got = tdec.decode_ft8_message(wave, 1999.0, device="cpu", **kw)
    assert _rows(got) == _rows(want)
    assert WANT in {r.message.payload for r in got}
